"""Models: embeddings, encoders, the DMV family, the joint VLGAE model."""

from . import dmv_model
from .dmv_init import generate_rule_1o, good_init, km_init, recovery_valences
from .embedding import CompositeEmbedding, EmbeddingItemCfg, load_glove
from .joint import ATTR_POS, OBJ_POS, REL_POS, DependencyBoxRel, DependencyBoxRelConfig
from .ldndmv import (FUNCTION_POS, DiscriminativeNDMV, LDNDMVConfig, loss_init_pretrained,
                     loss_init_rules, loss_nll)
from .ldndmv import decode as ldndmv_decode
from .text_encoder import MLPEncoder, RNNEncoder
from .vis_encoder import (VisBoxRelSimpleEncoder, VisViTPatchEncoder, graft_vit_params,
                          load_vit_params, patch_boxes)

__all__ = [
    "ATTR_POS",
    "CompositeEmbedding",
    "DependencyBoxRel",
    "DependencyBoxRelConfig",
    "DiscriminativeNDMV",
    "EmbeddingItemCfg",
    "FUNCTION_POS",
    "LDNDMVConfig",
    "MLPEncoder",
    "OBJ_POS",
    "REL_POS",
    "RNNEncoder",
    "VisBoxRelSimpleEncoder",
    "VisViTPatchEncoder",
    "dmv_model",
    "generate_rule_1o",
    "good_init",
    "graft_vit_params",
    "km_init",
    "ldndmv_decode",
    "load_glove",
    "load_vit_params",
    "loss_init_pretrained",
    "loss_init_rules",
    "loss_nll",
    "patch_boxes",
    "recovery_valences",
]
