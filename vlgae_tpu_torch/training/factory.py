"""Model factory (counterpart of vlgae_tpu/training/factory.py): build the
joint model of ``exp=vlgae`` and ``exp=vlgae_vit`` or the stand-alone parser
of ``exp=lang_only`` from a composed config. ``_target_`` strings are matched by class name, as
in the JAX package."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..models.embedding import (BertConfig, CompositeEmbedding, EmbeddingItemCfg,
                                encoder_config_from_dir, glove_row_map, load_glove)
from ..models.joint import (ATTR_POS, OBJ_POS, REL_POS, DependencyBoxRel,
                            DependencyBoxRelConfig)
from ..models.ldndmv import FUNCTION_POS, DiscriminativeNDMV, LDNDMVConfig
from ..models.text_encoder import BlankEncoder, MLPEncoder, RNNEncoder
from ..models.vis_encoder import VisBoxRelSimpleEncoder, VisViTPatchEncoder, ViTConfig


def build_embedding(emb_cfg: Dict[str, Any], dm) -> CompositeEmbedding:
    items = []
    pretrained, row_maps = {}, {}
    if emb_cfg.get("use_word", True):
        wcfg = emb_cfg.get("word_embedding", {}) or {}
        args = wcfg.get("args", {}) or {}
        dim = int(args.get("embedding_dim", 100))
        adaptor = wcfg.get("adaptor_args", {}) or {}
        items.append(EmbeddingItemCfg(
            "word_embedding", "word", "static", n_vocab=len(dm.vocabs["word"]),
            embedding_dim=dim, mode=adaptor.get("mode", "basic"),
            out_dim=int(adaptor.get("out_dim", 0) or 0),
            normalize_method=wcfg.get("normalize_method", "mean+std"),
            normalize_time=wcfg.get("normalize_time", "nowhere")))
        # a GloVe text file starts the table; without one it starts at random
        glove_path = args.get("model_dir_or_name")
        if (isinstance(glove_path, str) and glove_path.endswith(".txt")
                and os.path.exists(glove_path)):
            table, found = load_glove(glove_path, dm.vocabs["word"], dim)
            pretrained["word_embedding"] = table
            row_maps["word_embedding"] = glove_row_map(dm.vocabs["word"], found)
    if emb_cfg.get("use_tag", True) and "tag" in dm.vocabs:
        tcfg = emb_cfg.get("tag_embedding", {}) or {}
        args = tcfg.get("args", {}) or {}
        items.append(EmbeddingItemCfg(
            "tag_embedding", "tag", "static", n_vocab=len(dm.vocabs["tag"]),
            embedding_dim=int(args.get("embedding_dim", 100)),
            normalize_method=tcfg.get("normalize_method", "mean+std"),
            normalize_time=tcfg.get("normalize_time", "nowhere")))
    bert_config = None
    if emb_cfg.get("use_subword", False):
        args = (emb_cfg.get("transformer", {}) or {}).get("args", {}) or {}
        model_name = args.get("model", "bert-base-cased")
        # a local directory gives the encoder and its shape (still random-init);
        # else the fallback BERT
        bert_config = (encoder_config_from_dir(model_name) if os.path.isdir(str(model_name))
                       else BertConfig())
        items.append(EmbeddingItemCfg(
            "transformer", "subword", "transformer",
            embedding_dim=bert_config.hidden_size,
            n_layers=int(args.get("n_layers", 1)),
            n_out=int(args.get("n_out", 0) or 0),
            requires_grad=bool(args.get("requires_grad", False)),
            pooling=str(args.get("pooling", "mean")),
            stride=int(args.get("stride", 256)),
            layer_dropout=float(args.get("dropout", 0.0) or 0.0)))
    return CompositeEmbedding(tuple(items), bert_config,
                              dropout=float(emb_cfg.get("dropout", 0.0) or 0.0),
                              pretrained=pretrained, row_maps=row_maps)


def build_encoder(enc_cfg: Dict[str, Any], n_in: int):
    """``(encoder, width of its output)``."""
    target = str(enc_cfg.get("_target_", ""))
    kw = {k: v for k, v in enc_cfg.items() if not k.startswith("_")}
    if "MLPEncoder" in target:
        n_enc = int(kw.get("n_hidden", 256))
        return MLPEncoder(n_in, n_enc, dropout=float(kw.get("dropout", 0.0)),
                          shared_dropout=float(kw.get("shared_dropout", 0.0) or 0.0)), n_enc
    if "RNNEncoder" in target:
        enc = RNNEncoder(
            n_in, hidden_size=int(kw.get("hidden_size", 200)),
            num_layers=int(kw.get("num_layers", 2)),
            reproject_emb=int(kw.get("reproject_emb", 0) or 0),
            reproject_out=int(kw.get("reproject_out", 0) or 0),
            mix=bool(kw.get("mix", False)),
            pre_shared_dropout=float(kw.get("pre_shared_dropout", 0.0)),
            pre_dropout=float(kw.get("pre_dropout", 0.0)),
            post_shared_dropout=float(kw.get("post_shared_dropout", 0.0)),
            post_dropout=float(kw.get("post_dropout", 0.0)),
            lstm_dropout=float(kw.get("lstm_dropout", 0.33)),
            output_layers=int(kw.get("output_layers", -1)),
            proj_size=int(kw.get("proj_size", 0) or 0),
            init_version=str(kw.get("init_version", "zy")),
            cat_emb=bool(kw.get("cat_emb", False)))
        return enc, enc.n_hidden
    return BlankEncoder(n_in, dropout=float(kw.get("dropout", 0.0))), n_in


def _ldndmv_cfg(mcfg: Dict[str, Any]) -> LDNDMVConfig:
    mid = mcfg.get("mid_ff", {}) or {}
    return LDNDMVConfig(
        context_mode=mcfg.get("context_mode", "mean"),
        strict_pad_context=bool(mcfg.get("strict_pad_context", False)),
        init_method=str(mcfg.get("init_method", "y")),
        init_epoch=int(mcfg.get("init_epoch", 0)),
        viterbi_training=bool(mcfg.get("viterbi_training", True)),
        mbr_decoding=bool(mcfg.get("mbr_decoding", False)),
        extended_valence=bool(mcfg.get("extended_valence", True)),
        function_mask=bool(mcfg.get("function_mask", False)),
        variational_mode=mcfg.get("variational_mode", "none"),
        z_dim=int(mcfg.get("z_dim", 0) or 0),
        hidden_size=int((mcfg.get("head_ff", {}) or {}).get("n_hidden", 256)),
        mid_bottleneck=int(mid.get("n_bottleneck", 0) or 0),
        mid_n_mid=int(mid.get("n_mid", 0) or 0),
        mid_dropout=float(mid.get("dropout", 0.0) or 0.0),
        ff_dropout=float((mcfg.get("head_ff", {}) or {}).get("dropout", 0.33) or 0.0),
        attach_rank=int(mcfg.get("attach_rank", 16)),
        dec_rank=int(mcfg.get("dec_rank", 16)),
        root_rank=int(mcfg.get("root_rank", 16)),
        root_emb_dim=int(mcfg.get("root_emb_dim", 10)),
        dec_emb_dim=int(mcfg.get("dec_emb_dim", 10)),
    )


def build_ldndmv(cfg: Dict[str, Any], dm, mcfg: Dict[str, Any]):
    embedding = build_embedding(cfg.get("embedding", {}), dm)
    encoder, n_enc = build_encoder(cfg.get("encoder", {}), embedding.embed_size)
    dep_cfg = _ldndmv_cfg(mcfg)
    fmask = ()
    if dep_cfg.function_mask and "tag" in dm.vocabs:
        fmask = tuple(dm.vocabs["tag"][t] for t in FUNCTION_POS
                      if t in dm.vocabs["tag"])
    dep = DiscriminativeNDMV(
        dep_cfg, embedding, encoder, n_enc,
        token2word=tuple(dm.token2word) if dm.token2word else None,
        token2tag=tuple(dm.token2tag) if dm.token2tag else None,
        function_mask_ids=fmask)
    return dep, n_enc


def _bf16(cfg: Dict[str, Any]) -> bool:
    prec = str(cfg.get("trainer", {}).get("precision", 32))
    return prec in ("16", "bf16", "bfloat16")


def build_vis_encoder(cfg: Optional[Dict[str, Any]], dtype=None):
    if not cfg:
        raise NotImplementedError("the joint model needs a vis_encoder config")
    target = str(cfg.get("_target_", ""))
    head = dict(n_hidden=int(cfg.get("n_hidden", 256)),
                activate=bool(cfg.get("activate", True)),
                use_attr=bool(cfg.get("use_attr", True)),
                use_img=bool(cfg.get("use_img", False)),
                img_feat=bool(cfg.get("img_feat", True)),
                dtype=dtype, dropout=float(cfg.get("dropout", 0.0)))
    if target.endswith("VisViTPatchEncoder"):
        # exp=vlgae_vit: patch-grid factors from a (by default frozen) ViT
        vit_cfg = ViTConfig(
            hidden_size=int(cfg.get("vit_hidden_size", 192)),
            num_hidden_layers=int(cfg.get("vit_num_layers", 4)),
            num_attention_heads=int(cfg.get("vit_num_heads", 4)),
            intermediate_size=int(cfg.get("vit_intermediate_size", 384)),
            image_size=int(cfg.get("vit_image_size", 224)),
            patch_size=int(cfg.get("vit_patch_size", 32)),
            num_channels=3)
        return VisViTPatchEncoder(vit_config=vit_cfg,
                                  requires_grad=bool(cfg.get("requires_grad", False)),
                                  **head)
    if not target.endswith("VisBoxRelSimpleEncoder"):
        raise NotImplementedError(f"vis_encoder {target!r} is not ported")
    return VisBoxRelSimpleEncoder(n_in=int(cfg.get("n_in", 2048)), **head)


def build_joint(cfg: Dict[str, Any], dm) -> DependencyBoxRel:
    mcfg = cfg.get("model", {})
    dep, n_enc = build_ldndmv(cfg, dm, mcfg.get("dep_model_cfg", {}))
    bf16 = _bf16(cfg)
    vcfg = cfg.get("vis_encoder")
    vis_encoder = build_vis_encoder(vcfg, torch.bfloat16 if bf16 else None)
    sub = lambda k: mcfg.get(k, {}) or {}  # noqa: E731
    interp = mcfg.get("grounding_interpolation", 0.5)
    jcfg = DependencyBoxRelConfig(
        add_rel=bool(mcfg.get("add_rel", True)),
        add_attr=bool(mcfg.get("add_attr", True)),
        add_image=bool(mcfg.get("add_image", True)),
        add_marginal=bool(mcfg.get("add_marginal", True)),
        language_factor_mode=mcfg.get("language_factor_mode", "word+maxdep"),
        visual_factor_mode=mcfg.get("visual_factor_mode", "unprune"),
        match_hidden=int(sub("visual_factor_cfg").get("n_hidden", 128)),
        feat_fuse_mode=mcfg.get("feat_fuse_mode", "attention"),
        fuse_aug_with_matching=bool(sub("feat_fuse_args").get("aug_with_matching", True)),
        gather_logit_mode=mcfg.get("gather_logit_mode", "simple"),
        loss_grounding_mode=mcfg.get("loss_grounding_mode", "factor|ce"),
        loss_use_pos_prior=bool(sub("loss_grounding_args").get("use_pos_prior", True)),
        loss_vis2txt=float(sub("loss_grounding_args").get("vis2txt", 1.0)),
        decode_grounding_mode=mcfg.get("decode_grounding_mode", "on_factor"),
        decode_use_pos_prior=bool(sub("decode_grounding_args").get("use_pos_prior", True)),
        decode_use_heuristic=bool(sub("decode_grounding_args").get("use_heuristic", True)),
        grounding_interpolation=float(interp) if not isinstance(interp, str) else 0.5,
        eval_match_chunk=int(mcfg.get("eval_match_chunk", 128)),
        compact_rel_train=bool(mcfg.get("compact_rel_train", True)),
        word_encoder_dropout=float(sub("word_encoder").get("dropout", 0.33)),
        bf16_matmul=bf16,
        match_kernel=str(mcfg.get("match_kernel", "auto")),
    )
    tag_vocab = dm.vocabs["tag"]
    to_ids = lambda tags: tuple(tag_vocab[t] for t in tags if t in tag_vocab)  # noqa: E731
    n_vis = int(vcfg.get("n_hidden", 256))
    return DependencyBoxRel(
        jcfg, dep.cfg, dep, vis_encoder, n_enc, n_vis,
        pos_for_obj=to_ids(OBJ_POS), pos_for_rel=to_ids(REL_POS),
        pos_for_attr=to_ids(ATTR_POS))


def build_model(cfg: Dict[str, Any], dm):
    target = cfg.get("model", {}).get("_target_", "")
    if "DependencyBoxRel" in target:
        return build_joint(cfg, dm)
    if "DiscriminativeNDMV" in target or target == "":
        return build_ldndmv(cfg, dm, cfg.get("model", {}))[0]
    raise NotImplementedError(f"model {target!r} is not ported")
