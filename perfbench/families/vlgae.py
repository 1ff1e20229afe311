"""The family of ``exp=vlgae``: the joint model with a frozen BERT text item
and region features (``vlgae-bertbase``).

It reaches the frozen copies it was measured with (``core/corpus.py``,
``reference/``, ``flops/``) without changing them: the VLParse corpus and a
local BERT directory written from the seed, the plain reference's weights,
inputs and first steps, the model's operation count, and the bounds of K1
(``dmv_fused``), K5 (``match_maxes``) and K6 (``match_maxes_bwd``).
"""

from __future__ import annotations

import os

import numpy as np

from ..core import corpus
from ..core.record import Kernel
from ..flops import bounds as b
from ..flops import model as count
from ..reference import inputs, model, train

param_shapes = model.param_shapes
first_steps = train.first_steps
TABLES = ("embedding", "root_emb", "dec_emb")


def weight_rule(name: str, shape: tuple):
    """How ``make_weights`` fills a leaf: biases, ``*_bias`` leaves and
    mixing weights 0; norm scales 1; BERT leaves N(0, 0.02); the static
    embedding tables N(0, 1); other matrices N(0, 1/fan_in)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.endswith("_bias") or leaf == "weights":
        return "zero", 0.0
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return "one", 1.0
    if ".bert." in f".{name}":
        return "normal", 0.02
    if leaf in TABLES:
        return "normal", 1.0
    fan_in = shape[-1] if len(shape) == 2 else shape[0]
    return "normal", fan_in ** -0.5


def write_inputs(c: dict, traffic: dict, seed: int, workdir: str) -> None:
    """The corpus under ``workdir/vlparse`` and the BERT directory under
    ``workdir/bert``."""
    root = os.path.join(workdir, "vlparse")
    corpus.make_corpus(root, seed, traffic["images"], traffic["length"],
                       int(c["max_len_train"]), c["vision"])
    corpus.write_bert_dir(os.path.join(workdir, "bert"), corpus.corpus_words(root), c["bert"])


def overrides(c: dict, workdir: str) -> list:
    root = os.path.join(workdir, "vlparse")
    return [c["recipe"], f"root={workdir}",
            f"datamodule.train_path={root}/train",
            f"datamodule.train_init_path={root}/init",
            f"datamodule.dev_path={root}/val",
            f"datamodule.test_path={root}/test",
            f"datamodule.sg_path={root}/vlparse.json",
            f"embedding.transformer.args.model={os.path.join(workdir, 'bert')}",
            *c["overrides"]]


def reference_inputs(c: dict, workdir: str, split: str):
    return inputs.Corpus(os.path.join(workdir, "vlparse"), os.path.join(workdir, "bert"),
                         split, c["vision"])


def step_sizes(x: dict, real: int) -> dict:
    """The real sizes the model count reads."""
    return {"seq_len": [int(v) for v in x["seq_len"][:real]],
            "subword_len": [int(v) for v in np.asarray(x["subword_mask"])[:real].sum(1)],
            "boxes": [int(v) for v in np.asarray(x["vis_box_mask"])[:real].sum(1)]}


def widths(c: dict, n_tag: int) -> dict:
    return dict(c["widths"], bert=c["bert"], n_token=n_tag)


def step_ops(w: dict, steps: list, launches: dict, train: bool) -> list:
    """Each step's operations, with the K5 live rows and K6 winning cells of
    its launch (one of each a step)."""
    return [count.step_ops(w, dict(rec, k5_live=launches["k5"][i:i + 1],
                                   k6_cells=launches["k6"][i:i + 1], D=w["match_hidden"]),
                           train)
            for i, rec in enumerate(steps)]


def _k5_bound(kept):
    vb, tb, D = kept
    A, V = vb.shape
    B, Q = tb.shape
    n_v, n_q = int((vb == 0).sum()), int((tb == 0).sum())
    return b.k5_bound(A, V, B, Q, D, n_v, n_q), (n_v, n_q, int(D))


def _k6_bound(kept):
    li, lvi, D = kept
    B, A, Q = li.shape
    cells = b.k6_cells(li, lvi)
    return b.k6_bound(A, lvi.shape[2], B, Q, D, cells), cells


KERNELS = [
    Kernel("k1", "vlgae_tpu_torch.ops.dmv_cuda", "dmv_fused",
           lambda dec, attach, lengths, kind="log": (dec.shape[1], lengths.detach()),
           lambda kept: (b.dmv_bound(kept[1].cpu().tolist(), int(kept[0]), "fused"), None)),
    Kernel("k5", "vlgae_tpu_torch.ops.match", "match_maxes",
           lambda vis, txt, vis_bias, txt_bias: (vis_bias.detach(), txt_bias.detach(),
                                                 vis.shape[2]),
           _k5_bound),
    Kernel("k6", "vlgae_tpu_torch.ops.match", "match_maxes_bwd",
           lambda vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v: (
               logit_idx.detach(), logit_v_idx.detach(), vis.shape[2]),
           _k6_bound),
]
