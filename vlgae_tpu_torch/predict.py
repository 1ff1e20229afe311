"""Prediction-dumping CLI of the port (counterpart of ``test.py``).

    python -m vlgae_tpu_torch.predict [overrides...] \\
        (checkpoint=<port .pt> | weights=<jax params .npz> | init_seed=<int>) \\
        [device=cuda|cpu]

Composes ``configs/config_train`` with the run's saved ``overrides.json``
(next to the checkpoint's directory, as ``test.py`` does) and the given
overrides, restores or draws the weights, evaluates train/dev/test,
prints one JSON result line per split and writes ``{name}_{split}.conll``
in the working directory. ``device`` defaults to ``cuda`` and raises when
no CUDA device is present. Under ``python -m torch.distributed.run
--nproc_per_node=N -m vlgae_tpu_torch.predict ...`` each rank evaluates
its rows of every batch and rank 0 prints and writes. On the card, TF32 is switched off for matmuls
and cuDNN, so f32 products stay f32.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from .data import (DepDataModule, HashSubwordTokenizer, VLParseDataModule,
                   WordPieceTokenizer, attach_subwords)
from .training.factory import build_model
from .training.pipeline import Pipeline, init_params
from .utils.config import ConfigComposer, resolve

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def setup_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=cuda but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def compose(overrides) -> dict:
    """``configs/config_train`` (or ``$VLGAE_CONFIG_DIR``) with overrides."""
    return resolve(ConfigComposer(os.environ.get("VLGAE_CONFIG_DIR", CONFIG_DIR))
                   .compose("config_train", list(overrides)))


def build_datamodule(cfg) -> DepDataModule:
    """The set-up datamodule of ``cfg``: ``VLParseDataModule`` when its
    ``_target_`` names VLParse, else ``DepDataModule`` (a plain CoNLL
    corpus); with the subword cache when the embedding uses subwords, from
    the local BERT directory's WordPiece vocabulary when
    ``transformer.args.model`` is one, else hashed."""
    dm_cfg = dict(cfg["datamodule"])
    target = dm_cfg.pop("_target_", "VLParseDataModule")
    if "VLParse" in target:
        # a recipe without a visual encoder reads and batches no region feature
        dm = VLParseDataModule(load_vis=bool(cfg.get("vis_encoder")), **dm_cfg).setup()
    else:
        dm = DepDataModule(**dm_cfg).setup()
    emb = cfg.get("embedding", {})
    if emb.get("use_subword"):
        model_path = str(((emb.get("transformer") or {}).get("args") or {}).get("model", ""))
        attach_subwords(dm, WordPieceTokenizer(model_path) if os.path.isdir(model_path)
                        else HashSubwordTokenizer())
    return dm


def build_pipeline(overrides, device="cuda", checkpoint=None, weights=None,
                   init_seed=None):
    """Compose the config, build data + model, load or draw the weights."""
    if sum(x is not None for x in (checkpoint, weights, init_seed)) != 1:
        raise ValueError("pass exactly one of checkpoint=, weights=, init_seed=")
    device = setup_device(device)
    saved = []
    ckpt = checkpoint or weights
    if ckpt:
        run_dir = os.path.dirname(os.path.dirname(os.path.abspath(ckpt)))
        path = os.path.join(run_dir, "overrides.json")
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
    cfg = compose(saved + list(overrides))
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    if init_seed is not None:
        init_params(model, int(init_seed))
    pipe = Pipeline(model, dm, cfg, device=device)
    if ckpt:
        pipe.load_weights(ckpt)
    return pipe


def main(argv=None):
    opts = {"checkpoint": None, "weights": None, "init_seed": None,
            "device": "cuda"}
    rest = []
    for ov in (sys.argv[1:] if argv is None else argv):
        key, sep, value = ov.partition("=")
        if sep and key in opts:
            opts[key] = value
        else:
            rest.append(ov)
    device = opts.pop("device")
    pipe = build_pipeline(rest, device=device, **opts)
    name = pipe.cfg.get("name", "model")
    results = {}
    for split in ("train", "dev", "test"):
        if split not in pipe.dm.datasets:
            continue
        result, outputs = pipe.evaluate(split)
        results[split] = result
        if pipe.world.rank == 0:
            print(json.dumps({f"{split}/{k}": v for k, v in result.items()}),
                  flush=True)
            pipe.write_predictions(f"{name}_{split}.conll", split, outputs)
    return pipe, results


if __name__ == "__main__":
    from .parallel.mesh import shutdown

    try:
        main()
    finally:
        shutdown()
