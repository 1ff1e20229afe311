"""Dump a vlgae_tpu checkpoint's params to the ``.npz`` that the PyTorch
port reads (``python -m vlgae_tpu_torch.predict weights=<npz>``).

    python scripts/export_jax_params.py checkpoint=outputs/<run>/checkpoint/best \\
        out=params.npz [overrides...]

Like ``test.py``, it composes the run's saved ``overrides.json`` with the
given overrides, builds the model and restores the params with
``Pipeline.load_checkpoint``; it then writes every param under its
``/``-joined flax path (``params/...``). Any recipe the JAX package builds
works (``exp=vlgae``, ``exp=lang_only``). Runs under JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat_params(params) -> dict:
    """Flax param tree -> {``/``-joined path: numpy array}."""
    import jax
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jax.device_get(params))
    return {"/".join(k): np.asarray(v) for k, v in flat.items()}


def main(argv=None):
    sys.path.insert(0, REPO)
    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HashSubwordTokenizer, attach_subwords
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve

    ckpt, out, rest = None, None, []
    for ov in (sys.argv[1:] if argv is None else argv):
        key, _, value = ov.partition("=")
        if key == "checkpoint":
            ckpt = value
        elif key == "out":
            out = value
        else:
            rest.append(ov)
    if not ckpt or not out:
        raise SystemExit("pass checkpoint=<checkpoint dir> out=<file.npz>")
    run_dir = os.path.dirname(os.path.dirname(os.path.abspath(ckpt)))
    saved = []
    if os.path.exists(os.path.join(run_dir, "overrides.json")):
        with open(os.path.join(run_dir, "overrides.json")) as f:
            saved = json.load(f)
    cfg = resolve(ConfigComposer(os.path.join(REPO, "configs")).compose(
        "config_train", saved + rest))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_", None)
    dm = VLParseDataModule(**dm_cfg).setup()
    if cfg.get("embedding", {}).get("use_subword"):
        attach_subwords(dm, HashSubwordTokenizer())
    pipe = Pipeline(build_model(cfg, dm), dm, cfg, workdir=run_dir)
    pipe.init_state(next(dm.batches("test", shuffle=False)))
    pipe.load_checkpoint(ckpt)
    np.savez(out, **flat_params(pipe.state.params))
    return out


if __name__ == "__main__":
    main()
