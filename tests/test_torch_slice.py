"""The port's whole eval/predict slice against vlgae_tpu on one corpus.

A tiny synthetic corpus (tests/synth_data.py) and the ``exp=vlgae`` recipe
at narrow widths and ``precision=32``; the JAX model's params (random
init, with a random arc encoder so the arc factors take part) are carried
into the port through ``vlgae_tpu_torch.convert``. Held to: arcs, the
top-5 factor indices and the per-token image exactly equal; the matching
logits and ``val/loss`` to 1e-4; the prediction files byte-identical.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import synth_data
from vlgae_tpu_torch import convert

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4


def overrides(root):
    return [
        "exp=vlgae", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.pad_boxes=6", "_hidden_size=32", "_match_hidden_size=16",
        "_rank=4", "vis_encoder.n_in=16", "vis_encoder.n_hidden=32",
        "trainer.precision=32",
    ]


def build_pair(root, extra=()):
    """(JAX pipeline, port pipeline, flat params) on one corpus and one
    set of weights; ``extra`` overrides go to both."""
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16,
                           n_box=6, len_range=(3, 9))
    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HashSubwordTokenizer, attach_subwords
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve

    from vlgae_tpu_torch.predict import build_pipeline

    cfg = resolve(ConfigComposer(str(REPO / "configs")).compose(
        "config_train", overrides(root) + list(extra)))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    dm = VLParseDataModule(**dm_cfg).setup()
    attach_subwords(dm, HashSubwordTokenizer())
    jpipe = Pipeline(build_model(cfg, dm), dm, cfg, workdir=str(root))
    jpipe.init_state(next(dm.batches("test", shuffle=False)), seed=0)
    flat = traverse_util.flatten_dict(jax.device_get(jpipe.state.params))
    rng = np.random.default_rng(0)
    for k in flat:
        if k[-1].startswith("arc_encoder"):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
    jpipe.state.params = traverse_util.unflatten_dict(flat)
    flat = {"/".join(k): np.asarray(v) for k, v in flat.items()}
    weights = os.path.join(root, "weights.npz")
    np.savez(weights, **flat)
    tpipe = build_pipeline(overrides(root) + list(extra), device="cpu", weights=weights)
    return jpipe, tpipe, flat


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    return (root,) + build_pair(root)


def _pad(x):
    from vlgae_tpu.parallel import pad_batch_to_devices

    return pad_batch_to_devices(x, 1, pow2=True)[0]


def test_eval_step_matches_jax(pair):
    _, jpipe, tpipe, _ = pair
    model, params = jpipe.model, jpipe.state.params
    alpha = jnp.asarray(0.5, jnp.float32)
    n = 0
    for x, y in jpipe.dm.batches("dev", shuffle=False):
        xp, yp = _pad(x), _pad(y)
        fn = jpipe._get_eval_step(tuple((k, v.shape) for k, v in sorted(xp.items())))
        want = jax.device_get(fn(params, {k: jnp.asarray(v) for k, v in xp.items()},
                                 {k: jnp.asarray(v) for k, v in yp.items()}, alpha))
        got = tpipe.eval_step(xp)
        for key in ("arc", "txt_to_factor_idx", "txt_to_img", "txt_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
        jout = model.apply(params, {k: jnp.asarray(v) for k, v in xp.items()},
                           deterministic=True)
        with torch.no_grad():
            tout = tpipe.model({k: torch.as_tensor(v) for k, v in xp.items()})
        np.testing.assert_allclose(tout["match_logit"].numpy(),
                                   np.asarray(jout["match_logit"]), rtol=TOL, atol=TOL)
        n += 1
    assert n >= 1


def test_prediction_files_identical(pair, tmp_path, monkeypatch):
    root, jpipe, _, _ = pair
    from vlgae_tpu_torch.predict import main

    jres, jout = jpipe.evaluate("dev")
    jpipe.write_predictions(str(tmp_path / "jax_dev.conll"), "dev", jout)
    monkeypatch.chdir(tmp_path)
    _, results = main(overrides(root) + [
        f"weights={root}/weights.npz", "device=cpu", "name=port"])
    want = (tmp_path / "jax_dev.conll").read_bytes()
    assert want.count(b"\n\n") == len(jpipe.dm.datasets["dev"])
    assert (tmp_path / "port_dev.conll").read_bytes() == want
    for k, v in jres.items():
        np.testing.assert_allclose(results["dev"][k], v, rtol=TOL, atol=TOL,
                                   err_msg=k)
    for split in ("train", "test"):
        assert (tmp_path / f"port_{split}.conll").exists()


def test_convert_round_trip_and_strict_keys(pair):
    _, _, tpipe, flat = pair
    state = convert.flax_to_torch(flat, tpipe.model)
    back = convert.torch_to_flax(state)
    stripped = {k.split("/", 1)[1]: v for k, v in flat.items()}
    assert sorted(back) == sorted(stripped)
    for k, v in stripped.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    missing = dict(flat)
    missing.pop(next(k for k in flat if k.endswith("arc_encoder_b")))
    with pytest.raises(KeyError, match="missing"):
        convert.flax_to_torch(missing, tpipe.model)
    extra = dict(flat, **{"params/unused/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="no counterpart"):
        convert.flax_to_torch(extra, tpipe.model)


def test_export_script_writes_the_npz_predict_reads(pair, tmp_path):
    root, jpipe, tpipe, flat = pair
    sys.path.insert(0, str(REPO / "scripts"))
    import export_jax_params

    jpipe.workdir = str(tmp_path)
    path = jpipe.save_checkpoint("best", params_only=True)
    out = tmp_path / "exported.npz"
    export_jax_params.main(overrides(root) + [f"checkpoint={path}", f"out={out}"])
    with np.load(out) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, vlgae_tpu_torch, vlgae_tpu_torch.predict, vlgae_tpu_torch.train\n"
        "import vlgae_tpu_torch.models, vlgae_tpu_torch.models.dmv_model\n"
        "import vlgae_tpu_torch.struct.alg, vlgae_tpu_torch.struct.deptree\n"
        "roots = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transformers')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots\n"
        "       or m == 'vlgae_tpu' or m.startswith('vlgae_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
