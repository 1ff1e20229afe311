"""MBR decoding in the port (``mbr_decoding: true``) against vlgae_tpu.

``models/ldndmv.py::decode(mbr=True)``: the summed arc marginals (reused
from ``dep_reuse['log']``, or from a DMV pass of its own) through the
Eisner CRF's argmax. On numpy-seeded merged potentials its heads equal
vlgae_tpu's where the MBR tree wins by at least 1e-3 (test_torch_deptree's
``tree_margins``) and form projective trees everywhere; the reuse and
non-reuse paths agree exactly. ``loss_init_pretrained`` to 1e-5. Both
recipes read the switch from their own config path. Then the recipes at the
narrow widths of tests/test_torch_lang_only.py and tests/test_torch_slice.py
at ``precision=32`` with MBR on: eval-step heads equal (and trees), the
loss within 1e-4, and the dev prediction files byte-identical.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_data
import test_torch_lang_only as lang
import test_torch_slice as joint
from test_struct_dmv import merged_batch, random_potentials
from test_torch_deptree import MARGIN, assert_trees, eisner_margins
from vlgae_tpu.models import ldndmv as jldndmv
from vlgae_tpu.struct.distributions import dmv_value_and_grads_fast
from vlgae_tpu_torch.models import ldndmv
from vlgae_tpu_torch.struct import DependencyCRF, dmv_value_and_grads
from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

TOL = 1e-4
LANG_MBR = ["model.mbr_decoding=true"]
JOINT_MBR = ["model.dep_model_cfg.mbr_decoding=true"]


def _scores(seed, lengths=(7, 3, 0, 1, 5, 9, 2, 6)):
    """Merged potentials (numpy-seeded) as JAX and as torch score dicts."""
    rng = np.random.default_rng(seed)
    mdec, mattach, lens = merged_batch(
        [random_potentials(rng, n) if n else random_potentials(rng, 1) for n in lengths])
    lens = jnp.asarray(np.asarray(lengths, np.int32))
    j = {"merged_dec": mdec.astype(jnp.float32), "merged_attach": mattach.astype(jnp.float32)}
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    return j, t, lens, torch.from_numpy(np.array(lens))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("reuse", [False, True])
def test_decode_mbr_matches_jax(seed, reuse):
    j, t, jl, tl = _scores(seed)
    if reuse:
        j["dep_reuse"] = {"log": dmv_value_and_grads_fast(
            j["merged_dec"], j["merged_attach"], jl, "log")}
        t["dep_reuse"] = {"log": dmv_value_and_grads(
            t["merged_dec"], t["merged_attach"], tl, "log")}
    want = np.asarray(jldndmv.decode(j, jl, mbr=True))
    got = ldndmv.decode(t, tl, mbr=True).numpy()
    arc = dmv_value_and_grads(t["merged_dec"], t["merged_attach"], tl, "log")[2].sum(-1)
    won = eisner_margins(arc.numpy(), tl.numpy(), want) >= MARGIN
    assert won.sum() >= len(won) - 1
    np.testing.assert_array_equal(got[won], want[won])
    assert_trees(got, tl.numpy())
    # pad rows and positions past a length: head 0, as JAX's argmax gives
    for h, w, n in zip(got, want, tl.numpy()):
        assert (h[n:] == 0).all() and (w[n:] == 0).all()


def test_decode_mbr_reuses_the_marginals():
    """With ``dep_reuse['log']`` no DMV pass runs, and the heads are those
    of the pass the decode would run itself."""
    _, t, _, tl = _scores(5)
    fresh = ldndmv.decode(t, tl, mbr=True)
    r = dmv_value_and_grads(t["merged_dec"], t["merged_attach"], tl, "log")
    reused = ldndmv.decode(dict(t, dep_reuse={"log": r}), tl, mbr=True)
    assert torch.equal(fresh, reused)
    assert torch.equal(fresh, DependencyCRF(r[2].sum(-1), tl).argmax_heads)


def test_loss_init_pretrained_matches_jax():
    j, t, jl, tl = _scores(6)
    j2, t2, _, _ = _scores(7)
    want, _ = jldndmv.loss_init_pretrained(j, j2, jl)
    got, aux = ldndmv.loss_init_pretrained(t, t2, tl)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    assert aux["enll"] is got


@pytest.mark.parametrize("recipe,flag", [("lang_only", LANG_MBR), ("vlgae", JOINT_MBR)])
def test_both_recipes_read_the_switch_from_their_config_path(tmp_path, recipe, flag):
    from vlgae_tpu_torch.predict import compose
    from vlgae_tpu_torch.training.factory import _ldndmv_cfg

    cfg = compose([f"exp={recipe}", f"root={tmp_path}"] + flag)
    mcfg = cfg["model"] if recipe == "lang_only" else cfg["model"]["dep_model_cfg"]
    assert _ldndmv_cfg(mcfg).mbr_decoding
    base = compose([f"exp={recipe}", f"root={tmp_path}"])
    mcfg = base["model"] if recipe == "lang_only" else base["model"]["dep_model_cfg"]
    assert not _ldndmv_cfg(mcfg).mbr_decoding


def _eval_steps_match(jpipe, tpipe, pad):
    assert jpipe.dep_cfg.mbr_decoding and tpipe.dep_cfg.mbr_decoding
    alpha = jnp.asarray(0.5, jnp.float32)
    n = 0
    for (x, y), (tx, _) in zip(jpipe.dm.batches("dev", shuffle=False),
                               tpipe.dm.batches("dev", shuffle=False)):
        xp, yp = pad(x), pad(y)
        fn = jpipe._get_eval_step(tuple((k, v.shape) for k, v in sorted(xp.items())))
        want = jax.device_get(fn(jpipe.state.params,
                                 {k: jnp.asarray(v) for k, v in xp.items()},
                                 {k: jnp.asarray(v) for k, v in yp.items()}, alpha))
        got = tpipe.eval_step(pad_batch_pow2(tx)[0])
        np.testing.assert_array_equal(got["arc"], np.asarray(want["arc"]))
        assert_trees(got["arc"], pad_batch_pow2(tx)[0]["seq_len"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
        n += 1
    assert n >= 1


def _files_match(jpipe, main_args, tmp_path, monkeypatch):
    from vlgae_tpu_torch.predict import main

    _, jout = jpipe.evaluate("dev")
    jpipe.write_predictions(str(tmp_path / "jax_dev.conll"), "dev", jout)
    monkeypatch.chdir(tmp_path)
    main(main_args + ["device=cpu", "name=port"])
    want = (tmp_path / "jax_dev.conll").read_bytes()
    assert want.count(b"\n\n") == len(jpipe.dm.datasets["dev"])
    assert (tmp_path / "port_dev.conll").read_bytes() == want


@pytest.fixture(scope="module")
def lang_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("lang_only_mbr")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=8, n_box=8,
                           len_range=(3, 9))
    ovs = lang.overrides(root) + LANG_MBR
    jpipe, flat = lang._jax_pipeline(root, ovs)
    np.savez(root / "weights.npz", **flat)
    return root, jpipe, lang._port_pipeline(root, ovs, flat)


@pytest.fixture(scope="module")
def joint_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("vlgae_mbr")
    return (root,) + joint.build_pair(root, JOINT_MBR)


def test_lang_only_eval_step_matches_jax(lang_pair):
    _, jpipe, tpipe = lang_pair
    _eval_steps_match(jpipe, tpipe, lang._pad)


def test_lang_only_prediction_files_identical(lang_pair, tmp_path, monkeypatch):
    root, jpipe, _ = lang_pair
    _files_match(jpipe, lang.overrides(root) + LANG_MBR + [f"weights={root}/weights.npz"],
                 tmp_path, monkeypatch)


def test_vlgae_eval_step_matches_jax(joint_pair):
    _, jpipe, tpipe, _ = joint_pair
    _eval_steps_match(jpipe, tpipe, joint._pad)


def test_vlgae_prediction_files_identical(joint_pair, tmp_path, monkeypatch):
    root, jpipe, _, _ = joint_pair
    _files_match(jpipe, joint.overrides(root) + JOINT_MBR + [f"weights={root}/weights.npz"],
                 tmp_path, monkeypatch)


def test_mbr_decode_differs_from_viterbi_somewhere(joint_pair):
    """The switch changes what is decoded: on the dev set the MBR heads of
    the port differ from its Viterbi heads in at least one sentence."""
    _, _, tpipe, _ = joint_pair
    differ = 0
    for x, _ in tpipe.dm.batches("dev", shuffle=False):
        xp = pad_batch_pow2(x)[0]
        mbr = tpipe.eval_step(xp)["arc"]
        tpipe.dep_cfg = dataclasses.replace(tpipe.dep_cfg, mbr_decoding=False)
        try:
            vit = tpipe.eval_step(xp)["arc"]
        finally:
            tpipe.dep_cfg = dataclasses.replace(tpipe.dep_cfg, mbr_decoding=True)
        differ += int((mbr != vit).any(1).sum())
    assert differ > 0
