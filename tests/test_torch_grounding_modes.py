"""The joint model's other grounding strategies, the port against vlgae_tpu.

Three configurations of ``exp=vlgae`` at narrow widths on a tiny synthetic
corpus, the JAX model's params carried into the port through
``vlgae_tpu_torch.convert``, every dropout 0:

* ``word``: the words alone as language factors (no tree, so the NLL takes
  a DP of its own: the K3 pair in training, K2 at eval);
* ``word+alldep``: words and every (head, dep) pair weighted by its
  marginal in training (Q = N + N^2), the Viterbi-tree factors at eval;
* ``cap_img``: ``gather_logit_mode=reduced`` (the full map, then caption
  logits), ``loss_grounding_mode=cap_img|ce`` (0 at eval) and
  ``decode_grounding_mode=on_img`` with ``metric=attachment_cap_img``.

Held to: the training forward's language factors, matching logits and
reused DP tables within rtol 1e-5 / atol 1e-6 at ``precision=32`` (for
the language factors and the matching logits made from them the atol is
scaled by the tensor's largest magnitude: the arc factors reach 5, a
cancelling bilinear sum near 0 differs by 1.4e-6 between the two GEMM
orders, and its products carry that on); one joint
train step (loss, every gradient, the updated params) with the tolerances of
tests/test_torch_train.py at f32 and at bf16 (the JAX model on its Pallas
matching kernel in interpret mode where the mode reaches it); the eval
step's arcs, images and loss, and the dev prediction file byte-identical at
precision=32; the caption-matching accuracy; and the config pairings that
the JAX package rejects.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_data
from test_torch_train import (_batch, _check_step, _jax_pipeline, _port_pipeline,
                              overrides)

MODES = {
    "word": ["model.language_factor_mode=word"],
    "word+alldep": ["model.language_factor_mode=word+alldep"],
    "cap_img": ["model.gather_logit_mode=reduced", "model.loss_grounding_mode=cap_img|ce",
                "model.decode_grounding_mode=on_img", "model/metric=attachment_cap_img"],
}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16,
                           n_box=6, len_range=(3, 9))
    return root


@pytest.fixture(scope="module", params=list(MODES))
def mode(request, corpus):
    """(name, overrides, JAX pipeline, flat params) at precision=32."""
    ovs = overrides(corpus) + MODES[request.param]
    jpipe, flat = _jax_pipeline(corpus, ovs)
    return request.param, ovs, jpipe, flat


def test_config_pairings_raise_like_jax():
    from vlgae_tpu.models.joint import DependencyBoxRelConfig as JCfg

    from vlgae_tpu_torch.models.joint import DependencyBoxRelConfig as TCfg

    for kw, match in (({"gather_logit_mode": "reduced"}, "on_img"),
                      ({"loss_grounding_mode": "cap_img|ce"}, "cap_img"),
                      ({"language_factor_mode": "word+arcs"}, "language_factor_mode"),
                      ({"visual_factor_mode": "prune"}, "visual_factor_mode")):
        for cls in (JCfg, TCfg):
            with pytest.raises(ValueError, match=match):
                cls(**kw)
    TCfg(gather_logit_mode="reduced", loss_grounding_mode="cap_img|ce",
         decode_grounding_mode="on_img", language_factor_mode="word+alldep")


def _close(got, want, what, scaled=False):
    """rtol 1e-5 / atol 1e-6; ``scaled``: the atol times the largest
    magnitude below the masks' 1e8, where that exceeds 1."""
    want = np.asarray(want, np.float64)
    scale = 1.0
    if scaled:
        scale = max(1.0, float(np.abs(np.where(np.abs(want) < 1e8, want, 0)).max(initial=0)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def test_training_forward_matches_jax(mode, corpus):
    """The train-mode forward on one batch: the language factors (features,
    mask, marginals), the matching logits and the reused DP tables."""
    name, ovs, jpipe, flat = mode
    tpipe = _port_pipeline(corpus, ovs, flat)
    x, _ = _batch(jpipe.dm, "train", False)
    jout = jpipe.model.apply(jpipe.state.params, {k: jnp.asarray(v) for k, v in x.items()},
                             deterministic=False,
                             rngs={"dropout": jax.random.key(0), "sample": jax.random.key(0)})
    tpipe.model.train()
    with torch.no_grad():
        tout = tpipe.model({k: torch.as_tensor(v) for k, v in x.items()})
    for i, what in enumerate(("txt", "txt_mask", "txt_marginal")):
        _close(tout["txt_packed"][i].numpy(), jout["txt_packed"][i], what, what == "txt")
    N = x["word"].shape[1] + 1
    Q = {"word": N, "word+alldep": N + N * N, "cap_img": 2 * N}[name]
    assert tout["txt_packed"][0].shape[1] == Q
    _close(tout["match_logit"].numpy(), jout["match_logit"], "match_logit", True)
    if name == "cap_img":
        assert tout["match_logit"].dim() == 2 and "match_reduced" not in tout
    else:
        _close(tout["match_reduced"][1].numpy(), jout["match_reduced"][1], "logit_v", True)
    want_reuse = jout.get("dep_reuse") or {}
    assert sorted(tout.get("dep_reuse") or {}) == sorted(want_reuse)
    assert sorted(want_reuse) == {"word": [], "word+alldep": ["log"],
                                  "cap_img": ["log", "max"]}[name]
    for kind, tables in want_reuse.items():
        for i, t in enumerate(tables):
            _close(tout["dep_reuse"][kind][i].numpy(), t, f"dep_reuse {kind} {i}")


def test_one_joint_step_matches_jax(mode, corpus):
    name, ovs, jpipe, flat = mode
    grads = _check_step(jpipe, flat, corpus, ovs, False, 1e-5, (1e-5, 1e-4), 2e-6)
    # the grounding loss reached the matching features (and the arc encoder)
    assert np.abs(grads["vis_mlp_pre_matching/kernel"]).max() > 0
    if name == "word":
        assert not any(k.startswith(("arc_encoder", "child_encoder")) for k in grads)
    else:
        assert np.abs(grads["arc_encoder_w1"]).max() > 0


@pytest.mark.parametrize("name", list(MODES))
def test_one_joint_step_matches_jax_bf16(name, corpus):
    """precision=bf16: the port's MatchMaxesFn (plain K5/K6 versions on the
    CPU) against the JAX model on its Pallas kernel (interpret mode) for
    the factor CE; the bf16 einsum with f32 accumulation of the full map
    for the caption-image path."""
    ovs = overrides(corpus, precision="bf16") + MODES[name]
    jpipe, flat = _jax_pipeline(corpus, ovs, match_kernel="pallas")
    _check_step(jpipe, flat, corpus, ovs, False, 1e-3, (1e-3, 2e-2), 1e-4)


def test_eval_and_dev_predictions_match_jax(mode, corpus, tmp_path):
    """``evaluate('dev')``: the metrics (caption accuracy for the
    caption-image path) and ``val/loss``, each eval step's arcs and images,
    and the dev prediction file, byte-identical (``X`` in the ALIGN column
    under ``on_img``)."""
    name, ovs, jpipe, flat = mode
    tpipe = _port_pipeline(corpus, ovs, flat)
    for x, y in jpipe.dm.batches("dev", shuffle=False):
        from vlgae_tpu.parallel import pad_batch_to_devices

        xp = pad_batch_to_devices(x, 1, pow2=True)[0]
        yp = pad_batch_to_devices(y, 1, pow2=True)[0]
        fn = jpipe._get_eval_step(tuple((k, v.shape) for k, v in sorted(xp.items())))
        want = jax.device_get(fn(jpipe.state.params,
                                 {k: jnp.asarray(v) for k, v in xp.items()},
                                 {k: jnp.asarray(v) for k, v in yp.items()},
                                 jnp.asarray(0.5, jnp.float32)))
        got = tpipe.eval_step(xp)
        assert sorted(got) == sorted(want)
        for key in set(got) - {"loss"}:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, atol=1e-4)
    jres, jout = jpipe.evaluate("dev")
    tres, tout = tpipe.evaluate("dev")
    assert sorted(tres) == sorted(jres)
    for k, v in jres.items():
        np.testing.assert_allclose(tres[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
    jpipe.write_predictions(str(tmp_path / "jax.conll"), "dev", jout)
    tpipe.write_predictions(str(tmp_path / "port.conll"), "dev", tout)
    want = (tmp_path / "jax.conll").read_bytes()
    assert want.count(b"\n\n") == len(jpipe.dm.datasets["dev"])
    assert (tmp_path / "port.conll").read_bytes() == want
    if name == "cap_img":
        assert "caption/acc" in tres
        assert all(row.endswith(b"\tX\tX") for row in want.split(b"\n") if row)
