"""The port's training step and loop against vlgae_tpu on one corpus.

A tiny synthetic corpus (tests/synth_data.py) and the ``exp=vlgae`` recipe
at narrow widths; the JAX model's params are carried into the port through
``vlgae_tpu_torch.convert``. Every dropout is 0 (overrides) so the two
packages compute the same function. Tolerances (f32, different summation
orders and Adam's rounding): losses 1e-5 relative, gradients 1e-5 + 1e-4
relative, updated parameters 2e-6 absolute (Adam's first steps move every
parameter by about lr = 1e-3); at ``precision=bf16`` the matching runs in
bf16 in both (the JAX model cloned onto its Pallas kernel in interpret
mode), and the tolerances are those of bf16 operands (1e-2 relative).
"""

import dataclasses
import os
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
NO_DROPOUT = ["encoder.dropout=0", "model.word_encoder.dropout=0",
              "model.dep_model_cfg.head_ff.dropout=0",
              "model.dep_model_cfg.mid_ff.dropout=0"]


def overrides(root, precision="32", dropout=False):
    return [
        "exp=vlgae", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.pad_boxes=6", "datamodule.sample_boxes=0",
        "datamodule.train_dataloader.batch_size=8",
        "datamodule.train_dataloader.num_bucket=1",
        "_hidden_size=32", "_match_hidden_size=16", "_rank=4",
        "vis_encoder.n_in=16", "vis_encoder.n_hidden=32",
        f"trainer.precision={precision}", "model.init_epoch=1",
    ] + ([] if dropout else NO_DROPOUT)


def _jax_pipeline(root, ovs, match_kernel=None):
    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HashSubwordTokenizer, attach_subwords
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve

    cfg = resolve(ConfigComposer(str(REPO / "configs")).compose("config_train", ovs))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    dm = VLParseDataModule(**dm_cfg).setup()
    attach_subwords(dm, HashSubwordTokenizer())
    model = build_model(cfg, dm)
    if match_kernel:
        model = model.clone(cfg=dataclasses.replace(model.cfg, match_kernel=match_kernel))
    # one device: the port runs on one card, and the 8 virtual CPU devices
    # of tests/conftest.py would partition every step of the reference
    pipe = Pipeline(model, dm, cfg, workdir=str(root), devices=jax.devices()[:1])
    pipe.init_state(next(dm.batches("train", shuffle=False)), seed=0)
    flat = traverse_util.flatten_dict(jax.device_get(pipe.state.params))
    rng = np.random.default_rng(0)
    for k in flat:  # a random arc encoder, so the arc factors take part
        if k[-1].startswith("arc_encoder"):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
    pipe.state.params = traverse_util.unflatten_dict(flat)
    pipe.state.opt_state = pipe.tx.init(pipe.state.params)
    return pipe, {"/".join(k): np.asarray(v) for k, v in flat.items()}


def _port_pipeline(root, ovs, flat, seed=0):
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline

    cfg = compose(ovs)
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    model.load_state_dict(convert.flax_to_torch(flat, model), strict=True)
    pipe = Pipeline(model, dm, cfg, device="cpu", workdir=str(root), seed=seed)
    pipe.setup_optimizer()
    return pipe


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16,
                           n_box=6, len_range=(3, 9))
    return root


@pytest.fixture(scope="module")
def pair(corpus):
    jpipe, flat = _jax_pipeline(corpus, overrides(corpus))
    return jpipe, flat


def _batch(dm, split, rules):
    from vlgae_tpu.parallel import pad_batch_to_devices

    dm.include_init_rules = rules
    x, y = next(dm.batches(split, shuffle=False))
    return (pad_batch_to_devices(x, 1, pow2=True)[0],
            pad_batch_to_devices(y, 1, pow2=True)[0])


def _jax_step(jpipe, x, y, init_phase):
    """(loss, aux, grads, new params) of one JAX train step."""
    inputs = {k: jnp.asarray(v) for k, v in x.items()}
    gold = {k: jnp.asarray(v) for k, v in y.items()}
    key = tuple((k, v.shape) for k, v in sorted(x.items()))
    alpha = jnp.asarray(0.5, jnp.float32)
    rng = jax.random.key(1)
    # host copies: the train step donates its params and optimizer state
    params, opt_state = jax.device_get((jpipe.state.params, jpipe.state.opt_state))
    (loss, aux), grads = jpipe._get_grad_step(key, init_phase)(
        params, inputs, gold, rng, alpha)
    new, _, _, _ = jpipe._get_train_step(key, init_phase)(
        params, opt_state, inputs, gold, rng, alpha)
    flat = lambda t: {"/".join(k[1:]): np.asarray(v)  # noqa: E731
                      for k, v in traverse_util.flatten_dict(jax.device_get(t)).items()}
    return float(loss), {k: float(v) for k, v in aux.items()}, flat(grads), flat(new)


def _check_step(jpipe, flat, corpus, ovs, init_phase, rtol_loss, grad_tol, param_atol):
    tpipe = _port_pipeline(corpus, ovs, flat)
    split = "train_init" if init_phase else "train"
    x, y = _batch(jpipe.dm, split, init_phase)
    want_loss, want_aux, want_grads, want_params = _jax_step(jpipe, x, y, init_phase)
    tpipe.dm.include_init_rules = init_phase
    tx, ty = next(tpipe.dm.batches(split, shuffle=False))
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2
    tx, ty = pad_batch_pow2(tx)[0], pad_batch_pow2(ty)[0]
    for k in x:
        np.testing.assert_array_equal(tx[k], x[k], err_msg=k)
    loss, aux = tpipe.grad_step(tx, ty, init_phase, 0.5)
    np.testing.assert_allclose(float(loss), want_loss, rtol=rtol_loss)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=rtol_loss, err_msg=k)
    grads = convert.torch_to_flax({
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in tpipe.model.named_parameters()})
    assert sorted(grads) == sorted(want_grads)
    atol, rtol = grad_tol
    for k, g in grads.items():
        np.testing.assert_allclose(g, want_grads[k], atol=atol, rtol=rtol, err_msg=k)
    tpipe.apply_step()
    # Adam's first update is about lr * sign(g): where the gradient is at
    # round-off level (e.g. biases a softmax cancels) its sign is noise, so
    # there the update is only held to |step| <= lr
    before = convert.torch_to_flax(convert.flax_to_torch(flat, tpipe.model))
    params = convert.torch_to_flax(tpipe.model.state_dict())
    for k, p in params.items():
        sure = np.abs(want_grads.get(k, np.ones_like(p))) > 1e-4
        np.testing.assert_allclose(p[sure], want_params[k][sure], atol=param_atol,
                                   rtol=0, err_msg=k)
        assert np.all(np.abs(p - before[k]) <= 1.001e-3), k
    return grads


def test_one_init_step_matches_jax(pair, corpus):
    jpipe, flat = pair
    _check_step(jpipe, flat, corpus, overrides(corpus), True, 1e-5, (1e-5, 1e-4), 2e-6)


def test_one_joint_step_matches_jax(pair, corpus):
    jpipe, flat = pair
    grads = _check_step(jpipe, flat, corpus, overrides(corpus), False, 1e-5,
                        (1e-5, 1e-4), 2e-6)
    # the grounding loss reached the matching features and the arc encoder
    assert np.abs(grads["vis_mlp_pre_matching/kernel"]).max() > 0
    assert np.abs(grads["arc_encoder_w1"]).max() > 0


def test_one_joint_step_matches_jax_bf16(corpus):
    """precision=bf16: the port's MatchMaxesFn (plain K5/K6 versions on the
    CPU) against the JAX model on its Pallas kernel (interpret mode)."""
    ovs = overrides(corpus, precision="bf16")
    jpipe, flat = _jax_pipeline(corpus, ovs, match_kernel="pallas")
    _check_step(jpipe, flat, corpus, ovs, False, 1e-3, (1e-3, 2e-2), 1e-4)


def test_grounding_loss_gradient_matches_jax(pair):
    """d(grounding loss)/d(text and visual features). Each term of the
    factor CE is divided by a DETACHED copy of itself; without the detach
    the forward value is the same but the gradient shrinks to ~1e-6/x."""
    jpipe, flat = pair
    model, params = jpipe.model, jpipe.state.params
    from vlgae_tpu_torch.models.joint import DependencyBoxRel

    rng = np.random.default_rng(3)
    B, P, L, H = 4, 3, 5, 16
    V = P + P * P + P + 1
    Q = 2 * (L + 1)
    vis = rng.standard_normal((B, V, H)).astype(np.float32)
    txt = rng.standard_normal((B, Q, H)).astype(np.float32)
    box_mask = np.ones((B, P), bool)
    box_mask[1, 2] = False
    seq_len = np.array([5, 3, 4, 0], np.int32)
    qm = np.arange(L)[None] < seq_len[:, None]
    q_mask = np.concatenate([np.zeros((B, 1), bool), qm], 1)
    txt_mask = np.concatenate([q_mask, q_mask], 1)
    marg = np.concatenate([q_mask, q_mask * rng.random((B, L + 1))], 1).astype(np.float32)
    rel = (box_mask[:, None] & box_mask[:, :, None])
    vis_mask = np.concatenate([box_mask, np.triu(rel, 1).reshape(B, -1), box_mask,
                               np.ones((B, 1), bool)], 1)
    tag = rng.integers(0, 8, (B, L)).astype(np.int32)
    inputs = {"tag": tag, "seq_len": seq_len, "vis_available": np.ones(B, bool)}
    split = (P, P * P, P, 1)

    def jloss(vf, tf):
        vp, tp = (vf, jnp.asarray(vis_mask), split), (tf, jnp.asarray(txt_mask), jnp.asarray(marg))
        out = {"vis_packed": vp, "txt_packed": tp}
        out["match_reduced"] = model.apply(params, vp, tp, method=model.gather_logit_train)
        out["match_logit"] = out["match_reduced"][0]
        return model.apply(params, out, {k: jnp.asarray(v) for k, v in inputs.items()},
                           method=model.loss_grounding_factor_ce)[0]

    want, (gv, gt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(vis), jnp.asarray(txt))

    tmodel = _port_pipeline(jpipe.workdir, overrides(jpipe.workdir), flat).model
    assert isinstance(tmodel, DependencyBoxRel)
    vf = torch.from_numpy(vis).requires_grad_(True)
    tf = torch.from_numpy(txt).requires_grad_(True)
    vp = (vf, torch.from_numpy(vis_mask), split)
    tp = (tf, torch.from_numpy(txt_mask), torch.from_numpy(marg))
    out = {"vis_packed": vp, "txt_packed": tp}
    out["match_reduced"] = tmodel.gather_logit_train(vp, tp)
    got, _ = tmodel.loss_grounding_factor_ce(
        out, {k: torch.from_numpy(v) for k, v in inputs.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert np.abs(np.asarray(gv)).max() > 1e-2  # a real gradient, not ~1e-6
    np.testing.assert_allclose(vf.grad.numpy(), np.asarray(gv), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gt), rtol=1e-4, atol=1e-6)


def test_two_epoch_trajectory_matches_jax(corpus):
    """1 warm-up + 1 joint epoch through both packages' train_epoch:
    per-step losses and learning rates, and the final parameters."""
    jpipe, flat = _jax_pipeline(corpus, overrides(corpus))
    tpipe = _port_pipeline(corpus, overrides(corpus), flat)
    traj = {"jax": [], "port": []}
    j_get = jpipe._get_train_step

    def j_wrapped(key, init_phase):
        fn = j_get(key, init_phase)

        def step(*a):
            lr = jpipe.current_lr()
            out = fn(*a)
            traj["jax"].append((float(out[2]), lr))
            return out
        return step

    jpipe._get_train_step = j_wrapped
    t_step = tpipe.train_step

    def t_wrapped(*a):
        lr = tpipe.current_lr()
        loss, aux = t_step(*a)
        traj["port"].append((float(loss), lr))
        return loss, aux

    tpipe.train_step = t_wrapped
    for epoch in range(2):
        js = jpipe.train_epoch(epoch)
        ts = tpipe.train_epoch(epoch)
        assert js["train/init_phase"] == ts["train/init_phase"] == (epoch == 0)
    assert len(traj["port"]) == len(traj["jax"]) >= 4
    got, want = np.array(traj["port"]), np.array(traj["jax"])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    assert got[1, 1] < got[0, 1]  # the exponential schedule steps per update
    want_p = {"/".join(k[1:]): np.asarray(v) for k, v in
              traverse_util.flatten_dict(jax.device_get(jpipe.state.params)).items()}
    n = len(traj["jax"])
    for k, p in convert.torch_to_flax(tpipe.model.state_dict()).items():
        if k.endswith("scorer/project2/bias"):
            # the log-softmax over the scored axis cancels this bias: its
            # gradient is 0 up to round-off, whose sign Adam turns into
            # +-lr steps in either package
            assert np.all(np.abs(p - flat["params/" + k]) <= n * 1.001e-3), k
            continue
        np.testing.assert_allclose(p, want_p[k], atol=2e-5, rtol=0, err_msg=k)


def test_checkpoint_resume_is_bit_exact(corpus, tmp_path):
    """2 epochs straight == 1 epoch, checkpoint, a new process state
    (model, data, pipeline rebuilt), resume, 1 epoch: bit for bit, with
    every dropout on."""
    ovs = overrides(corpus, dropout=True)
    _, flat = _jax_pipeline(corpus, ovs)

    a = _port_pipeline(tmp_path / "a", ovs, flat, seed=5)
    a.train_epoch(0)
    a.train_epoch(1)

    b = _port_pipeline(tmp_path / "b", ovs, flat, seed=5)
    b.train_epoch(0)
    path = b.save_checkpoint("last")
    c = _port_pipeline(tmp_path / "c", ovs, flat, seed=99)
    c.load_checkpoint(path, load_training_state=True)
    assert (c.step, c.epoch) == (b.step, 0)
    c.train_epoch(1)
    sa, sc = a.model.state_dict(), c.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    assert a.step == c.step
    assert any(not torch.equal(sa[k], convert.flax_to_torch(flat, a.model)[k])
               for k in sa)


def test_train_cli_writes_checkpoints_and_predictions(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    monkeypatch.chdir(tmp_path)
    pipe, test = train.main(overrides(corpus, dropout=True) + [
        "trainer.max_epochs=2", "device=cpu", "workdir=run", "init_seed=0"])
    run = tmp_path / "run"
    for name in ("checkpoint/best.pt", "checkpoint/last.pt", "test.predict.txt",
                 "dev.predict.txt", "metrics.jsonl", "overrides.json"):
        assert (run / name).exists(), name
    assert np.isfinite(test["loss"])
    state = torch.load(run / "checkpoint" / "last.pt", weights_only=True)
    pipe.model.load_state_dict(state["model"], strict=True)
    assert state["epoch"] == 1 and state["step"] == pipe.step
    n = (run / "test.predict.txt").read_text().count("\n\n")
    assert n == len(pipe.dm.datasets["test"])


# -- dropout formulas, given the same keep mask ------------------------------
# jax.random.bernoulli is replaced by a function returning the test's masks
# in order, and the port module's keep_mask by the same masks: the two
# packages then drop the same units, and must agree to f32 round-off.
DROP_TOL = dict(rtol=1e-6, atol=1e-6)


def _feed_masks(monkeypatch, masks):
    masks = list(masks)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None, mode="low": jnp.asarray(masks.pop(0)))


def _port_masks(module, masks):
    masks = [torch.from_numpy(np.asarray(m, np.float32)) for m in masks]
    module.keep_mask = lambda shape, p, like: masks.pop(0)


def _mask(rng, shape, p):
    return rng.random(shape) >= p


def test_shared_and_independent_dropout_match_jax(monkeypatch):
    from vlgae_tpu.models import nn as jnn
    from vlgae_tpu_torch.models import nn as tnn

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    keep = _mask(rng, (3, 1, 4), 0.33)
    _feed_masks(monkeypatch, [keep])
    want = jnn.shared_dropout(jax.random.key(0), jnp.asarray(x), 0.33, False)
    got = tnn.shared_dropout(torch.from_numpy(x), 0.33, torch.from_numpy(keep).float())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DROP_TOL)

    items = [rng.standard_normal((3, 5, d)).astype(np.float32) for d in (4, 2, 3)]
    keeps = [_mask(rng, (3, 5), 0.5) for _ in items]
    keeps[0][0] = keeps[1][0] = keeps[2][0] = False  # an all-dropped position
    _feed_masks(monkeypatch, keeps)
    want = jnn.independent_dropout(jax.random.key(0), [jnp.asarray(i) for i in items],
                                   0.5, False)
    got = tnn.independent_dropout([torch.from_numpy(i) for i in items], 0.5,
                                  [torch.from_numpy(k).float() for k in keeps])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DROP_TOL)


def _flax_params(module, *args, **kw):
    params = module.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                         *args, **kw)
    return params, {"/".join(k): np.asarray(v) for k, v in
                    traverse_util.flatten_dict(jax.device_get(params["params"])).items()}


@pytest.mark.parametrize("which", ["mlp", "mlp_2d", "scalar_mix", "skip_connect",
                                   "mlp_encoder"])
def test_module_dropout_matches_jax(which, monkeypatch):
    from vlgae_tpu.models import nn as jnn
    from vlgae_tpu.models.text_encoder import MLPEncoder as JMLPEncoder
    from vlgae_tpu_torch.models import nn as tnn
    from vlgae_tpu_torch.models.text_encoder import MLPEncoder

    rng = np.random.default_rng(1)
    p = 0.33
    if which in ("mlp", "mlp_2d"):
        x = rng.standard_normal((4, 6, 5) if which == "mlp" else (7, 5)).astype(np.float32)
        jm, tm = jnn.MLP(8, p), tnn.MLP(5, 8, dropout=p)
        masks = [_mask(rng, (x.shape[0], 1) + ((8,) if x.ndim == 3 else ()), p)]
        args = (jnp.asarray(x),)
        targs = (torch.from_numpy(x),)
    elif which == "scalar_mix":
        layers = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(3)]
        jm, tm = jnn.ScalarMix(3, p), tnn.ScalarMix(3, p)
        masks = [np.array([True, False, True])]
        args = ([jnp.asarray(t) for t in layers],)
        targs = ([torch.from_numpy(t) for t in layers],)
    elif which == "skip_connect":
        x = rng.standard_normal((2, 3, 6)).astype(np.float32)
        jm = jnn.DMVSkipConnectEncoder(6, 0, 0, 0.3)
        tm = tnn.DMVSkipConnectEncoder(6, 0, 0, 0.3)
        masks = [_mask(rng, (2, 3, 2, 2, 6), 0.3)]
        args, targs = (jnp.asarray(x),), (torch.from_numpy(x),)
    else:
        x = rng.standard_normal((2, 5, 6)).astype(np.float32)
        jm, tm = JMLPEncoder(7, dropout=p), MLPEncoder(6, 7, dropout=p)
        masks = [_mask(rng, (2, 5, 7), p)]
        args = (jnp.asarray(x), jnp.ones((2, 5), bool))
        targs = (torch.from_numpy(x), torch.ones(2, 5, dtype=torch.bool))
    if which == "scalar_mix":
        params = {"params": {"weights": jnp.asarray(rng.standard_normal(3), jnp.float32),
                             "gamma": jnp.asarray([1.5], jnp.float32)}}
        flat = {k: np.asarray(v) for k, v in params["params"].items()}
    else:
        params, flat = _flax_params(jm, *args)
    tm.load_state_dict(convert.flax_to_torch(flat, tm), strict=True)
    _feed_masks(monkeypatch, masks)
    want = jm.apply(params, *args, deterministic=False,
                    rngs={"dropout": jax.random.key(2)})
    _port_masks(tm, masks)
    got = tm.train()(*targs)
    if which == "mlp_encoder":
        want, got = want["x"], got["x"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **DROP_TOL)
    # eval mode: no dropout, no generator needed
    tm.eval()
    tm.keep_mask = None
    tm(*targs)


def test_dropout_in_training_needs_the_generator():
    from vlgae_tpu_torch.models.nn import MLP, set_dropout_generator

    m = MLP(3, 4, dropout=0.5).train()
    with pytest.raises(RuntimeError, match="generator"):
        m(torch.ones(2, 5, 3))
    set_dropout_generator(m, torch.Generator().manual_seed(0))
    a = m(torch.ones(2, 5, 3))
    assert bool((a == 0).any()) and bool((a[:, 0] == a[:, 1]).all())  # shared along dim 1


# -- warm-up rule targets -----------------------------------------------------
def test_rule_targets_match_jax(pair, corpus):
    from vlgae_tpu.models.dmv_init import generate_rule_1o as jrules
    from vlgae_tpu_torch.models.dmv_init import generate_rule_1o

    jpipe, flat = pair
    n = 0
    for inst in jpipe.dm.datasets["train_init"]:
        want, got = jrules(list(inst["arc"])), generate_rule_1o(list(inst["arc"]))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    assert n > 0
    tpipe = _port_pipeline(corpus, overrides(corpus), flat)
    jpipe.dm.include_init_rules = tpipe.dm.include_init_rules = True
    for (_, jy), (_, ty) in zip(jpipe.dm.batches("train_init", shuffle=False),
                                tpipe.dm.batches("train_init", shuffle=False)):
        for k in ("dec_rule", "attach_rule", "root_rule"):
            np.testing.assert_array_equal(ty[k], jy[k], err_msg=k)
    jpipe.dm.include_init_rules = False


# -- the differentiable DP total ----------------------------------------------
@pytest.mark.parametrize("kind", ["log", "max"])
def test_dmv_total_fn_gradient_matches_jax(kind):
    from vlgae_tpu.struct import DMV1o
    from vlgae_tpu.struct import dmv_merge as jmerge
    from vlgae_tpu_torch.struct import DMVTotalFn, dmv_merge

    rng = np.random.default_rng(2)
    B, n = 4, 7
    dec = rng.standard_normal((B, n, 2, 2, 2)).astype(np.float32)
    att = rng.standard_normal((B, n, n, 2)).astype(np.float32)
    root = rng.standard_normal((B, n)).astype(np.float32)
    lengths = np.array([7, 3, 1, 5], np.int32)
    g = rng.standard_normal(B).astype(np.float32)

    def jtotal(d, a, r):
        md, ma = jmerge(d, a, r)
        dist = DMV1o((md, ma), jnp.asarray(lengths))
        return jnp.sum((dist.max if kind == "max" else dist.partition) * g)

    want, wgrads = jax.value_and_grad(jtotal, argnums=(0, 1, 2))(
        jnp.asarray(dec), jnp.asarray(att), jnp.asarray(root))
    tt = [torch.from_numpy(v).requires_grad_(True) for v in (dec, att, root)]
    md, ma = dmv_merge(*tt)
    got = (DMVTotalFn.apply(md, ma, torch.from_numpy(lengths), kind)
           * torch.from_numpy(g)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for t, w in zip(tt, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("counts", [None, [1, 1, 5, 2, 9, 3]])
@pytest.mark.parametrize("method", ["mean", "std", "mean+std"])
def test_embedding_normalisation_matches_jax(counts, method):
    """The recipe re-whitens the tag table before training
    (``normalize_time: begin``): count-weighted when the vocab counts."""
    from vlgae_tpu.models.embedding import normalize_embedding_params
    from vlgae_tpu_torch.models.embedding import normalize_embedding_

    table = np.random.default_rng(4).standard_normal((6, 5)).astype(np.float32)
    want = normalize_embedding_params({"t": {"embedding": jnp.asarray(table)}},
                                      ("t", "embedding"), method, counts=counts)
    got = torch.from_numpy(table.copy())
    normalize_embedding_(got, method, counts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["t"]["embedding"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args", [
    {"_target_": "get_exponential_lr_scheduler", "gamma": "0.75**(1/2000)"},
    {"_target_": "get_linear_schedule_with_warmup", "num_warmup_steps": 4,
     "num_training_steps": "2 epoch"},
    {"_target_": "get_constant_schedule_with_warmup", "num_warmup_steps": "1 epoch"},
    {"_target_": "constant"},
])
def test_schedules_match_optax(args):
    from vlgae_tpu.training.optim import make_schedule as jmake
    from vlgae_tpu_torch.training.optim import make_schedule

    want, got = jmake(dict(args), 1e-3, 7), make_schedule(dict(args), 1e-3, 7)
    for k in range(0, 30):
        np.testing.assert_allclose(got(k), float(want(jnp.asarray(k))), rtol=1e-6,
                                   atol=1e-12, err_msg=str(k))


@pytest.mark.parametrize("command", [0.5, "0.25", "[0@0, 0.5@2, 1@5]"])
def test_grounding_coefficient_schedule_matches_jax(command):
    from vlgae_tpu.utils.fn import coeff_at as jcoeff, parse_coeff_schedule as jparse
    from vlgae_tpu_torch.utils.fn import coeff_at, parse_coeff_schedule

    points = parse_coeff_schedule(command)
    assert points == jparse(command)
    for epoch in range(8):
        assert coeff_at(points, epoch) == jcoeff(points, epoch)


def test_plateau_scale_matches_jax():
    from vlgae_tpu.training.optim import ReduceLROnPlateau as JPlateau
    from vlgae_tpu_torch.training.optim import ReduceLROnPlateau

    watched = [3.0, 2.5, 2.6, 2.7, 2.55, 2.4, 2.41, 2.42, 2.43, 2.44, 2.45]
    j, t = JPlateau(factor=0.5, patience=2, min_lr=1e-4), ReduceLROnPlateau(
        factor=0.5, patience=2, min_lr=1e-4)
    for v in watched:
        assert t.step(v, 1e-3) == j.step(v, 1e-3)
    assert t.scale < 1.0
    t2 = ReduceLROnPlateau(factor=0.5, patience=2, min_lr=1e-4)
    t2.load_state_dict(t.state_dict())
    assert (t2.best, t2.bad, t2.scale) == (j.best, j.bad, j.scale)
