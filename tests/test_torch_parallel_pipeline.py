"""The port's data-parallel training and evaluation against one process and
against vlgae_tpu.

``exp=vlgae`` at the narrow widths of ``tests/test_torch_train.py`` on its
synthetic corpus, the JAX model's params carried over; worlds 2 and 4 run
under ``torchrun`` on gloo (``tests/test_torch_parallel_jobs.py``). Held to the
JAX package's own data-parallel tolerances
(``tests/test_parallel_pipeline.py``): one joint step's loss 1e-5 relative
and every gradient 1e-3 relative + 1e-5; the dev evaluation's UAS equal, its
loss 1e-5, arcs, top-5 factors and images equal (the prediction files
byte-identical); one joint epoch's loss 1e-4. Each world's step is held to
one process, to the JAX package on one device and to its Pipeline on a
mesh of as many devices with ``match_kernel=pallas_sharded`` (interpret
mode). Under
bf16 (the plain K5/K6 versions) the image gradient is reduce-scattered in
bf16, so the gradients upstream of it are held to ``2^-7`` relative (2 bf16
ulps) plus ``2^-7`` of the largest entry. FSDP at world 2 (dropout on, the
masks a rank draws are its rows of one process's) shards the large leaves
and the Adam moments, reproduces one process, and its checkpoint, the same
whole state dict as one process's, resumes at world 1 on the same
trajectory; its wandb watcher logs the whole parameters and the summed
gradients. The CLIs under ``torchrun``: rank 0 writes the run and the
prediction files, identical to one process's on the same checkpoint.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_train as tt
from test_torch_parallel import REPO, run_job
from vlgae_tpu_torch import convert

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, EPOCH_RTOL = 1e-5, 1e-3, 1e-5, 1e-4
BF16_RTOL = 2.0 ** -7


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the JAX pipeline (one device) and its params as an .npz."""
    root = tmp_path_factory.mktemp("dp")
    import synth_data

    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9))
    jpipe, flat = tt._jax_pipeline(root, tt.overrides(root))
    weights = str(root / "weights.npz")
    np.savez(weights, **flat)
    return root, jpipe, flat, weights


def _port(root, ovs, weights):
    from vlgae_tpu_torch.predict import build_pipeline

    pipe = build_pipeline(ovs, device="cpu", weights=weights)
    pipe.setup_optimizer()
    return pipe


def _step(pipe):
    """One process: the first training batch's loss and gradients."""
    from vlgae_tpu_torch.parallel.mesh import DataGroup

    x, y = tt_batch(pipe)
    loss, aux = pipe.grad_step(x, y, False, 0.5)
    grads = convert.torch_to_flax({
        n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
        for n, p in pipe.model.named_parameters()})
    pipe.optimizer.zero_grad()
    assert pipe.dp == DataGroup(0, 1, None, torch.device("cpu"))
    return {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}, grads


def tt_batch(pipe):
    import test_torch_parallel_jobs as jobs
    from vlgae_tpu_torch.parallel import DataGroup

    return jobs.first_batch(pipe, DataGroup())


def _check_grads(got, want, rtol, atol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {k}")


def _close_params(got, want, updates, atol, what):
    """Parameters after the same updates in two runs: within ``atol``, but
    the scorers' ``project2.bias``, whose gradient a log-softmax cancels to
    round-off, and which Adam's first steps move by about +-lr by its sign,
    within ``lr`` an update (as ``tests/test_torch_train.py`` holds them)."""
    for k, v in want.items():
        if k.endswith("project2.bias"):
            assert float((got[k] - v).abs().max()) <= updates * 2.002e-3, (what, k)
        else:
            torch.testing.assert_close(got[k], v, rtol=0, atol=atol, msg=f"{what}: {k}")


def _check_eval(got, want, got_out, want_out):
    assert got["uas"] == want["uas"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    for k in want:
        if k != "loss":
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert got_out == want_out  # arcs and top-5 factors by sample id


def _slice(setup, tmp_path_factory, world):
    """Rank 0's results of the slice job at ``world`` and its directory."""
    root, _, _, weights = setup
    out = tmp_path_factory.mktemp(f"w{world}")
    args = {"weights": weights, "precisions": ["32", "bf16"],
            "overrides": {p: tt.overrides(root, precision=p) for p in ("32", "bf16")}}
    return run_job("slice", args, world, out)[0], out


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    return _slice(setup, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    return _slice(setup, tmp_path_factory, 4)


def test_world2_step_eval_and_epoch_match_one_process_and_jax(setup, world2, tmp_path):
    _check_slice(setup, *world2, tmp_path)


def test_world4_step_eval_and_epoch_match_one_process_and_jax(setup, world4, tmp_path):
    """World 4 (2 rows a rank): rank offsets past 1, the text-axis
    log-softmax over 4 ranks, and ranks that hold only filler rows: a
    padded batch of 8 leaves rows 6-7 (rank 3) filler-only whenever it
    holds 6 sentences or fewer, which some dev batches and the epoch's
    last train batch do."""
    one = _check_slice(setup, *world4, tmp_path)
    for split in ("dev", "train"):
        sizes = [len(x["seq_len"]) for x, _ in one.dm.batches(split, shuffle=False)]
        assert min(sizes) <= 6, (split, sizes)


def _check_slice(setup, got, out, tmp_path):
    """A world's step (loss, gradients), dev evaluation and joint epoch
    against one process and the JAX package on one device; returns the
    one-process pipeline."""
    root, jpipe, flat, weights = setup
    ovs = tt.overrides(root)
    one = _port(root, ovs, weights)
    loss1, grads1 = _step(one)
    x, y = tt_batch(one)
    want_loss, want_aux, want_grads, _ = tt._jax_step(jpipe, x, y, False)
    # the step: world 2 against one process and against JAX
    for k, v in loss1.items():
        assert got["32"]["loss"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    assert got["32"]["loss"]["loss"] == pytest.approx(want_loss, rel=LOSS_RTOL)
    for k, v in want_aux.items():
        assert got["32"]["loss"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    _check_grads(got["32"]["grads"], grads1, GRAD_RTOL, GRAD_ATOL, "vs one process")
    _check_grads(got["32"]["grads"], want_grads, GRAD_RTOL, GRAD_ATOL, "vs JAX")
    assert np.abs(got["32"]["grads"]["vis_mlp_pre_matching/kernel"]).max() > 0
    # the dev evaluation: metrics summed, predictions merged, rank 0's file
    val1, out1 = one.evaluate("dev")
    _check_eval(got["eval"], val1, got["outputs"], out1)
    one.write_predictions(str(tmp_path / "dev.predict.txt"), "dev", out1)
    assert (out / "dev.predict.txt").read_bytes() == (tmp_path / "dev.predict.txt").read_bytes()
    # one joint epoch
    epoch1 = one.train_epoch(1)
    for k in ("train/loss", "train/nll", "train/txt2vis", "train/mt_vis2txt"):
        assert got["epoch1"][k] == pytest.approx(epoch1[k], rel=EPOCH_RTOL), k
    # no leaf was sharded without trainer.fsdp
    assert not any(s for s, _, _ in got["sharded"].values())
    return one


def test_world2_bf16_step_matches_one_process(setup, world2):
    """precision=bf16: K5/K6's plain versions under match_maxes_sharded."""
    _check_bf16(setup, world2[0]["bf16"])


def test_world4_bf16_step_matches_one_process(setup, world4):
    _check_bf16(setup, world4[0]["bf16"])


def _check_bf16(setup, got):
    root, _, _, weights = setup
    loss1, grads1 = _step(_port(root, tt.overrides(root, precision="bf16"), weights))
    for k, v in loss1.items():
        assert got["loss"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    for k, g in grads1.items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(g).max() + GRAD_ATOL, err_msg=k)


def test_world2_step_matches_jax_on_a_two_device_mesh(setup, world2, monkeypatch):
    _check_jax_mesh(setup, world2[0]["bf16"], 2, monkeypatch)


def test_world4_step_matches_jax_on_a_four_device_mesh(setup, world4, monkeypatch):
    _check_jax_mesh(setup, world4[0]["bf16"], 4, monkeypatch)


def _check_jax_mesh(setup, got, n, monkeypatch):
    """The JAX Pipeline on ``n`` of the 8 virtual devices with
    match_kernel='pallas_sharded' (its kernel in interpret mode, by the JAX
    package's own test switch), at precision=bf16, where the port's sharded
    wrapper runs the plain K5/K6: the step's loss and gradients, to the
    tolerances of bf16 operands that tests/test_torch_train.py holds the
    one-device kernel step to (loss 1e-3, gradients 1e-3 + 2e-2 relative).
    (At precision 32 the JAX kernel keeps its bf16 cotangent rounding and
    first-winner routing, which the einsum path and the port's f32 stream do
    not: that case is held to the one-device JAX step above.)"""
    from flax import traverse_util

    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HashSubwordTokenizer, attach_subwords
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve

    root, jpipe1, flat, _ = setup
    monkeypatch.setenv("VLGAE_MATCH_INTERPRET_SHARDED", "1")
    cfg = resolve(ConfigComposer(str(REPO / "configs")).compose(
        "config_train", tt.overrides(root, precision="bf16")))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    dm = VLParseDataModule(**dm_cfg).setup()
    attach_subwords(dm, HashSubwordTokenizer())
    model = build_model(cfg, dm)
    model = model.clone(cfg=dataclasses.replace(model.cfg, match_kernel="pallas_sharded"))
    jpipe = Pipeline(model, dm, cfg, workdir=str(root), devices=jax.devices()[:n])
    assert jpipe.n_devices == n
    jpipe.init_state(next(dm.batches("train", shuffle=False)), seed=0)
    jpipe.state.params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    jpipe.state.opt_state = jpipe.tx.init(jpipe.state.params)
    x, y = tt._batch(dm, "train", False)  # 8 rows: they split over 2 and 4 devices
    want_loss, want_aux, want_grads, _ = tt._jax_step(jpipe, x, y, False)
    assert got["loss"]["loss"] == pytest.approx(want_loss, rel=1e-3)
    for k, v in want_aux.items():
        assert got["loss"][k] == pytest.approx(v, rel=1e-3), k
    _check_grads(got["grads"], want_grads, 2e-2, 1e-3, f"world {n} vs JAX mesh {n}")


@pytest.fixture(scope="module")
def fsdp2(setup, tmp_path_factory):
    """The slice job at world 2 with trainer.fsdp (dropout on), a checkpoint
    and a watcher of every update's parameters and gradients."""
    root, _, _, weights = setup
    out = tmp_path_factory.mktemp("fsdp")
    fsdp_ovs = tt.overrides(root, dropout=True) + ["trainer.fsdp=true",
                                                   "trainer.fsdp_min_size=64"]
    return run_job("slice", {"weights": weights, "precisions": ["32"], "checkpoint": True,
                             "watch": True, "overrides": {"32": fsdp_ovs}}, 2, out)


def test_fsdp_world2_shards_and_reproduces_one_process(setup, fsdp2, tmp_path):
    root, _, _, weights = setup
    ovs = tt.overrides(root, dropout=True)
    r0 = fsdp2[0]
    # leaves >= fsdp_min_size are sharded (local shard x 2 = whole), small
    # ones whole; Adam's moments mirror them
    big = {n for n, (_, _, numel) in r0["sharded"].items() if numel >= 64}
    assert big
    for n, (sharded, local_n, numel) in r0["sharded"].items():
        if sharded:
            assert local_n * 2 == numel, n
        else:
            assert local_n == numel, n
    from vlgae_tpu_torch.parallel import fsdp_leaf_spec

    one = _port(root, ovs, weights)
    for n, p in one.model.named_parameters():
        assert r0["sharded"][n][0] == (fsdp_leaf_spec(p.shape, 2, 64) is not None), n
    assert r0["moments"]
    for n, (moment, numel) in r0["moments"].items():
        assert moment * (2 if r0["sharded"][n][0] else 1) == numel, n
    assert sum(s for s, _, _ in r0["sharded"].values()) >= 10
    # the same sequence in one process (the step draws dropout masks too),
    # then eval and one joint epoch (dropout on)
    loss1, _ = _step(one)
    assert r0["32"]["loss"]["loss"] == pytest.approx(loss1["loss"], rel=LOSS_RTOL)
    val1, out1 = one.evaluate("dev")
    _check_eval(r0["eval"], val1, r0["outputs"], out1)
    epoch1 = one.train_epoch(1)
    for k in ("train/loss", "train/nll", "train/txt2vis", "train/mt_vis2txt"):
        assert r0["epoch1"][k] == pytest.approx(epoch1[k], rel=EPOCH_RTOL), k
    # the checkpoint holds the whole state, as one process's does
    one.workdir = str(tmp_path)
    ref = torch.load(one.save_checkpoint("last"), weights_only=True)
    ckpt = torch.load(r0["checkpoint"], weights_only=True)
    assert ckpt.keys() == ref.keys()
    assert ckpt["model"].keys() == ref["model"].keys()
    assert ckpt["step"] == ref["step"] > 0
    for k, v in ref["model"].items():
        assert ckpt["model"][k].shape == v.shape and ckpt["model"][k].device == v.device, k
    _close_params(ckpt["model"], ref["model"], ckpt["step"], 2e-5, "checkpoint")
    want_state = ref["optimizer"]["adam"]["state"]
    got_state = ckpt["optimizer"]["adam"]["state"]
    assert got_state.keys() == want_state.keys()
    for i, st in want_state.items():
        for k, v in st.items():
            assert got_state[i][k].shape == v.shape, (i, k)
    # resumed at world 1, it continues the FSDP run's trajectory
    resumed = _port(root, ovs, weights)
    resumed.load_checkpoint(r0["checkpoint"], load_training_state=True)
    epoch2 = resumed.train_epoch(2)
    for k in ("train/loss", "train/nll"):
        assert r0["epoch2"][k] == pytest.approx(epoch2[k], rel=EPOCH_RTOL), k
    _close_params(r0["params"], {n: p.detach() for n, p in resumed.model.named_parameters()},
                  resumed.step - ckpt["step"], 2e-5, "resumed")


def test_fsdp_world2_watcher_logs_the_global_gradients(setup, fsdp2, monkeypatch):
    """Under FSDP at world 2 the wandb watcher of rank 0 logs the whole
    parameters and the gradients summed over the ranks, as one process
    logs them at the same update; the other rank logs nothing."""
    import types

    from vlgae_tpu_torch.utils.logger import WandbWatcher

    root, _, _, weights = setup
    got = fsdp2[0]["watched"]
    assert fsdp2[1]["watched"] == []
    logged = []
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(
        run=types.SimpleNamespace(), Histogram=lambda a: a.copy(),
        log=lambda payload, step=None: logged.append((step, payload))))
    one = _port(root, tt.overrides(root, dropout=True), weights)
    _step(one)  # the job's sequence of draws: a step, eval, the epoch
    one.evaluate("dev")
    one.watcher = WandbWatcher(log="all", log_freq=1)
    one.train_epoch(1)
    (step, want), = logged[:1]
    (got_step, got), = got
    assert got_step == step == 0
    assert set(got) == set(want), set(got) ^ set(want)
    assert any(k.startswith("gradients/") for k in want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if k.startswith("gradients/"):
            np.testing.assert_allclose(got[k], v, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _cli(module, args, cwd, world, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={world}", "-m", module] if world > 1
              else [sys.executable, "-m", module])
    proc = subprocess.run(launch + args, cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, f"{module} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}"
    return proc.stdout


def test_cli_under_torchrun_writes_what_one_process_writes(setup, tmp_path):
    """``torchrun --nproc_per_node=2 -m vlgae_tpu_torch.train device=cpu``:
    rank 0 writes the run; its losses are one process's; ``predict`` under
    torchrun writes the files one process writes from that checkpoint."""
    root = setup[0]
    ovs = tt.overrides(root)[:-len(tt.NO_DROPOUT)] + [
        "datamodule.dev_dataloader.num_bucket=1", "datamodule.test_dataloader.num_bucket=1",
        "trainer.max_epochs=2", "init_seed=0", "device=cpu"]
    runs = {}
    for world in (2, 1):
        run = tmp_path / f"run{world}"
        stdout = _cli("vlgae_tpu_torch.train", ovs + [f"workdir={run}"], tmp_path, world)
        runs[world] = [json.loads(s) for s in stdout.splitlines() if s.startswith("{")]
    # printed once (by rank 0): the mid-epoch and epoch lines and the test split
    assert len(runs[2]) == len(runs[1]) >= 3
    for a, b in zip(runs[2], runs[1]):
        for k, v in b.items():
            if k.startswith(("train/loss", "train/nll", "val/loss", "test/loss")):
                assert a[k] == pytest.approx(v, rel=EPOCH_RTOL), k
    assert sorted(os.listdir(tmp_path / "run2" / "checkpoint")) == ["best.pt", "last.pt"]
    ckpt = str(tmp_path / "run2" / "checkpoint" / "last.pt")
    for world in (2, 1):
        (tmp_path / f"p{world}").mkdir()
        _cli("vlgae_tpu_torch.predict", [f"checkpoint={ckpt}", "device=cpu", "name=p"],
             tmp_path / f"p{world}", world)
    for split in ("train", "dev", "test"):
        assert ((tmp_path / "p2" / f"p_{split}.conll").read_bytes()
                == (tmp_path / "p1" / f"p_{split}.conll").read_bytes()), split
