"""The port's data parallelism (vlgae_tpu_torch/parallel) against vlgae_tpu.

Pure functions (``pad_batch_to_devices``, ``fsdp_leaf_spec``) against the
JAX package's on random inputs; the sharded matching wrapper
``match_maxes_sharded`` at world 2 and 4 (``torchrun`` on gloo, the plain
K5/K6 versions on the CPU) against the single-process wrapper and against
JAX's ``match_maxes_pallas_sharded`` (interpret mode) on a 2- and 4-device
mesh of the 8 virtual CPU devices; metric states and predictions across
processes; the dropout draws of a rank; the options the port refuses.

Tolerances: values and indices exact (quarter-integer operands: every
product and sum is exact in f32); gradients exact with f32 operands; with
bf16 operands ``dvis`` is reduce-scattered in bf16 (as JAX transposes a
bf16 all-gather), so a rank's image gradient is rounded to bf16 twice (its
partial sum, then the sum over ranks): within 2 bf16 ulps, ``2^-7``
relative.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JOBS = Path(__file__).resolve().parent / "test_torch_parallel_jobs.py"
sys.path.insert(0, str(JOBS.parent))
import test_torch_parallel_jobs as jobs  # noqa: E402

MATCH_SHAPE = (8, 12, 8, 9, 16)  # A, V, B, Q, D
BF16_RTOL = 2.0 ** -7


def run_job(job, args, world, tmp, timeout=240):
    """Run ``job`` on ``world`` gloo ranks under torchrun; every rank's
    result. A hung collective fails the test at ``timeout``."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(JOBS.parent)]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={world}", str(JOBS), job, str(tmp / "args.json"), str(tmp)],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"job {job} at world {world} timed out after {timeout} s")
    assert proc.returncode == 0, f"job {job} failed:\n{stdout[-3000:]}\n{stderr[-6000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- pure functions ------------------------------------------------------------------
def test_pad_batch_to_devices_matches_jax():
    from vlgae_tpu.parallel import pad_batch_to_devices as jpad
    from vlgae_tpu_torch.parallel import pad_batch_to_devices

    rng = np.random.default_rng(0)
    for _ in range(40):
        B = int(rng.integers(1, 40))
        batch = {"seq_len": rng.integers(1, 9, B).astype(np.int32),
                 "word": rng.integers(0, 50, (B, int(rng.integers(1, 6)))),
                 "feat": rng.standard_normal((B, 3, 2)).astype(np.float32)}
        n, pow2, min_b = int(rng.choice([1, 2, 3, 4, 8])), bool(rng.integers(2)), int(
            rng.choice([1, 8, 16]))
        got, real = pad_batch_to_devices(batch, n, pow2=pow2, min_b=min_b)
        want, jreal = jpad(batch, n, pow2=pow2, min_b=min_b)
        assert real == jreal == B
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert len(got["seq_len"]) % n == 0


def test_fsdp_leaf_spec_matches_jax():
    from jax.sharding import PartitionSpec as P

    from vlgae_tpu.parallel import fsdp_leaf_spec as jspec
    from vlgae_tpu_torch.parallel import fsdp_leaf_spec

    rng = np.random.default_rng(1)
    for _ in range(200):
        shape = tuple(int(s) for s in rng.integers(1, 40, int(rng.integers(0, 4))))
        dp, min_size = int(rng.choice([1, 2, 3, 4, 8])), int(rng.choice([1, 16, 64, 1 << 16]))
        want = jspec(np.zeros(shape, np.float32), dp, min_size)
        axis = fsdp_leaf_spec(shape, dp, min_size)
        assert want == (P() if axis is None else P(*([None] * axis + ["data"]))), (
            shape, dp, min_size, want, axis)


def test_a_batch_that_does_not_split_raises():
    """The rows a rank uploads (and so the captions and images it passes
    match_maxes_sharded) come from DataGroup.rows, which refuses a batch
    that does not split over the ranks."""
    from vlgae_tpu_torch.parallel import DataGroup, shard_batch

    dp = DataGroup(rank=1, world=2)
    assert dp.rows(8) == (4, 8)
    with pytest.raises(ValueError, match="does not split"):
        dp.rows(5)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"seq_len": np.ones(5, np.int32)}, dp)


def test_a_rank_draws_its_rows_of_the_global_dropout_mask():
    """With ``batch_rows`` set, a batched draw is the global batch's draw
    cut to this rank's rows; a table draw is the whole table's."""
    from vlgae_tpu_torch.models.nn import MLP, set_batch_rows, set_dropout_generator

    x = torch.randn(8, 3, 5)
    outs = {}
    for rows in (None, (0, 4, 8), (4, 8, 8)):
        m = MLP(5, 6, dropout=0.5).train()
        torch.manual_seed(0)
        m.linear.reset_parameters()
        set_dropout_generator(m, torch.Generator().manual_seed(3))
        set_batch_rows(m, rows)
        outs[rows] = m(x if rows is None else x[rows[0]:rows[1]])
    torch.testing.assert_close(torch.cat([outs[(0, 4, 8)], outs[(4, 8, 8)]]), outs[None],
                               rtol=0, atol=0)
    table = MLP(5, 6, dropout=0.5, batched=False).train()
    set_dropout_generator(table, torch.Generator().manual_seed(3))
    set_batch_rows(table, (0, 4, 8))
    assert table(torch.randn(11, 5)).shape == (11, 6)
    with pytest.raises(ValueError, match="batched draw"):
        set_batch_rows(m, (0, 4, 8))
        m(x)


# -- the sharded matching -------------------------------------------------------------
def _whole_batch(dtype):
    """The single-process wrapper on the whole batch (world 1: MatchMaxesFn)."""
    from vlgae_tpu_torch.ops.match import match_maxes_sharded

    x = jobs.match_inputs(0, *MATCH_SHAPE)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    vis = torch.tensor(x["vis"], dtype=dt).requires_grad_(True)
    txt = torch.tensor(x["txt"], dtype=dt).requires_grad_(True)
    logit, li, logit_v, lvi = match_maxes_sharded(
        vis, txt, torch.from_numpy(x["vb"]), torch.from_numpy(x["tb"]), None)
    ((logit * torch.from_numpy(x["wm"])).sum()
     + (logit_v * torch.from_numpy(x["wmv"])).sum()).backward()
    return {"logit": logit.detach(), "logit_idx": li, "logit_v": logit_v.detach(),
            "logit_v_idx": lvi, "dvis": vis.grad.float(), "dtxt": txt.grad.float()}


def _jax_sharded(world):
    """JAX's match_maxes_pallas_sharded (interpret) on a ``world``-device
    mesh: values and the gradients of the same weighted sum."""
    import vlgae_tpu.ops.dmv_pallas as dp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from vlgae_tpu.ops.match_pallas import match_maxes_pallas_sharded

    x = jobs.match_inputs(0, *MATCH_SHAPE)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    shard = NamedSharding(mesh, P("data"))

    @jax.jit
    def run(v, t):
        def loss(v, t):
            m, mv = match_maxes_pallas_sharded(v, t, True, jnp.asarray(x["vb"]),
                                               jnp.asarray(x["tb"]))
            return jnp.sum(m * x["wm"]) + jnp.sum(mv * x["wmv"]), (m, mv)

        (_, (m, mv)), g = jax.value_and_grad(loss, (0, 1), has_aux=True)(v, t)
        return m, mv, g

    try:
        dp.set_data_parallel_mesh(mesh)
        m, mv, (dv, dt) = run(jax.device_put(jnp.asarray(x["vis"]), shard),
                              jax.device_put(jnp.asarray(x["txt"]), shard))
    finally:
        dp.set_data_parallel_mesh(None)
    return {"logit": np.asarray(m), "logit_v": np.asarray(mv),
            "dvis": np.asarray(dv), "dtxt": np.asarray(dt)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matching_matches_one_process_and_jax(world, tmp_path):
    ranks = run_job("match", {"seed": 0, "shape": list(MATCH_SHAPE)}, world, tmp_path)
    A, B = MATCH_SHAPE[0], MATCH_SHAPE[2]
    jax_out = _jax_sharded(world)
    for dtype in ("f32", "bf16"):
        got = {k: torch.cat([r[dtype][k] for r in ranks]) for k in ranks[0][dtype]}
        want = _whole_batch(dtype)
        # the captions' outputs concatenate: [B, A, *] over all A images
        assert got["logit"].shape == (B, A, MATCH_SHAPE[3])
        for k in ("logit", "logit_idx", "logit_v", "logit_v_idx", "dtxt"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{dtype} {k}")
        if dtype == "f32":
            torch.testing.assert_close(got["dvis"], want["dvis"], rtol=0, atol=0)
        else:
            torch.testing.assert_close(got["dvis"], want["dvis"], rtol=BF16_RTOL,
                                       atol=BF16_RTOL * float(want["dvis"].abs().max()))
        # JAX's sharded kernel on a mesh of as many devices
        for k in ("logit", "logit_v"):
            np.testing.assert_array_equal(got[k].numpy(), jax_out[k], err_msg=k)
        for k in ("dtxt", "dvis"):
            if dtype == "f32":
                np.testing.assert_array_equal(got[k].numpy(), jax_out[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k].numpy(), jax_out[k], rtol=BF16_RTOL,
                                           atol=BF16_RTOL * np.abs(jax_out[k]).max(),
                                           err_msg=k)
    # metric states and predictions across processes = one process over
    # the union of the shards
    from vlgae_tpu_torch.training.metrics import (DependencyParsingMetric,
                                                  FactorImageMatchingMetric, MultiMetric)

    data = jobs.metric_inputs(0)
    metric = MultiMetric(DependencyParsingMetric(), img=FactorImageMatchingMetric())
    everyone = list(range(len(data["arc"])))
    jobs.update_metric(metric, data, everyone)
    want_scores = metric.compute()
    for r in ranks:
        assert r["scores"] == pytest.approx(want_scores, rel=1e-12)
        assert r["merged"] == jobs.predictions(data, everyone)


# -- options the port refuses -----------------------------------------------------------
def _corpus(root):
    import synth_data

    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=2, feat_dim=16, n_box=6,
                           len_range=(3, 6))
    return [
        "exp=vlgae", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.pad_boxes=6", "_hidden_size=32", "_match_hidden_size=16",
        "_rank=4", "vis_encoder.n_in=16", "vis_encoder.n_hidden=32",
    ]


def test_model_parallel_raises(tmp_path):
    """``trainer.model_parallel=2`` in one process: a world of 1 that 2 does
    not divide raises the JAX package's ``ValueError`` (the ``(data,
    model)`` grids that run are in tests/test_torch_tensor_parallel.py)."""
    from vlgae_tpu.parallel import data_parallel_mesh
    from vlgae_tpu_torch.predict import build_pipeline

    with pytest.raises(ValueError, match="1 devices not divisible by model=2") as want:
        data_parallel_mesh(jax.devices()[:1], model=2)
    with pytest.raises(ValueError) as got:
        build_pipeline(_corpus(tmp_path) + ["trainer.model_parallel=2"], device="cpu",
                       init_seed=0)
    assert str(got.value) == str(want.value)


def test_unknown_match_kernel_raises_as_in_jax(tmp_path):
    from vlgae_tpu_torch.predict import build_pipeline

    ovs = _corpus(tmp_path)
    with pytest.raises(ValueError, match=r"match_kernel='mosaic' not in"):
        build_pipeline(ovs + ["model.match_kernel=mosaic"], device="cpu", init_seed=0)
    for value in ("auto", "pallas", "pallas_sharded", "xla"):
        pipe = build_pipeline(ovs + [f"model.match_kernel={value}"], device="cpu",
                              init_seed=0)
        assert pipe.model.cfg.match_kernel == value
