"""The port's DMV DP (vlgae_tpu_torch.struct) against vlgae_tpu.

The plain PyTorch version is held against the JAX scan
(``dmv_value_and_grads_fast`` on the CPU) and against ``jax.grad`` of the
Pallas kernels in interpret mode, on tie-free random potentials (ties are
outside the CUDA kernel's contract). Tolerance rtol 1e-4 / atol 1e-5, as
in tests/test_dmv_pallas.py. The kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_struct_dmv import merged_batch, random_potentials
from vlgae_tpu.ops import dmv_max_pallas_interpret, dmv_partition_pallas_interpret
from vlgae_tpu.struct.distributions import dmv_value_and_grads_fast
from vlgae_tpu_torch.struct import (dmv_merge, dmv_value_and_grads,
                                    dmv_value_and_grads_plain)

RTOL, ATOL = 1e-4, 1e-5
CASES = {
    "ragged_1-9": (3, 5, 2, 6, 4, 1, 9, 7, 8),
    "uniform_9": (9, 9, 9),
    "short": (1, 2, 1),
}


def _batch(lengths, zero_row=False, seed=0):
    rng = np.random.default_rng(seed)
    mdec, mattach, lens = merged_batch([random_potentials(rng, n) for n in lengths])
    mdec, mattach = mdec.astype(jnp.float32), mattach.astype(jnp.float32)
    if zero_row:  # a batch-padding filler: row 0 with length 0
        mdec = jnp.concatenate([mdec, mdec[:1]])
        mattach = jnp.concatenate([mattach, mattach[:1]])
        lens = jnp.concatenate([lens, jnp.zeros(1, lens.dtype)])
    return mdec, mattach, lens


def _torch(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["log", "max"])
def test_plain_matches_jax_scan(case, kind):
    mdec, mattach, lens = _batch(CASES[case], zero_row=True)
    want = dmv_value_and_grads_fast(mdec, mattach, lens, kind)
    got = dmv_value_and_grads_plain(*_torch(mdec, mattach, lens), kind)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["log", "max"])
def test_plain_matches_pallas_interpret(kind):
    # no zero-length rows: the TPU kernel leaves them outside its contract
    mdec, mattach, lens = _batch(CASES["ragged_1-9"], seed=1)
    fn = dmv_partition_pallas_interpret if kind == "log" else dmv_max_pallas_interpret
    total = np.asarray(fn(mdec, mattach, lens))
    gd, ga = jax.grad(lambda d, a: jnp.sum(fn(d, a, lens)), argnums=(0, 1))(
        mdec, mattach)
    per, pgd, pga = dmv_value_and_grads_plain(*_torch(mdec, mattach, lens), kind)
    np.testing.assert_allclose(per.numpy(), total, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pgd.numpy(), np.asarray(gd), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pga.numpy(), np.asarray(ga), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["log", "max"])
def test_plain_single_position_rows_match_jax(kind):
    rng = np.random.default_rng(3)
    mdec = jnp.asarray(rng.standard_normal((2, 1, 2, 2, 2)), jnp.float32)
    mattach = jnp.asarray(rng.standard_normal((2, 1, 1, 2)), jnp.float32)
    lens = jnp.zeros(2, jnp.int32)
    want = dmv_value_and_grads_fast(mdec, mattach, lens, kind)
    got = dmv_value_and_grads_plain(*_torch(mdec, mattach, lens), kind)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_merge_matches_jax():
    from vlgae_tpu.struct import dmv_merge as jax_merge

    rng = np.random.default_rng(2)
    dec, attach, root = (rng.standard_normal(s).astype(np.float32)
                         for s in ((2, 4, 2, 2, 2), (2, 4, 4, 2), (2, 4)))
    want = jax_merge(jnp.asarray(dec), jnp.asarray(attach), jnp.asarray(root))
    got = dmv_merge(*_torch(dec, attach, root))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dispatch_cpu_takes_plain_and_other_devices_raise():
    mdec, mattach, lens = _torch(*_batch((3, 2)))
    got = dmv_value_and_grads(mdec, mattach, lens, "max")
    want = dmv_value_and_grads_plain(mdec, mattach, lens, "max")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError):
        dmv_value_and_grads(mdec.to("meta"), mattach.to("meta"), lens, "max")
