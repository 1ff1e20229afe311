"""The plain versions of the separate DMV inside and outside passes, and
their dispatch, against vlgae_tpu's Pallas kernels in interpret mode.

Tie-free random potentials from a numpy seed (``test_struct_dmv``). The
TPU package takes its v2 fill (and the v2-save + outside pair) at n1 = 9,
and its v3 fill at n1 = 17; there the pair is reached with ``USE_FUSED``
switched off, as ``tests/test_dmv_pallas.py`` does. Tolerances: rtol 1e-4 /
atol 1e-5 on totals and on gradients under a non-unit cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_struct_dmv import merged_batch, random_potentials
from vlgae_tpu.ops import dmv_pallas
from vlgae_tpu_torch.ops.dmv_cuda import inside_mapping
from vlgae_tpu_torch.struct import (DMV1o, DMVTotalFn, dmv_inside_charts_plain,
                                    dmv_outside_plain, dmv_total, dmv_total_fast,
                                    dmv_value_and_grads_plain)
from vlgae_tpu_torch.struct.dmv import NEGINF, NOCHILD

RTOL, ATOL = 1e-4, 1e-5
CASES = {9: (3, 8, 2, 6, 4, 1, 8, 7), 17: (16, 3, 9, 12, 1, 16, 7, 10)}


def _batch(n1, seed=0):
    rng = np.random.default_rng(seed)
    mdec, mattach, lens = merged_batch([random_potentials(rng, n) for n in CASES[n1]])
    assert mattach.shape[1] == n1
    return mdec.astype(jnp.float32), mattach.astype(jnp.float32), lens


def _torch(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _cotangent(B):
    g = np.linspace(0.5, 2.0, B).astype(np.float32)
    g[B // 2] = 0.0
    return g


def _jax_total(kind, monkeypatch, fused):
    if not fused:
        monkeypatch.setattr(dmv_pallas, "USE_FUSED", False)
    return dmv_pallas._make_dmv_total(is_max=kind == "max", interpret=True)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", [9, 17])
def test_total_matches_the_value_only_pallas_kernels(n1, kind, monkeypatch):
    mdec, mattach, lens = _batch(n1)
    # the launch the TPU package would make: v2 below n1 = 10, v3 from there
    assert (dmv_pallas._v3_max_launch(n1, False) > 0) == (n1 >= 10)
    want = np.asarray(_jax_total(kind, monkeypatch, True)(mdec, mattach, lens))
    got = dmv_total(*_torch(mdec, mattach, lens), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    fast = dmv_total_fast(*_torch(mdec, mattach, lens), kind)
    assert torch.equal(fast, got)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", [9, 17])
def test_outside_plain_matches_the_pallas_pair(n1, kind, monkeypatch):
    """jax.grad of the two-launch pair (inside that saves its charts, then
    the outside kernel) under a cotangent with a zero in it."""
    mdec, mattach, lens = _batch(n1, seed=1)
    g = _cotangent(len(CASES[n1]))
    total = _jax_total(kind, monkeypatch, fused=False)
    assert dmv_pallas._fused_max_launch(n1) == 0 or not dmv_pallas.USE_FUSED
    gd, ga = jax.grad(lambda d, a: jnp.sum(jnp.asarray(g) * total(d, a, lens)),
                      argnums=(0, 1))(mdec, mattach)
    d, a, ln = _torch(mdec, mattach, lens)
    logz, charts = dmv_inside_charts_plain(d, a, ln, kind)
    pd, pa = dmv_outside_plain(d, a, ln, torch.from_numpy(g), logz, charts, kind)
    np.testing.assert_allclose(pd.numpy(), np.asarray(gd), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ga), rtol=RTOL, atol=ATOL)
    assert float(pd[len(g) // 2].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["log", "max"])
def test_charts_layout(kind):
    """[B, 4, w, i, v]: the semiring zero off the span triangle and on the
    width-0 rows of Ir/Il; the seeds on the width-0 rows of Cr/Cl; the total
    at Cr[len, 0, NOCHILD]; root-headed spans short of the sentence masked."""
    d, a, ln = _torch(*_batch(9, seed=2))
    total, charts = dmv_inside_charts_plain(d, a, ln, kind)
    B, n1 = d.shape[:2]
    assert tuple(charts.shape) == (B, 4, n1, n1, 2)
    assert torch.equal(total, dmv_total(d, a, ln, kind))
    for b, n in enumerate(ln.tolist()):
        assert float(charts[b, 0, n, 0, NOCHILD]) == float(total[b])
        for w in range(n1):
            for i in range(n1):
                cell = charts[b, :, w, i]
                if i + w > n:
                    assert bool((cell == NEGINF).all()), (b, w, i)
                elif w == 0:
                    assert torch.equal(cell[0], d[b, i, 1, :, 1])  # Cr: RIGHT, STOP
                    assert torch.equal(cell[1], d[b, i, 0, :, 1])  # Cl: LEFT, STOP
                    assert bool((cell[2:] == NEGINF).all())
                elif i == 0 and w != n:
                    assert bool((cell[0] == NEGINF).all())
    # a chart cell feeds the total: the marginal of a length-n sentence's
    # full span is one
    per, _, _ = dmv_value_and_grads_plain(d, a, ln, kind)
    assert torch.equal(per, total)


@pytest.mark.parametrize("kind", ["log", "max"])
def test_total_fn_matches_jax_grad_under_a_random_cotangent(kind, monkeypatch):
    mdec, mattach, lens = _batch(9, seed=3)
    g = np.random.default_rng(4).standard_normal(len(CASES[9])).astype(np.float32)
    total = _jax_total(kind, monkeypatch, True)
    want = np.asarray(total(mdec, mattach, lens))
    gd, ga = jax.grad(lambda d, a: jnp.sum(jnp.asarray(g) * total(d, a, lens)),
                      argnums=(0, 1))(mdec, mattach)
    d, a, ln = _torch(mdec, mattach, lens)
    d.requires_grad_(True)
    a.requires_grad_(True)
    got = DMVTotalFn.apply(d, a, ln, kind)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=RTOL, atol=ATOL)


def test_dispatch_by_what_the_caller_needs():
    d, a, ln = _torch(*_batch(9, seed=5))
    d.requires_grad_(True)
    fast = dmv_total_fast(d, a, ln, "log")
    assert not fast.requires_grad and fast.grad_fn is None
    dist = DMV1o((d, a), ln)
    assert dist.partition.requires_grad and dist.max.requires_grad
    with torch.no_grad():
        assert not dist.partition.requires_grad
    plain = DMV1o((d.detach(), a), ln)
    assert not plain.max.requires_grad
    assert torch.equal(plain.partition, fast)
    _, gd, ga = dmv_value_and_grads_plain(d.detach(), a, ln, "log")
    assert torch.equal(plain.marginals, ga)
    assert all(torch.equal(x, y) for x, y in zip(plain.marginals_full, (gd, ga)))
    ind = dmv_value_and_grads_plain(d.detach(), a, ln, "max")[2]
    assert torch.equal(plain.argmax, ind)
    assert torch.equal(plain.argmax_heads, ind.sum(-1)[:, :, 1:].argmax(1))
    # the semiring surface takes the generic fill, not the kernels' dispatch
    from vlgae_tpu_torch.struct import EntropySemiring, StdSemiring, dmv_partition

    assert torch.equal(plain.entropy, dmv_partition(d.detach(), a, ln, EntropySemiring))
    ones = [torch.where(x <= NEGINF / 2, 0.0, 1.0) for x in (d.detach(), a)]
    assert torch.equal(plain.count, dmv_partition(*ones, ln, StdSemiring))
    torch.testing.assert_close(plain.kmax(2)[0], plain.max, rtol=1e-6, atol=1e-5)
    with pytest.raises(RuntimeError):
        dmv_total_fast(d.detach().to("meta"), a.to("meta"), ln, "log")


@pytest.mark.parametrize("n1,want", [
    (1, "warp"), (9, "warp"), (10, "smem"), (57, "smem"), (85, "smem"),
    (86, "global"), (200, "global")])
def test_inside_mapping_is_by_n1_and_the_shared_memory_limit(n1, want):
    assert inside_mapping(n1, 232448) == want  # the H100's opt-in limit
    # a card with the default 48 KB only: 32 * n1^2 <= 49152 up to n1 = 39
    assert inside_mapping(n1, 49152) == ("warp" if n1 <= 9 else
                                         "smem" if n1 <= 39 else "global")
