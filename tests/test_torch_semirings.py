"""The port's semirings and generic chart fills against vlgae_tpu.

Inputs come from numpy seeds and go through both packages. Held to: every
semiring's algebra within 1e-6; ``dmv_inside`` and ``deptree_inside``
(single-root, multiroot, labeled) in every semiring within 1e-5 at B = 3
and ragged lengths up to 6, with their gradients where the semiring has
one; the brute-force oracles of tests/oracles.py (partition, entropy,
count); the Log and Max totals of the generic fills equal to the kernels'
plain versions (``dmv_total``, ``deptree_partition`` by kind) within 1e-6;
``remat`` equal in values and gradients. The k-max channels past the
number of trees a short sentence has hold the semiring zero (about
-1e12), compared as "both below -1e8".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from vlgae_tpu.struct import deptree as jdeptree
from vlgae_tpu.struct import dmv as jdmv
from vlgae_tpu.struct import semirings as js
from vlgae_tpu_torch.struct import deptree as tdeptree
from vlgae_tpu_torch.struct import dmv as tdmv
from vlgae_tpu_torch.struct import semirings as ts
from vlgae_tpu_torch.struct.distributions import dmv_merge

SEMIRINGS = {
    "log": (js.LogSemiring, ts.LogSemiring),
    "max": (js.MaxSemiring, ts.MaxSemiring),
    "std": (js.StdSemiring, ts.StdSemiring),
    "tempmax": (js.TempMaxSemiring(2.0), ts.TempMaxSemiring(2.0)),
    "kmax": (js.KMaxSemiring(3), ts.KMaxSemiring(3)),
    "entropy": (js.EntropySemiring, ts.EntropySemiring),
    "cross_entropy": (js.CrossEntropySemiring, ts.CrossEntropySemiring),
    "kl": (js.KLDivergenceSemiring, ts.KLDivergenceSemiring),
    "risk": (js.RiskSemiring, ts.RiskSemiring),
}
PAIRED = ("cross_entropy", "kl", "risk")
# semirings whose total has a gradient worth comparing
WITH_GRAD = ("log", "max", "tempmax", "kmax", "entropy", "cross_entropy", "kl")
LENGTHS = np.array([6, 4, 1])


def close(got, want, tol, msg=""):
    """``got`` (torch) against ``want`` (JAX); entries both below -1e8 (the
    semiring zero) count as equal."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    both = (got < -1e8) & (want < -1e8)
    np.testing.assert_allclose(np.where(both, 0.0, got), np.where(both, 0.0, want),
                               rtol=tol, atol=tol, err_msg=msg)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x, np.float32))


# -- the algebra ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_semiring_algebra_matches_jax(name):
    J, T = SEMIRINGS[name]
    rng = np.random.default_rng(0)
    if name in PAIRED:
        raw = [rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(2)]
        jx = J.convert([jnp.asarray(r) for r in raw])
        tx = T.convert([torch.from_numpy(r) for r in raw])
    else:
        raw = rng.standard_normal((3, 4, 5)).astype(np.float32)
        if name == "std":
            raw = np.abs(raw)
        jx, tx = J.convert(jnp.asarray(raw)), T.convert(torch.from_numpy(raw))
    close(tx, jx, 1e-6, "convert")
    # a second operand: a stacked tensor of the same layout
    raw2 = rng.standard_normal(tuple(jx.shape)).astype(np.float32)
    if name == "std":
        raw2 = np.abs(raw2)
    jy, ty = _pair(raw2)
    for axis in (0, 1, -1):
        close(T.sum(tx, axis), J.sum(jx, axis), 1e-6, f"sum {axis}")
        close(T.sum(ty, axis), J.sum(jy, axis), 1e-6, f"sum(y) {axis}")
        close(T.prod(ty, axis), J.prod(jy, axis), 1e-6, f"prod {axis}")
    close(T.mul(tx, ty), J.mul(jx, jy), 1e-6, "mul")
    close(T.times(tx, ty, tx), J.times(jx, jy, jx), 1e-6, "times")
    close(T.unconvert(ty), J.unconvert(jy), 1e-6, "unconvert")
    close(T.zeros((2, 3)), J.zeros((2, 3)), 0, "zeros")
    close(T.ones((2, 3)), J.ones((2, 3)), 0, "ones")
    keep = rng.random((3, 4, 5)) > 0.4
    close(T.mask(ty, torch.from_numpy(keep)), J.mask(jy, jnp.asarray(keep)), 0, "mask")
    assert T.size == J.size


def test_max_splits_the_gradient_of_a_tie_evenly():
    """``jnp.max``'s gradient splits an exact tie; the port's ``amax`` does
    too (``torch.max(dim)`` would not)."""
    x = torch.tensor([[[1.0, 3.0, 3.0]]], requires_grad=True)
    ts.MaxSemiring.sum(x, -1).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[[0.0, 0.5, 0.5]]])


# -- the fills --------------------------------------------------------------------


def _dmv_inputs(name, rng):
    """Merged ``(dec, attach)`` at B = 3, N = 6, lengths 6/4/1, padded past
    each length with the semiring zero as :func:`merged_batch` pads; the
    second operand of a paired semiring (or the risk's cost) alongside."""
    B, N = 3, 6
    dec = rng.standard_normal((B, N, 2, 2, 2)).astype(np.float32)
    attach = rng.standard_normal((B, N, N, 2)).astype(np.float32)
    root = rng.standard_normal((B, N)).astype(np.float32)
    for b, n in enumerate(LENGTHS):
        attach[b, n:] = attach[b, :, n:] = -1e12
        root[b, n:] = -1e12
    md, ma = (t.numpy() for t in dmv_merge(torch.from_numpy(dec), torch.from_numpy(attach),
                                           torch.from_numpy(root)))
    if name == "std":
        md, ma = (np.where(x <= -5e11, 0.0, 1.0).astype(np.float32) for x in (md, ma))
    if name in PAIRED:
        other = [(x + 0.5 * rng.standard_normal(x.shape)).astype(np.float32)
                 for x in (md, ma)]
        if name == "risk":
            other = [rng.random(x.shape).astype(np.float32) for x in (md, ma)]
        return [md, other[0]], [ma, other[1]]
    return md, ma


def _arc_inputs(name, rng, labeled=False):
    shape = (3, 7, 7) + ((3,) if labeled else ())
    arc = rng.standard_normal(shape).astype(np.float32)
    if name == "std":
        arc = np.ones(shape, np.float32)
    if name in PAIRED:
        other = (rng.random(shape) if name == "risk"
                 else arc + 0.5 * rng.standard_normal(shape)).astype(np.float32)
        return [arc, other]
    return arc


def _to(x, fn):
    return [fn(np.asarray(v)) for v in x] if isinstance(x, list) else fn(np.asarray(x))


def _grad_target(x):
    """The tensor a gradient is taken with respect to (the first of a pair)."""
    return x[0] if isinstance(x, list) else x


@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_dmv_inside_matches_jax(name):
    import jax

    J, T = SEMIRINGS[name]
    rng = np.random.default_rng(1)
    dec, attach = _dmv_inputs(name, rng)
    lens = LENGTHS
    jv, _ = jdmv.dmv_inside(_to(dec, jnp.asarray), _to(attach, jnp.asarray),
                            jnp.asarray(lens), J)
    tdec = _to(dec, lambda v: torch.from_numpy(v).requires_grad_(True))
    tatt = _to(attach, lambda v: torch.from_numpy(v).requires_grad_(True))
    tv, charts = tdmv.dmv_inside(tdec, tatt, torch.from_numpy(lens), T)
    close(tv, jv, 1e-5, "value")
    assert charts["Cr"].shape == (T.size, 7, 3, 7, 2)
    if name not in WITH_GRAD:
        return

    def jtotal(a):
        att = [a] + list(_to(attach, jnp.asarray))[1:] if isinstance(attach, list) else a
        v, _ = jdmv.dmv_inside(_to(dec, jnp.asarray), att, jnp.asarray(lens), J)
        return J.unconvert(v).sum()

    want = jax.grad(jtotal)(jnp.asarray(_grad_target(attach)))
    T.unconvert(tv).sum().backward()
    close(_grad_target(tatt).grad, want, 1e-5, "d/d attach")


# paired potentials are pairs of [B, N1, N1] tables, never labeled ones
@pytest.mark.parametrize("name,mode", [
    (name, mode) for mode in ("single", "multiroot", "labeled") for name in SEMIRINGS
    if not (mode == "labeled" and name in PAIRED)])
def test_deptree_inside_matches_jax(name, mode):
    import jax

    J, T = SEMIRINGS[name]
    rng = np.random.default_rng(2)
    arc = _arc_inputs(name, rng, labeled=mode == "labeled")
    multiroot = mode == "multiroot"
    lens = LENGTHS
    jv, _ = jdeptree.deptree_inside(_to(arc, jnp.asarray), jnp.asarray(lens), J,
                                    multiroot=multiroot)
    tarc = _to(arc, lambda v: torch.from_numpy(v).requires_grad_(True))
    tv, _ = tdeptree.deptree_inside(tarc, torch.from_numpy(lens), T, multiroot=multiroot)
    close(tv, jv, 1e-5, "value")
    if name not in WITH_GRAD:
        return

    def jtotal(a):
        x = [a] + list(_to(arc, jnp.asarray))[1:] if isinstance(arc, list) else a
        v, _ = jdeptree.deptree_inside(x, jnp.asarray(lens), J, multiroot=multiroot)
        return J.unconvert(v).sum()

    want = jax.grad(jtotal)(jnp.asarray(_grad_target(arc)))
    T.unconvert(tv).sum().backward()
    close(_grad_target(tarc).grad, want, 1e-5, "d/d arc")


# -- oracles ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_dmv_fill_matches_bruteforce(n):
    """Partition, entropy and count of one sentence against the enumeration
    of its trees."""
    rng = np.random.default_rng(10 + n)
    dec = rng.standard_normal((n, 2, 2, 2))
    attach = rng.standard_normal((n, n, 2))
    root = rng.standard_normal(n)
    md, ma = dmv_merge(*(torch.from_numpy(x[None].astype(np.float32))
                         for x in (dec, attach, root)))
    lens = torch.tensor([n])
    np.testing.assert_allclose(
        tdmv.dmv_partition(md, ma, lens, ts.LogSemiring).numpy()[0],
        oracles.brute_dmv(dec, attach, root, n), rtol=1e-5)
    scores = [oracles.score_dmv(dec, attach, root, h) for h in oracles.all_trees(n)]
    np.testing.assert_allclose(
        tdmv.dmv_partition(md, ma, lens, ts.EntropySemiring).numpy()[0],
        oracles.brute_entropy(scores), rtol=1e-4, atol=1e-5)
    ones = [torch.where(x <= -5e11, 0.0, 1.0) for x in (md, ma)]
    assert tdmv.dmv_partition(*ones, lens, ts.StdSemiring).item() == len(scores)


@pytest.mark.parametrize("multiroot", [False, True])
def test_deptree_fill_matches_bruteforce(multiroot):
    rng = np.random.default_rng(20)
    n = 4
    arc = rng.standard_normal((n + 1, n + 1))
    lens = torch.tensor([n])
    trees = list(oracles.all_trees(n, single_root=not multiroot))
    scores = [oracles.score_deptree(arc, h) for h in trees]
    t = torch.from_numpy(arc[None].astype(np.float32))
    np.testing.assert_allclose(
        tdeptree.deptree_partition(t, lens, ts.LogSemiring, multiroot).numpy()[0],
        oracles.logsumexp(scores), rtol=1e-5)
    np.testing.assert_allclose(
        tdeptree.deptree_partition(t, lens, ts.EntropySemiring, multiroot).numpy()[0],
        oracles.brute_entropy(scores), rtol=1e-4, atol=1e-5)
    count = tdeptree.deptree_partition(torch.ones_like(t), lens, ts.StdSemiring, multiroot)
    assert count.item() == len(trees)


# -- the generic fills against the kernels' plain versions ----------------------


@pytest.mark.parametrize("kind", ["log", "max"])
def test_generic_totals_equal_the_plain_versions(kind):
    rng = np.random.default_rng(3)
    md, ma = (torch.from_numpy(x) for x in _dmv_inputs(kind, rng))
    lens = torch.from_numpy(LENGTHS)
    S = ts.LogSemiring if kind == "log" else ts.MaxSemiring
    np.testing.assert_allclose(tdmv.dmv_partition(md, ma, lens, S).numpy(),
                               tdmv.dmv_total(md, ma, lens, kind).numpy(),
                               rtol=1e-6, atol=1e-6)
    gd, ga = tdmv.dmv_marginals(md, ma, lens, S)
    _, pd, pa = tdmv.dmv_value_and_grads_plain(md, ma, lens, kind)
    np.testing.assert_allclose(gd.numpy(), pd.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), pa.numpy(), rtol=1e-6, atol=1e-6)
    for multiroot in (False, True):
        arc = torch.from_numpy(_arc_inputs(kind, rng))
        np.testing.assert_allclose(
            tdeptree.deptree_partition(arc, lens, S, multiroot).numpy(),
            tdeptree.deptree_partition(arc, lens, kind, multiroot).numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tdeptree.deptree_marginals(arc, lens, S, multiroot).numpy(),
            tdeptree.deptree_marginals(arc, lens, kind, multiroot).numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["log", "entropy", "kmax"])
def test_remat_gives_equal_values_and_gradients(name):
    _, T = SEMIRINGS[name]
    rng = np.random.default_rng(4)
    md, ma = _dmv_inputs(name, rng)
    arc = _arc_inputs(name, rng)
    lens = torch.from_numpy(LENGTHS)
    got = []
    for remat in (False, True):
        d, a, r = (torch.from_numpy(x).requires_grad_(True) for x in (md, ma, arc))
        v1, _ = tdmv.dmv_inside(d, a, lens, T, remat=remat)
        v2, _ = tdeptree.deptree_inside(r, lens, T, remat=remat)
        (T.unconvert(v1).sum() + T.unconvert(v2).sum()).backward()
        got.append([v1.detach(), v2.detach(), d.grad, a.grad, r.grad])
    for x, y in zip(*got):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
