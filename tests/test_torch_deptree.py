"""The port's Eisner CRF (vlgae_tpu_torch.struct.deptree, DependencyCRF)
against vlgae_tpu.

The same numpy-seeded potentials go through ``vlgae_tpu.struct.deptree`` /
``DependencyCRF`` (on the CPU: the pure Eisner fill) and through the port:
its plain Eisner fill (single- and multi-root) and its single-root route
through the DMV DP with free decisions (``eisner_as_dmv``; the plain
version of the fused kernel K1 here). Totals and marginals to 1e-5
(absolute and relative), matrix-tree partition and marginals to 1e-5.
Heads are compared where the best tree wins by at least ``MARGIN`` (the
gap to the best tree that differs in one arc or more, :func:`tree_margins`)
and must form a projective tree everywhere. The card's kernels on Eisner
potentials are tested in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.struct import DependencyCRF as JaxCRF
from vlgae_tpu.struct import LogSemiring, MaxSemiring
from vlgae_tpu.struct import deptree as jdt
from vlgae_tpu_torch.struct import (NEGINF, DependencyCRF, deptree_grads_fast,
                                    deptree_marginals, deptree_nonproj_marginals,
                                    deptree_nonproj_partition, deptree_partition,
                                    deptree_total_fast, dmv_total, eisner_as_dmv)
from vlgae_tpu_torch.struct import distributions as tdist
from vlgae_tpu_torch.struct.alg import istree

TOL = 1e-5
MARGIN = 1e-3
SEMIRING = {"log": LogSemiring, "max": MaxSemiring}
CASES = {
    # (lengths, n1): ragged with a zero-length filler; full; one position
    "ragged": ((9, 3, 0, 1, 5, 7), 10),
    "full_12": ((11, 11, 11, 11), 12),
    "n1_1": ((0, 0), 1),
}


def _arc(case, seed=0, labels=0):
    lengths, n1 = CASES[case]
    rng = np.random.default_rng(seed)
    shape = (len(lengths), n1, n1) + ((labels,) if labels else ())
    return (rng.standard_normal(shape).astype(np.float32),
            np.asarray(lengths, np.int32))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def tree_margins(total_without, heads, lengths, best):
    """Per sentence, the best tree's score minus that of the best tree that
    differs from it in one arc or more: the largest total with one of the
    best tree's arcs removed. ``total_without(cols_heads, k)`` returns the
    totals ``[B]`` with arc ``heads[b, k-1] -> k`` removed in every
    sentence. Sentences with one tree (or none) get ``inf``."""
    heads, lengths = np.asarray(heads), np.asarray(lengths)
    second = np.full(len(lengths), -np.inf)
    for k in range(1, heads.shape[1] + 1):
        t = np.asarray(total_without(heads[:, k - 1], k), np.float64)
        second = np.where(k <= lengths, np.maximum(second, t), second)
    return np.where(second > NEGINF / 2, np.asarray(best, np.float64) - second, np.inf)


def eisner_margins(arc, lengths, heads):
    """:func:`tree_margins` of the single-root Eisner CRF on ``arc``."""
    arc = torch.as_tensor(np.asarray(arc), dtype=torch.float32)
    lens = torch.as_tensor(np.asarray(lengths))
    rows = torch.arange(arc.shape[0])

    def without(h, k):
        a = arc.clone()
        a[rows, torch.as_tensor(np.array(h)).long(), k] = NEGINF
        return deptree_partition(a, lens, "max").numpy()

    return tree_margins(without, heads, lengths, deptree_partition(arc, lens, "max"))


def assert_trees(heads, lengths):
    """Every real sentence's heads form a single-root projective tree."""
    for h, n in zip(np.asarray(heads), np.asarray(lengths)):
        if n:
            assert istree(h[:n].tolist(), proj=True), h[:n]


@pytest.mark.parametrize("multiroot", [False, True])
@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fill_matches_jax(case, kind, multiroot):
    arc, lens = _arc(case)
    S = SEMIRING[kind]
    want = np.asarray(jdt.deptree_partition(jnp.asarray(arc), jnp.asarray(lens), S,
                                            multiroot))
    want_g = np.asarray(jdt.deptree_marginals(jnp.asarray(arc), jnp.asarray(lens), S,
                                              multiroot))
    got = deptree_partition(*_t(arc, lens), kind, multiroot)
    got_g = deptree_marginals(*_t(arc, lens), kind, multiroot)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("multiroot", [False, True])
@pytest.mark.parametrize("kind", ["log", "max"])
def test_labeled_arcs_match_jax(kind, multiroot):
    """A labeled ``[B, N1, N1, L]`` table: the total, its gradient by
    autograd, and the tables, which reach the labels (softmax weights in
    log, the maximal label's indicator in max)."""
    arc, lens = _arc("ragged", seed=1, labels=3)
    name = "partition" if kind == "log" else "max"
    table = "marginals" if kind == "log" else "argmax"
    jcrf = JaxCRF(jnp.asarray(arc), jnp.asarray(lens), multiroot)
    want_g = jax.grad(lambda a: getattr(JaxCRF(a, jnp.asarray(lens), multiroot),
                                        name).sum())(jnp.asarray(arc))
    a = torch.tensor(arc, requires_grad=True)
    total = getattr(DependencyCRF(a, torch.tensor(lens), multiroot), name)
    total.sum().backward()
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(getattr(jcrf, name)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_g), rtol=TOL, atol=TOL)
    got_t = getattr(DependencyCRF(torch.tensor(arc), torch.tensor(lens), multiroot), table)
    assert got_t.shape == arc.shape
    np.testing.assert_allclose(got_t.numpy(), np.asarray(getattr(jcrf, table)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("multiroot", [False, True])
def test_labeled_max_splits_label_ties_like_jax(multiroot):
    """Labels 0 and 1 tie exactly and are maximal on every arc: the max
    semiring's gradient and ``argmax`` table give each half the arc's
    indicator, as ``jnp.max``'s gradient does, on the single-root DMV
    route and on the multiroot plain fill."""
    arc, lens = _arc("ragged", seed=2, labels=3)
    arc[..., 1] = arc[..., 0]
    arc[..., 2] = arc[..., 0] - 1.0
    want = np.asarray(JaxCRF(jnp.asarray(arc), jnp.asarray(lens), multiroot).argmax)
    want_g = jax.grad(lambda a: JaxCRF(a, jnp.asarray(lens), multiroot).max.sum())(
        jnp.asarray(arc))
    a = torch.tensor(arc, requires_grad=True)
    DependencyCRF(a, torch.tensor(lens), multiroot).max.sum().backward()
    got = DependencyCRF(torch.tensor(arc), torch.tensor(lens), multiroot).argmax
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_g), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.all(got.numpy()[..., 2] == 0)
    np.testing.assert_array_equal(got.numpy()[..., 0], got.numpy()[..., 1])
    assert set(np.unique(got.numpy()[..., 0])) <= {0.0, 0.5}


@pytest.mark.parametrize("n", [1, 4, 7])
def test_matrix_tree_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n, n)).astype(np.float32)
    np.testing.assert_allclose(deptree_nonproj_partition(torch.tensor(x)).numpy(),
                               np.asarray(jdt.deptree_nonproj_partition(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(deptree_nonproj_marginals(torch.tensor(x)).numpy(),
                               np.asarray(jdt.deptree_nonproj_marginals(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_crf_through_the_dmv_matches_the_plain_fill(case, kind):
    """The single-root CRF's route through the DMV DP (free decisions, the
    arc in both valences) computes the Eisner fill's function."""
    arc, lens = _t(*_arc(case, seed=2))
    crf = DependencyCRF(arc, lens)
    total = crf.partition if kind == "log" else crf.max
    table = crf.marginals if kind == "log" else crf.argmax
    np.testing.assert_allclose(total.numpy(), deptree_partition(arc, lens, kind).numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(table.numpy(), deptree_marginals(arc, lens, kind).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("multiroot", [False, True])
@pytest.mark.parametrize("case", ["ragged", "full_12"])
def test_crf_matches_jax(case, multiroot):
    arc, lens = _arc(case, seed=3)
    jcrf = JaxCRF(jnp.asarray(arc), jnp.asarray(lens), multiroot)
    crf = DependencyCRF(*_t(arc, lens), multiroot)
    for name in ("partition", "max", "marginals", "argmax"):
        np.testing.assert_allclose(getattr(crf, name).numpy(),
                                   np.asarray(getattr(jcrf, name)), rtol=TOL, atol=TOL,
                                   err_msg=name)
    want = np.asarray(jcrf.argmax_heads)
    got = crf.argmax_heads.numpy()
    if not multiroot:
        won = eisner_margins(arc, lens, want) >= MARGIN
        assert won.sum() >= len(lens) - 1
        np.testing.assert_array_equal(got[won], want[won])
        assert_trees(got, lens)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(crf.log_prob(torch.tensor(want)).numpy(),
                               np.asarray(jcrf.log_prob(jnp.asarray(want))),
                               rtol=TOL, atol=TOL)


def test_heads_of_pad_rows_and_columns_past_a_length_are_zero():
    """JAX takes ``argmax`` over masked zeros there: head 0."""
    arc, lens = _arc("ragged", seed=4)
    got = DependencyCRF(*_t(arc, lens)).argmax_heads.numpy()
    want = np.asarray(JaxCRF(jnp.asarray(arc), jnp.asarray(lens)).argmax_heads)
    for h, w, n in zip(got, want, lens):
        assert (h[n:] == 0).all() and (w[n:] == 0).all()


def test_eisner_as_dmv_scores_a_tree_by_its_arcs():
    """With free decisions and both valences equal, the DMV's best total is
    the Eisner best total, and the root's HASCHILD channel is closed."""
    arc, lens = _t(*_arc("ragged", seed=5))
    dec, attach = eisner_as_dmv(arc)
    assert bool((dec == 0).all())
    assert bool((attach[:, 0, :, 0] == NEGINF).all())
    assert torch.equal(attach[:, 1:, :, 0], arc[:, 1:])
    assert torch.equal(attach[..., 1], arc)
    np.testing.assert_allclose(dmv_total(dec, attach, lens, "max").numpy(),
                               deptree_partition(arc, lens, "max").numpy(), rtol=0, atol=TOL)


def test_tables_sum_the_valences_and_drop_dec_and_the_root_haschild(monkeypatch):
    """d/d arc is the sum of the attach table's two valence channels; the
    dec table and the root row's HASCHILD channel are discarded."""
    B, n1 = 2, 4
    ga = torch.arange(B * n1 * n1 * 2, dtype=torch.float32).view(B, n1, n1, 2)
    gd = torch.full((B, n1, 2, 2, 2), 1e6)
    monkeypatch.setattr(tdist, "dmv_value_and_grads",
                        lambda d, a, lens, kind: (torch.zeros(B), gd, ga))
    got = deptree_grads_fast(torch.zeros(B, n1, n1), torch.full((B,), 3), "log")
    want = ga.sum(-1)
    want[:, 0] = ga[:, 0, :, 1]
    assert torch.equal(got, want)


def test_totals_take_the_dmv_dispatch_by_what_is_needed(monkeypatch):
    """A gradient wanted: the chart-saving pair (``DMVTotalFn``); none: the
    value-only pass; multiroot: the plain fill, on any device."""
    calls = []
    real_fn, real_fast = tdist.DMVTotalFn.apply, tdist.dmv_total_fast
    monkeypatch.setattr(tdist.DMVTotalFn, "apply",
                        lambda *a: calls.append("pair") or real_fn(*a))
    monkeypatch.setattr(tdist, "dmv_total_fast",
                        lambda *a: calls.append("value") or real_fast(*a))
    arc, lens = _t(*_arc("ragged", seed=6))
    a = arc.clone().requires_grad_(True)
    deptree_total_fast(a, lens, "log").sum().backward()
    assert calls == ["pair"]
    np.testing.assert_allclose(a.grad.numpy(), DependencyCRF(arc, lens).marginals.numpy(),
                               rtol=TOL, atol=TOL)
    deptree_total_fast(arc, lens, "max")
    assert calls == ["pair", "value"]
    deptree_total_fast(a, lens, "log", multiroot=True)
    assert calls == ["pair", "value"]


@pytest.mark.parametrize("method", ["entropy", "count", "kl", "cross_entropy", "risk",
                                    "kmax", "topk", "sample", "gumbel_crf"])
def test_semiring_methods_name_their_slice(method):
    crf = DependencyCRF(*_t(*_arc("ragged")))
    with pytest.raises(NotImplementedError, match="semiring slice"):
        attr = getattr(crf, method)
        attr(None)
