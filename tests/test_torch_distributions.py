"""The port's ``DMV1o`` and ``DependencyCRF`` methods against vlgae_tpu's.

The same numpy-seeded potentials (B = 3, lengths 5/3/1) go through both
packages. Entropy, cross-entropy, KL and risk (the expectation semirings)
are held within 1e-4 relative (1e-5 absolute); counts, k-max scores and the
top-k indicators within 1e-5. The potentials are continuous draws, so no
two trees tie and the order of ``torch.topk`` and ``lax.top_k`` among equal
values does not enter. Samples and Gumbel relaxations come from different
random streams in the two packages: here they are held to their shapes and
to being trees (the routing itself is held to JAX's in
tests/test_torch_sample.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles

from vlgae_tpu.struct import DependencyCRF as JCRF
from vlgae_tpu.struct import DMV1o as JDMV
from vlgae_tpu.struct.alg import istree
from vlgae_tpu_torch.struct import DependencyCRF, DMV1o, dmv_merge

LENGTHS = np.array([5, 3, 1])
EXPECT = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    both = (got < -1e8) & (want < -1e8)  # the k-max semiring zero past the trees
    np.testing.assert_allclose(np.where(both, 0.0, got), np.where(both, 0.0, want), **tol)


def close_topk(got, want, counts):
    """Top-k indicators of the trees each sentence has: channel ``i`` of
    sentence ``b`` counts where ``i`` is below its number of trees (a
    channel past them holds the semiring zero, and its gradient follows
    ties among those values)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    for b, n in enumerate(_np(counts)):
        k = min(got.shape[0], int(n))
        np.testing.assert_allclose(got[:k, b], want[:k, b], **EXACT)


def _dmv_pair(seed):
    """(JAX DMV1o, port DMV1o) on the same merged potentials."""
    rng = np.random.default_rng(seed)
    B, N = 3, 5
    dec = rng.standard_normal((B, N, 2, 2, 2)).astype(np.float32)
    attach = rng.standard_normal((B, N, N, 2)).astype(np.float32)
    root = rng.standard_normal((B, N)).astype(np.float32)
    for b, n in enumerate(LENGTHS):
        attach[b, n:] = attach[b, :, n:] = -1e12
        root[b, n:] = -1e12
    md, ma = dmv_merge(*(torch.from_numpy(x) for x in (dec, attach, root)))
    lens = torch.from_numpy(LENGTHS)
    return (JDMV((jnp.asarray(md.numpy()), jnp.asarray(ma.numpy())), jnp.asarray(LENGTHS)),
            DMV1o((md, ma), lens))


def _crf_pair(seed, multiroot=False, labeled=False):
    rng = np.random.default_rng(seed)
    arc = rng.standard_normal((3, 6, 6) + ((2,) if labeled else ())).astype(np.float32)
    return (JCRF(jnp.asarray(arc), jnp.asarray(LENGTHS), multiroot=multiroot),
            DependencyCRF(torch.from_numpy(arc), torch.from_numpy(LENGTHS),
                          multiroot=multiroot))


def test_dmv_methods_match_jax():
    j, t = _dmv_pair(0)
    jq, tq = _dmv_pair(1)
    close(t.entropy, j.entropy, EXPECT)
    close(t.cross_entropy(tq), j.cross_entropy(jq), EXPECT)
    close(t.kl(tq), j.kl(jq), EXPECT)
    close(t.count, j.count, EXACT)
    np.testing.assert_array_equal(
        _np(t.count), [len(list(oracles.all_trees(int(n)))) for n in LENGTHS])
    close(t.kmax(4), j.kmax(4), EXACT)
    close_topk(t.topk(3), j.topk(3), t.count)
    # the best of the k-max is the max, and its tree the argmax
    close(t.kmax(4)[0], t.max, EXACT)
    close(t.topk(3)[0], t.argmax, EXACT)


@pytest.mark.parametrize("multiroot,labeled", [(False, False), (True, False),
                                                (False, True)])
def test_crf_methods_match_jax(multiroot, labeled):
    j, t = _crf_pair(2, multiroot, labeled)
    jq, tq = _crf_pair(3, multiroot, labeled)
    close(t.entropy, j.entropy, EXPECT)
    close(t.count, j.count, EXACT)
    close(t.kmax(4), j.kmax(4), EXACT)
    close_topk(t.topk(3), j.topk(3), t.count)
    if not labeled:
        close(t.cross_entropy(tq), j.cross_entropy(jq), EXPECT)
        close(t.kl(tq), j.kl(jq), EXPECT)
        cost = np.random.default_rng(4).random((3, 6, 6)).astype(np.float32)
        close(t.risk(torch.from_numpy(cost)), j.risk(jnp.asarray(cost)), EXPECT)
    close(t.kmax(4)[0], t.max, EXACT)


def _heads_are_trees(ind, lengths, multiroot=False):
    """``ind [k, B, N1, N1]`` arc indicators: each word one head, and the
    heads a projective tree."""
    for k in range(ind.shape[0]):
        for b, n in enumerate(lengths):
            cols = ind[k, b, :, 1:n + 1]
            np.testing.assert_allclose(cols.sum(0), 1.0, atol=1e-6)
            heads = np.argmax(cols, 0)
            if n and not multiroot:
                assert istree(list(heads), proj=True), heads


def test_dmv_sample_and_gumbel_match_jax_in_shape_and_are_trees():
    j, t = _dmv_pair(5)
    g = torch.Generator().manual_seed(0)
    s = t.sample(g, num_samples=20)
    assert s.shape == j.sample(jax.random.key(0), num_samples=20).shape
    assert set(np.unique(_np(s))) <= {0.0, 1.0}
    _heads_are_trees(_np(s).sum(-1), LENGTHS)
    relaxed = t.gumbel_crf(g)
    assert relaxed.shape == j.gumbel_crf(jax.random.key(0)).shape
    # the straight-through forward values are a hard tree
    _heads_are_trees(_np(relaxed).sum(-1)[None], LENGTHS)


@pytest.mark.parametrize("multiroot", [False, True])
def test_crf_sample_and_gumbel_match_jax_in_shape_and_are_trees(multiroot):
    j, t = _crf_pair(6, multiroot)
    g = torch.Generator().manual_seed(1)
    s = t.sample(g, num_samples=18)
    assert s.shape == j.sample(jax.random.key(0), num_samples=18).shape == (18, 3, 6, 6)
    _heads_are_trees(_np(s), LENGTHS, multiroot)
    relaxed = t.gumbel_crf(g, temperature=0.5)
    assert relaxed.shape == (3, 6, 6)
    _heads_are_trees(_np(relaxed)[None], LENGTHS, multiroot)


def test_kernel_methods_stay_on_their_dispatch():
    """``partition``/``max``/``marginals``/``argmax`` keep the kernels'
    dispatch; the generic fill agrees with them."""
    from vlgae_tpu_torch.struct import LogSemiring, MaxSemiring, dmv_partition

    _, t = _dmv_pair(7)
    close(dmv_partition(t.dec, t.attach, t.lengths, LogSemiring), t.partition, EXACT)
    close(dmv_partition(t.dec, t.attach, t.lengths, MaxSemiring), t.max, EXACT)


def test_count_is_not_finite_where_f32_overflows_as_in_jax():
    """At 64 words the number of trees passes f32's range; a chart cell
    then meets 0 x inf, and the total is NaN in both packages."""
    n = 64
    ones = np.ones((1, n + 1, n + 1), np.float32)
    lens = np.array([n])
    got = _np(DependencyCRF(torch.from_numpy(ones), torch.from_numpy(lens)).count)
    want = np.asarray(JCRF(jnp.asarray(ones), jnp.asarray(lens)).count)
    assert not np.isfinite(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
