"""The port's samplers and sparsemax (vlgae_tpu_torch/struct/sample.py)
against vlgae_tpu and tests/test_sampling.py's checks.

Samples are projective trees; their frequencies match the marginals
(atol 0.07 over 800 samples); chunks past 16 samples are independent; a
chunk of 16 costs one inside pass and its packed gradient is exact integers
(each sample passes a chart cell once). ``project_simplex`` and the
sparsemax fill and gradient agree with vlgae_tpu within 1e-6. The routing
of one reduction is held to JAX's own backward functions on JAX's own
draws: the multi-sample routing exactly, given the uniforms
``jax.random.uniform`` draws from the key; the straight-through Gumbel
routing within 1e-6, given ``jax.random.gumbel``'s noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.struct import sample as jsample
from vlgae_tpu.struct.deptree import deptree_inside as j_deptree_inside
from vlgae_tpu_torch.struct import DependencyCRF, DMV1o, dmv_merge
from vlgae_tpu_torch.struct import sample as tsample
from vlgae_tpu_torch.struct.alg import istree
from vlgae_tpu_torch.struct.deptree import deptree_inside


def _crf(seed, n, lengths):
    arc = np.random.default_rng(seed).standard_normal(
        (len(lengths), n + 1, n + 1)).astype(np.float32)
    return DependencyCRF(torch.from_numpy(arc), torch.tensor(lengths))


def _check_trees(ind, lengths):
    for k in range(ind.shape[0]):
        for b, ln in enumerate(lengths):
            cols = ind[k, b, :, 1:ln + 1]
            np.testing.assert_array_equal(cols.sum(0), 1.0)
            assert istree(list(np.argmax(cols, 0)), proj=True)


def test_deptree_samples_are_valid_trees():
    dist = _crf(0, 4, [4, 3])
    s = dist.sample(torch.Generator().manual_seed(0), num_samples=20).numpy()
    assert s.shape == (20, 2, 5, 5)
    _check_trees(s, [4, 3])


def test_deptree_sample_distribution_matches_marginals():
    dist = _crf(1, 3, [3])
    s = dist.sample(torch.Generator().manual_seed(1), num_samples=800).numpy()
    freq = s.mean(0)[0]
    want = dist.marginals.numpy()[0]
    np.testing.assert_allclose(freq[:4, 1:4], want[:4, 1:4], atol=0.07)


def test_dmv_samples_valid():
    rng = np.random.default_rng(2)
    dec, attach, root = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                         for s in ((1, 4, 2, 2, 2), (1, 4, 4, 2), (1, 4)))
    dist = DMV1o(dmv_merge(dec, attach, root), torch.tensor([4]))
    s = dist.sample(torch.Generator().manual_seed(2), num_samples=10).numpy()
    assert s.shape == (10, 1, 5, 5, 2)
    _check_trees(s.sum(-1), [4])


def test_gumbel_crf_relaxed_sample():
    dist = _crf(3, 3, [3])
    g = dist.gumbel_crf(torch.Generator().manual_seed(3), temperature=1.0).numpy()
    # straight-through forward values behave like hard indicators
    np.testing.assert_allclose(g[0][:, 1:4].sum(0), 1, atol=1e-4)


def test_project_simplex_matches_jax():
    v = np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32)
    for axis in (-1, 0):
        w = tsample.project_simplex(torch.from_numpy(v), axis=axis).numpy()
        want = np.asarray(jsample.project_simplex(jnp.asarray(v), axis=axis))
        np.testing.assert_allclose(w, want, rtol=1e-6, atol=1e-6)
        assert np.all(w >= 0)
        np.testing.assert_allclose(w.sum(axis), 1.0, rtol=1e-5)
    d = np.random.default_rng(5).standard_normal((5, 7)).astype(np.float32)
    w = tsample.project_simplex(torch.from_numpy(v))
    np.testing.assert_allclose(
        tsample.sparsemax_grad(torch.from_numpy(d), w, -1).numpy(),
        np.asarray(jsample.sparsemax_grad(jnp.asarray(d), jnp.asarray(w.numpy()), -1)),
        rtol=1e-6, atol=1e-6)


def test_sparsemax_dp_matches_jax():
    arc = np.random.default_rng(5).standard_normal((2, 4, 4)).astype(np.float32)
    lens = np.array([3, 2])
    t = torch.from_numpy(arc).requires_grad_(True)
    v, _ = deptree_inside(t, torch.from_numpy(lens), tsample.SparseMaxSemiring)
    jv, _ = j_deptree_inside(jnp.asarray(arc), jnp.asarray(lens), jsample.SparseMaxSemiring)
    np.testing.assert_allclose(v[0].detach().numpy(), np.asarray(jv[0]), rtol=1e-6, atol=1e-6)
    assert np.isfinite(v.detach().numpy()).all()
    v[0].sum().backward()

    def jtotal(a):
        return j_deptree_inside(a, jnp.asarray(lens), jsample.SparseMaxSemiring)[0][0].sum()

    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jax.grad(jtotal)(jnp.asarray(arc))),
                               rtol=1e-6, atol=1e-6)


def test_multi_sample_chunks_are_independent_and_cost_one_pass_each():
    dist = _crf(4, 4, [4])
    calls = []
    inside = dist._inside
    dist._inside = lambda *a, **k: calls.append(1) or inside(*a, **k)
    s = dist.sample(torch.Generator().manual_seed(5), num_samples=24).numpy()
    assert s.shape[0] == 24 and len(calls) == 2  # ceil(24 / 16) inside passes
    assert not np.allclose(s[:16].mean(0), s[16:].mean(0), atol=1e-12) \
        or not np.allclose(s[0], s[16])


def test_packed_gradient_is_exact_integers():
    """One 16-sample chunk at 30 words: the packed gradient is an integer
    below 2^16 in every cell, so the bits decode without carries."""
    from vlgae_tpu_torch.struct.sample import MultiSampledSemiring

    dist = _crf(6, 30, [30, 17])
    S = MultiSampledSemiring(torch.Generator().manual_seed(6), 16)
    a = dist.arc.clone().requires_grad_(True)
    val = S.unconvert(dist._inside(S, a))
    (packed,) = torch.autograd.grad(val, a, grad_outputs=torch.full_like(val, 2.0 ** 16 - 1))
    p = packed.numpy()
    np.testing.assert_array_equal(p, np.round(p))
    assert p.min() >= 0 and p.max() < 2 ** 16
    # every sample gives each word of a sentence one head
    bits = (p.astype(np.int64)[None] >> np.arange(16)[:, None, None, None]) & 1
    for b, n in enumerate([30, 17]):
        np.testing.assert_array_equal(bits[:, b, :, 1:n + 1].sum(1), 1)


# -- routing of one reduction against JAX's backward on JAX's draws --------------


@pytest.mark.parametrize("axis", [0, -1])
def test_multi_sample_routing_matches_jax(axis):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 5, 4)).astype(np.float32)
    k = 5
    g_shape = np.delete(np.array(x.shape), axis % 3)
    g = rng.integers(0, 2 ** k, size=tuple(g_shape)).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(0), 3)
    want, _ = jsample._multi_bwd(axis % 3, k, (jnp.asarray(x), key), jnp.asarray(g))
    moved_shape = np.moveaxis(x, axis, -1).shape
    u = jax.random.uniform(key, (k,) + moved_shape[:-1], dtype=jnp.float32)
    got = tsample.multi_route(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(np.array(u)), axis % 3, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temp", [1.0, 0.5])
def test_gumbel_routing_matches_jax(temp):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 4, 6)).astype(np.float32)
    g = rng.standard_normal((3, 6)).astype(np.float32)
    axis = 1
    key = jax.random.fold_in(jax.random.key(1), 2)
    want, _ = jsample._gumbel_bwd(axis, temp, (jnp.asarray(x), key), jnp.asarray(g))
    noise = jax.random.gumbel(key, np.moveaxis(x, axis, -1).shape, dtype=jnp.float32)
    got = tsample.gumbel_route(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(np.array(noise)), axis, temp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sampled_semiring_gives_one_tree_per_backward():
    """The one-sample semiring: the gradient of the total is a tree."""
    dist = _crf(9, 5, [5, 2])
    S = tsample.SampledSemiring(torch.Generator().manual_seed(9))
    a = dist.arc.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(S.unconvert(dist._inside(S, a)).sum(), a)
    _check_trees(g.numpy()[None], [5, 2])
