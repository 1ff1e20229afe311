"""The port's host decoders (vlgae_tpu_torch.struct.alg, NumPy) on the cases
of tests/test_alg.py and against vlgae_tpu.struct.alg on random scores.

Heads must be equal; the grandparent log-partition within 1e-12 relative
(the same float64 arithmetic). First-order Eisner with backtracking is also
held against the port's ``DependencyCRF.argmax_heads`` where the best tree
wins by at least 1e-3.
"""

import itertools

import numpy as np
import pytest
import torch

import oracles
from test_torch_deptree import MARGIN, eisner_margins
from vlgae_tpu.struct import alg as jalg
from vlgae_tpu_torch.struct import DependencyCRF
from vlgae_tpu_torch.struct import alg


def test_eisner_matches_the_crf_argmax():
    rng = np.random.default_rng(1)
    ns = [3, 5, 2, 4, 0, 1]
    arc = rng.standard_normal((len(ns), max(ns) + 1, max(ns) + 1))
    lengths = np.array(ns)
    got = alg.eisner(arc, lengths)
    crf = DependencyCRF(torch.tensor(arc, dtype=torch.float32), torch.tensor(lengths))
    want = crf.argmax_heads.numpy()
    won = eisner_margins(arc, lengths, want) >= MARGIN
    assert won.all()
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(got[b, 1:n + 1], want[b, :n])


def test_eisner2o_zero_sibling_equals_first_order():
    rng = np.random.default_rng(2)
    ns = [4, 3, 5]
    B, n_max = len(ns), max(ns)
    arc_hc = rng.standard_normal((B, n_max + 1, n_max + 1))
    sib = np.zeros((B, n_max + 1, n_max + 1, n_max + 1))
    lengths = np.array(ns)
    got = alg.eisner2o((arc_hc.transpose(0, 2, 1), sib), lengths)
    want = alg.eisner(arc_hc, lengths)
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(got[b, 1:n + 1], want[b, 1:n + 1])


def test_eisner2o_sibling_scores_bruteforce():
    rng = np.random.default_rng(3)
    n = 4
    arc = rng.standard_normal((1, n + 1, n + 1))  # [d, h]
    sib = rng.standard_normal((1, n + 1, n + 1, n + 1))

    def score(heads):
        s = sum(arc[0, d, h] for d, h in enumerate(heads, 1))
        for h in range(n + 1):
            kids = [d for d, hh in enumerate(heads, 1) if hh == h]
            left = sorted([d for d in kids if d < h], reverse=True)
            right = sorted([d for d in kids if d > h])
            for seq in (left, right):
                for a, b in zip(seq, seq[1:]):
                    s += sib[0, b, h, a]
        return s

    best = max(score(heads) for heads in oracles.all_trees(n))
    got = alg.eisner2o((arc, sib), np.array([n]))[0]
    np.testing.assert_allclose(score(list(got[1:])), best, rtol=1e-9)


def test_mst_bruteforce():
    rng = np.random.default_rng(4)
    n = 4
    s = rng.standard_normal((n + 1, n + 1))
    got = alg.chuliu_edmonds(s)
    best = max(sum(s[h, d] for d, h in enumerate(heads, 1))
               for heads in itertools.product(range(n + 1), repeat=n)
               if oracles.is_spanning([0] + list(heads)))
    np.testing.assert_allclose(sum(s[h, d] for d, h in enumerate(got, 1)), best,
                               rtol=1e-9)


def test_predicates():
    assert alg.isprojective([2, 0, 2])
    assert not alg.isprojective([2, -1, 1])
    assert not alg.isprojective([3, -1, 2])
    assert alg.istree([2, 0, 2], proj=True)
    assert not alg.istree([2, 3, 1])  # cycle
    assert not alg.istree([0, 0, 1], multiroot=False)
    assert alg.istree([0, 0, 1], multiroot=True)


@pytest.mark.parametrize("seed", range(3))
def test_decoders_match_jax_on_random_scores(seed):
    rng = np.random.default_rng(10 + seed)
    ns = np.array([6, 1, 4, 0, 7])
    n1 = ns.max() + 1
    arc = rng.standard_normal((len(ns), n1, n1))
    sib = rng.standard_normal((len(ns), n1, n1, n1))
    grand = rng.standard_normal((len(ns), n1, n1, n1))
    np.testing.assert_array_equal(alg.eisner(arc, ns), jalg.eisner(arc, ns))
    np.testing.assert_array_equal(alg.eisner2o((arc, sib), ns),
                                  jalg.eisner2o((arc, sib), ns))
    np.testing.assert_array_equal(alg.mst(arc, ns), jalg.mst(arc, ns))
    keep = ns > 0  # the grandparent chart needs a word
    np.testing.assert_allclose(alg.eisner2o_grand((arc[keep], grand[keep]), ns[keep]),
                               jalg.eisner2o_grand((arc[keep], grand[keep]), ns[keep]),
                               rtol=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_predicates_and_components_match_jax_on_random_heads(seed):
    rng = np.random.default_rng(20 + seed)
    for _ in range(50):
        n = int(rng.integers(1, 8))
        heads = rng.integers(-1 if seed == 0 else 0, n + 1, n).tolist()
        assert alg.isprojective(heads) == jalg.isprojective(heads)
        for proj, multiroot in itertools.product((False, True), repeat=2):
            assert alg.istree(heads, proj, multiroot) == jalg.istree(heads, proj, multiroot)
        if min(heads) >= 0:
            assert alg.tarjan(heads) == jalg.tarjan(heads)
