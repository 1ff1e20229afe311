"""The port's matching backward (vlgae_tpu_torch.ops.match:
``match_maxes_bwd_plain`` and ``MatchMaxesFn`` on the CPU) against
``jax.value_and_grad`` of vlgae_tpu's Pallas kernel in interpret mode,
with bias operands, at the shapes of tests/test_match_pallas.py.

Operands and cotangents are bf16-exact quarter-integers, so every product
and every f32 sum is exact: values and gradients must be EQUAL. The CUDA
kernel K6 is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.ops.match_pallas import match_maxes_pallas
from vlgae_tpu_torch.ops import match
from vlgae_tpu_torch.ops.match import (MatchMaxesFn, match_maxes_bwd,
                                       match_maxes_bwd_plain, match_maxes_plain)

# (A, V, B, Q, D): tests/test_match_pallas.py's blocked-grid and bias shapes
SHAPES = [(2, 16, 4, 64, 7), (2, 37, 8, 101, 10), (3, 10, 12, 33, 7),
          (2, 9, 4, 130, 5), (3, 10, 4, 5, 7)]


def _inputs(A, V, B, Q, D, seed=0):
    rng = np.random.default_rng(seed + Q * 31 + B)
    vis = (rng.integers(-8, 9, (A, V, D)) * 0.25).astype(np.float32)
    txt = (rng.integers(-8, 9, (B, Q, D)) * 0.25).astype(np.float32)
    vb = np.where(rng.random((A, V)) < 0.3, -1e9, 0.0).astype(np.float32)
    tb = np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0).astype(np.float32)
    wm = (rng.integers(-8, 9, (B, A, Q)) * 0.25).astype(np.float32)
    wmv = (rng.integers(-8, 9, (B, A, V)) * 0.25).astype(np.float32)
    return vis, txt, vb, tb, wm, wmv


def _jax_grads(vis, txt, vb, tb, wm, wmv):
    def loss(v, t):
        m, mv = match_maxes_pallas(v, t, True, jnp.asarray(vb), jnp.asarray(tb))
        return jnp.sum(m * wm) + jnp.sum(mv * wmv)

    _, (dvis, dtxt) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(vis, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16))
    return (np.asarray(dvis.astype(jnp.float32)),
            np.asarray(dtxt.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_autograd_match_pallas_interpret(shape):
    vis, txt, vb, tb, wm, wmv = _inputs(*shape)
    want_dvis, want_dtxt = _jax_grads(vis, txt, vb, tb, wm, wmv)

    v = torch.from_numpy(vis).bfloat16()
    t = torch.from_numpy(txt).bfloat16()
    _, li, _, lvi = match_maxes_plain(v, t, torch.from_numpy(vb), torch.from_numpy(tb))
    dvis, dtxt = match_maxes_bwd_plain(v, t, li, lvi, torch.from_numpy(wm),
                                       torch.from_numpy(wmv))
    assert dvis.dtype == dtxt.dtype == torch.bfloat16
    np.testing.assert_array_equal(dvis.float().numpy(), want_dvis)
    np.testing.assert_array_equal(dtxt.float().numpy(), want_dtxt)

    # the autograd function, as the model calls it (f32 features cast to bf16)
    vf = torch.from_numpy(vis).requires_grad_(True)
    tf = torch.from_numpy(txt).requires_grad_(True)
    before = match.launch_counts()["bwd"]
    m, _, mv, _ = MatchMaxesFn.apply(vf.bfloat16(), tf.bfloat16(),
                                     torch.from_numpy(vb), torch.from_numpy(tb))
    (m * torch.from_numpy(wm)).sum().add((mv * torch.from_numpy(wmv)).sum()).backward()
    assert match.launch_counts()["bwd"] == before  # the CPU takes the plain version
    np.testing.assert_array_equal(vf.grad.numpy(), want_dvis)
    np.testing.assert_array_equal(tf.grad.numpy(), want_dtxt)


def test_weight_rounds_after_the_two_directions_add():
    """A cell that wins both directions gets bf16(dm + dmv), not
    bf16(dm) + bf16(dmv); these two f32 cotangents round differently."""
    vis = torch.ones(1, 1, 1, dtype=torch.bfloat16)
    txt = torch.ones(1, 1, 1, dtype=torch.bfloat16)
    idx = torch.zeros(1, 1, 1, dtype=torch.int32)
    dm = torch.full((1, 1, 1), float.fromhex("0x1.1de51cp+0"))
    dmv = torch.full((1, 1, 1), float.fromhex("-0x1.e92802p-9"))
    dvis, dtxt = match_maxes_bwd_plain(vis, txt, idx, idx, dm, dmv)
    assert float(dvis) == float(dtxt) == 1.109375  # bf16(1.11304...)
    separate = (dm.bfloat16().float() + dmv.bfloat16().float()).bfloat16()
    assert float(separate) == 1.1171875


def test_none_cotangent_is_zero_and_biases_get_no_gradient():
    vis, txt, vb, tb, wm, _ = _inputs(2, 9, 3, 6, 4)
    vf = torch.from_numpy(vis).requires_grad_(True)
    vbt = torch.from_numpy(vb).requires_grad_(True)
    m, li, mv, lvi = MatchMaxesFn.apply(vf.bfloat16(), torch.from_numpy(txt).bfloat16(),
                                        vbt, torch.from_numpy(tb))
    assert not li.requires_grad and not lvi.requires_grad
    (m * torch.from_numpy(wm)).sum().backward()  # logit_v unused: zero cotangent
    want, _ = match_maxes_bwd(torch.from_numpy(vis).bfloat16(),
                              torch.from_numpy(txt).bfloat16(), li, lvi,
                              torch.from_numpy(wm), torch.zeros(mv.shape))
    np.testing.assert_array_equal(vf.grad.numpy(), want.float().numpy())
    assert vbt.grad is None


def test_meta_tensors_are_refused():
    v = torch.zeros(1, 2, 3, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        match_maxes_bwd(v, v, None, None, None, None)


def _sum_over_lists(vis, txt, li, lvi, dm, dmv):
    """(dvis, dtxt) summed over the plain winner lists the way K6 walks
    them: row (g, n) takes its O own positions, then its cross positions in
    list order, each position one bf16 weight times a partner row, added in
    f32 in position order."""
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    lists = match.match_bwd_lists_plain(li, lvi)
    bf16 = lambda x: x.bfloat16().float()  # noqa: E731
    # (owner rows N, partners O x M, own/cross tables [O, G, *], partner rows)
    sides = {"vis": (V, B, Q, lvi.long(), dmv, li.long(), dm, txt.float().reshape(B * Q, D)),
             "txt": (Q, A, V, li.long().transpose(0, 1), dm.transpose(0, 1),
                     lvi.long().transpose(0, 1), dmv.transpose(0, 1),
                     vis.float().reshape(A * V, D))}
    outs = []
    for side, (N, O, M, own_win, own_cot, cross_win, cross_cot, src) in sides.items():
        order, starts = lists["list_" + side], lists["starts_" + side]
        G = order.shape[0]
        T = int(starts[-1])
        p = torch.arange(T)
        r = torch.searchsorted(starts.long(), p, right=True) - 1
        g, n = r // (N + 1), r % (N + 1)
        k = p - starts.long()[r]
        real = n < N
        nn = n.clamp(max=N - 1)
        # own positions: o = k, m = own_win[o, g, n]
        o_own = k.clamp(max=O - 1)
        m_own = own_win[o_own, g, nn]
        w_own = own_cot[o_own, g, nn] + torch.where(
            cross_win[o_own, g, m_own] == nn, cross_cot[o_own, g, m_own], 0.0)
        # cross positions: e = o*M + m from the list
        e = order.flatten().long()[(p - (g * N + n + 1) * O).clamp(0, G * O * M - 1)]
        o_x, m_x = e // M, e % M
        w_x = torch.where(own_win[o_x, g, nn] != m_x, cross_cot[o_x, g, m_x], 0.0)
        own = k < O
        w = torch.where(real, bf16(torch.where(own, w_own, w_x)), 0.0)
        partner = torch.where(own, o_own * M + m_own, e)
        out = torch.zeros(G * N, D)
        lengths = starts.long().diff()
        for step in range(int(lengths.max())):
            at = (lengths > step) & (torch.arange(G * (N + 1)) % (N + 1) < N)
            rows = torch.nonzero(at).flatten()
            q = starts.long()[rows] + step
            dst = (rows // (N + 1)) * N + rows % (N + 1)
            out[dst] += w[q, None] * src[partner[q]]
        outs.append(out.view(G, N, D).bfloat16())
    return tuple(outs)


@pytest.mark.parametrize("shape", SHAPES)
def test_sums_over_the_winner_lists_equal_plain_and_pallas_interpret(shape):
    """K6's lists, summed in K6's order, give the plain version's gradients
    and the Pallas kernel's (interpret mode) exactly on quarter-integers."""
    vis, txt, vb, tb, wm, wmv = _inputs(*shape)
    want_dvis, want_dtxt = _jax_grads(vis, txt, vb, tb, wm, wmv)
    v = torch.from_numpy(vis).bfloat16()
    t = torch.from_numpy(txt).bfloat16()
    _, li, _, lvi = match_maxes_plain(v, t, torch.from_numpy(vb), torch.from_numpy(tb))
    dm, dmv = torch.from_numpy(wm), torch.from_numpy(wmv)
    dvis, dtxt = _sum_over_lists(v, t, li, lvi, dm, dmv)
    plain = match_maxes_bwd_plain(v, t, li, lvi, dm, dmv)
    assert torch.equal(dvis, plain[0]) and torch.equal(dtxt, plain[1])
    np.testing.assert_array_equal(dvis.float().numpy(), want_dvis)
    np.testing.assert_array_equal(dtxt.float().numpy(), want_dtxt)


def test_winner_lists_group_every_cell_by_its_owner_row_stably():
    """Each list is a permutation of its group's partner cells, ordered by
    the owner row their winner names and, within a row, ascending; the row
    starts count O own positions per row before it plus the cross entries;
    an index outside the rows goes to the group's last, unwritten row."""
    A, V, B, Q = 3, 7, 4, 5
    rng = np.random.default_rng(0)
    li = torch.tensor(rng.integers(0, V, (B, A, Q)), dtype=torch.int32)
    lvi = torch.tensor(rng.integers(0, Q, (B, A, V)), dtype=torch.int32)
    li[1, 2, 3] = -1
    lists = match.match_bwd_lists_plain(li, lvi)
    for side, keys, N, O in (("vis", li.permute(1, 0, 2).reshape(A, B * Q), V, B),
                             ("txt", lvi.reshape(B, A * V), Q, A)):
        order, starts = lists["list_" + side], lists["starts_" + side]
        G, cells = keys.shape
        assert order.dtype == starts.dtype == torch.int32
        assert starts.shape == (G * (N + 1) + 1,) and int(starts[-1]) == G * O * (N + cells // O)
        for g in range(G):
            assert sorted(order[g].tolist()) == list(range(cells))
            key = keys[g].long().where((keys[g] >= 0) & (keys[g] < N), torch.tensor(N))
            got = [(int(key[i]), int(i)) for i in order[g]]
            assert got == sorted(got)
            for n in range(N + 1):
                before = int((key < n).sum())
                assert int(starts[g * (N + 1) + n]) == (g * N + n) * O + g * cells + before
    order, starts = lists["list_vis"], lists["starts_vis"]
    assert int(starts[2 * (V + 1) + V + 1] - starts[2 * (V + 1) + V]) == 1
    assert order[2, -1] == 1 * Q + 3
