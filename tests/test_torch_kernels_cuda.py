"""The port's CUDA kernels against their plain versions, on the card.

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports only torch, numpy and the port, so it runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py -q

K1 (``dmv_fused``): tie-free random potentials at n1 = 1, 2, 3, 5, 9, 51
(shared memory) and 81 (global scratch), with zero-length filler rows; totals to
1e-3 + 1e-5|x|, gradients to 5e-4 + 1e-4|x| (log-domain sums of a few
ulp of |log Z|); max-semiring totals and indicators exact. K5
(``match_fwd``): bf16-exact quarter-integer operands with -1e9 masks, so
values and first-winner indices are exact, at shapes with ragged tiles
(V, B, D not multiples of the tiles) and Q over one 128-row chunk.
"""

import numpy as np
import pytest
import torch

from vlgae_tpu_torch.struct import dmv_merge, dmv_value_and_grads_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _dmv_batch(lengths, n1, seed, device):
    rng = np.random.default_rng(seed)
    B, n = len(lengths), n1 - 1
    parts = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in ((B, n, 2, 2, 2), (B, n, n, 2), (B, n))]
    dec, attach = dmv_merge(*parts)
    return (dec.to(device), attach.to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("lengths,n1", [
    ((0,), 1), ((1, 0), 2), ((2, 1), 3), ((4, 0, 3), 5), ((0, 1, 8, 3), 9),
    ((50, 1, 0, 27, 13), 51), ((80, 0, 52, 7), 81)])
def test_dmv_fused_matches_plain(cuda, kind, lengths, n1):
    from vlgae_tpu_torch.ops import dmv_cuda

    dec, attach, lens = _dmv_batch(lengths, n1, sum(lengths), cuda)
    before = dmv_cuda.n_launches
    got = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    assert dmv_cuda.n_launches == before + 1
    want = dmv_value_and_grads_plain(dec, attach, lens, kind)
    if kind == "max":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        return
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


def test_dmv_dispatch_goes_to_the_kernel(cuda):
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import dmv_value_and_grads

    before = dmv_cuda.n_launches
    dmv_value_and_grads(*_dmv_batch((3, 2), 4, 0, cuda), "log")
    assert dmv_cuda.n_launches == before + 1


@pytest.mark.parametrize("A,V,B,Q,D", [
    (3, 10, 4, 5, 7), (4, 130, 7, 21, 130), (5, 65, 62, 202, 128),
    (64, 703, 64, 102, 128)])
def test_match_fwd_matches_plain(cuda, A, V, B, Q, D):
    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import match_maxes, match_maxes_plain

    rng = np.random.default_rng(A + V)
    vis = torch.tensor(rng.integers(-8, 9, (A, V, D)) * 0.25, device=cuda).bfloat16()
    txt = torch.tensor(rng.integers(-8, 9, (B, Q, D)) * 0.25, device=cuda).bfloat16()
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=cuda)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=cuda)
    before = match.n_launches
    got = match_maxes(vis, txt, vb, tb)
    assert match.n_launches == before + 1
    want = match_maxes_plain(vis, txt, vb, tb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_match_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from vlgae_tpu_torch.ops.match import match_maxes_cuda

    vis = torch.zeros(2, 5, 8, device=cuda, dtype=torch.bfloat16)
    txt = torch.zeros(3, 4, 8, device=cuda, dtype=torch.bfloat16)
    vb = torch.zeros(2, 5, device=cuda)
    tb = torch.zeros(3, 4, device=cuda)
    with pytest.raises(TypeError):
        match_maxes_cuda(vis.float(), txt, vb, tb)
    with pytest.raises(ValueError):
        match_maxes_cuda(vis, txt, vb[:, :4], tb)
    with pytest.raises(ValueError):
        match_maxes_cuda(vis.transpose(1, 2).contiguous().transpose(1, 2), txt, vb, tb)
