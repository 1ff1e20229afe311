"""The port's CUDA kernels against their plain versions, on the card.

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports only torch, numpy and the port, so it runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py -q

K1 (``dmv_fused``): tie-free random potentials at n1 = 1, 2, 3, 5, 9, 51
(shared memory) and 81 (global scratch), with zero-length filler rows, and
at n1 = 57, 58, 65, 74 and 75 (inside charts in shared memory, adjoint
charts in global scratch) at B = 64, log also against the plain version in
f64; totals to
1e-3 + 1e-5|x|, gradients to 5e-4 + 1e-4|x| (log-domain sums of a few
ulp of |log Z|); max-semiring totals and indicators exact. K5
(``match_fwd``): bf16-exact quarter-integer operands with -1e9 masks, so
values and first-winner indices are exact, at shapes with ragged tiles
(V, B, D not multiples of the tiles) and Q over one 104-word chunk; Q and V
one below, at and one above the MMA tile sizes (the wgmma's N = 104 words
and its 8-word column groups, the other builds of 40, 72, 120 and 136
words, Q = 129, 130, 136 and 137 either side of the widest, its M = 64
image rows and a warp's 16), B not
a multiple of the 4-caption tile, more caption tiles than a block per image
fills the card with (blocks then serve unequal numbers of images), D = 8,
130 (rows not 16-byte aligned: the 2-byte staging path) and 384 (three
k-chunks), an operand that starts 2 bytes off alignment, and operands in {-1/4, 0, 1/4}
with a whole image, caption, region and word masked, where nearly every
maximum is tied and the first index must win. K1 again on ragged batches
with lengths 0, 1 and n1-1 at n1 = 9, 10, 17, 51, 57 and 101, which
between them use every group width from one lane to a warp
(tests/test_torch_kernel_rules.py), with reruns bit-identical and, on
quarter-integer potentials full of ties, max totals equal to the inside
kernel's bit for bit and tables equal to the pair's. K1 against the pair
at a cotangent of one on tie-free potentials at n1 = 1 to 101 (56, the last
n1 of its shared-memory mapping, and 57, the first of global scratch,
among them): bit-equal in max, within its tolerance in log; and K1 in log
at n1 = 101, B = 64, lengths 86-100 (the long-caption path) against the
plain version in f64 at its gradient tolerance. K6
(``match_bwd``): indices from a real K5 forward and quarter-integer
cotangents, so every product and sum is exact and the gradients must be
EQUAL to the plain version's, at Q > 128, D = 7 and 130 (the 2-byte
feature path), B = 1 and the recipe's training shape (V = 739); two runs
must give identical bits. The winner lists K6 builds equal their plain
version (a stable argsort), and rows whose lists cross many 512-position
segments (a word or a region that wins every cell of its caption or
image) and cells that win both ways are exact too. Quarter-integer cotangents are bf16-exact, so
the bf16 rounding of the summed cell weight is pinned apart: by the 1x1x1
pair of the CPU test and, exactly, by 12-bit dyadic cotangents at shapes
small enough for every f32 sum to stay exact, up to D = 384.

K2/K4 (``dmv_inside``), K3a/K4 (``dmv_inside_save``) and K3b
(``dmv_outside``): the same tie-free potentials at n1 = 1..9 (a warp per
sentence), 10, 17, 51, 56, 57, 60, 76 and 85 (a block per sentence, charts in
shared memory) and 86, 100, 170 (charts in global memory), which put both
kernels of the pair on each side of their staging and shared/global
boundaries (each outside launch counted on the mapping its rule names).
Totals as K1's (max exact,
and equal to K1's bit for bit); the saved charts within 1e-3 + 1e-5|x| of
the plain charts on the span triangle (max exact) and exactly -1e12 off it;
the outside pass, with a cotangent that has zeros, within K1's gradient
tolerance of the plain version (max exact), on the kernel's charts and on
the plain charts uploaded, equal in the max semiring to K1 scaled by the
cotangent, and bit-identical on a rerun. The warp mapping also at B = 63
and 65 (a ragged last block) for n1 = 1, 2, 3, 5, 9, with lengths 0 and
n1 - 1 at both ends of the batch.
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
    before = dmv_cuda.launch_counts()["fused"]
    got = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    assert dmv_cuda.launch_counts()["fused"] == before + 1
    want = dmv_value_and_grads_plain(dec, attach, lens, kind)
    if kind == "max":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        return
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", [9, 10, 17, 51, 57, 65, 101])
def test_dmv_fused_ragged_batches_at_every_group_width(cuda, kind, n1):
    """Mixed lengths (0, 1, n1-1 among them) in one launch: charts in shared
    memory up to n1 = 56 and in global scratch beyond, blocks of 128 to 1024
    threads, groups of 1 to 32 lanes."""
    from vlgae_tpu_torch.ops import dmv_cuda

    rng = np.random.default_rng(n1)
    lengths = [0, 1, n1 - 1, n1 - 1, *rng.integers(0, n1, 8).tolist()]
    dec, attach, lens = _dmv_batch(lengths, n1, n1, cuda)
    got = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    again = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    for g, a in zip(got, again):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
    want = dmv_value_and_grads_plain(dec, attach, lens, kind)
    if kind == "max":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("n1", [9, 10, 17, 51, 57, 65, 101])
def test_dmv_fused_on_tied_potentials_equals_the_inside_and_the_pair(cuda, n1):
    """Quarter-integer potentials tie often. The max totals must be the
    inside kernel's bit for bit (fmaxf is order-free), and the tables the
    pair's: every cell of every best tree, by the exact tie test."""
    from vlgae_tpu_torch.ops import dmv_cuda

    rng = np.random.default_rng(100 + n1)
    lengths = [0, 1, n1 - 1, *rng.integers(0, n1, 9).tolist()]
    B, n = len(lengths), n1 - 1
    parts = [torch.tensor(rng.integers(-8, 9, s) * 0.25, dtype=torch.float32)
             for s in ((B, n, 2, 2, 2), (B, n, n, 2), (B, n))]
    dec, attach = (t.to(cuda) for t in dmv_merge(*parts))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    ft, fd, fa = dmv_cuda.dmv_fused(dec, attach, lens, "max")
    assert torch.equal(ft, dmv_cuda.dmv_inside(dec, attach, lens, "max"))
    total, charts = dmv_cuda.dmv_inside_save(dec, attach, lens, "max")
    gout = _cotangent(B, cuda)
    gd, ga = dmv_cuda.dmv_outside(dec, attach, lens, gout, total, charts, "max")
    assert torch.equal(total, ft)
    assert torch.equal(gd, gout.view(-1, 1, 1, 1, 1) * fd)
    assert torch.equal(ga, gout.view(-1, 1, 1, 1) * fa)
    assert bool(((fa == 0) | (fa == 1)).all()) and float(fa.sum()) >= sum(lengths)


def test_dmv_fused_takes_global_scratch_at_the_vit_recipes_longest_captions(cuda):
    """exp=vlgae_vit trains on captions of up to 63 words (n1 = 65): past
    the shared-memory limit of K1's eight charts, so its four adjoint charts
    live in global scratch and its inside charts in shared memory (the
    ``split`` placement); both semirings there agree with the plain
    version."""
    from vlgae_tpu_torch.ops import dmv_cuda

    dmv_cuda.dmv_fused(*_dmv_batch((1,), 2, 0, cuda), "max")  # loads the library
    assert dmv_cuda.fused_mapping(65, dmv_cuda._smem_optin) == "split"
    rng = np.random.default_rng(65)
    lengths = [64, 1, 0, *rng.integers(1, 65, 61).tolist()]
    dec, attach, lens = _dmv_batch(lengths, 65, 7, cuda)
    for kind in ("log", "max"):
        before = dmv_cuda.launch_counts()["fused_split"]
        got = dmv_cuda.dmv_fused(dec, attach, lens, kind)
        assert dmv_cuda.launch_counts()["fused_split"] == before + 1
        want = dmv_value_and_grads_plain(dec, attach, lens, kind)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", [1, 2, 9, 17, 51, 56, 57, 65, 101])
def test_dmv_fused_equals_the_pair_at_a_cotangent_of_one(cuda, kind, n1):
    """K1 runs the pair's two fills in one launch: its total and tables
    equal ``dmv_inside_save`` + ``dmv_outside`` at ``gout = 1``, bit for bit
    in max, within K1's tolerance in log (the butterflies' order may
    differ), zero-length rows and cells off the sentences' arcs included."""
    from vlgae_tpu_torch.ops import dmv_cuda

    rng = np.random.default_rng(200 + n1)
    lengths = [0, min(1, n1 - 1), n1 - 1, *rng.integers(0, n1, 9).tolist()]
    dec, attach, lens = _dmv_batch(lengths, n1, 300 + n1, cuda)
    got = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    total, charts = dmv_cuda.dmv_inside_save(dec, attach, lens, kind)
    ones = torch.ones_like(total)
    pair = (total, *dmv_cuda.dmv_outside(dec, attach, lens, ones, total, charts, kind))
    if kind == "max":
        for g, w in zip(got, pair):
            assert torch.equal(g, w)
    else:
        torch.testing.assert_close(got[0], pair[0], rtol=1e-5, atol=1e-3)
        for g, w in zip(got[1:], pair[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)
    assert bool((got[1][lens == 0][:, 1:] == 0).all())
    assert bool((got[2][lens == 0] == 0).all())


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", [57, 58, 65, 74, 75])
def test_dmv_fused_split_placement_matches_plain(cuda, kind, n1):
    """K1 with its inside charts in shared memory (pitch n1 | 1) and its
    adjoint charts in global scratch (pitch n1), from the first n1 of that
    placement to its last (57 and 75) and at even n1 between, where the
    two pitches differ: B = 64 ragged batches with lengths 0, 1 and n1 - 1,
    each launch counted on the placement; max exact, log within K1's
    tolerance of the plain version and of the plain version in f64."""
    from vlgae_tpu_torch.ops import dmv_cuda

    dmv_cuda.dmv_fused(*_dmv_batch((1,), 2, 0, cuda), "max")  # loads the library
    assert dmv_cuda.fused_mapping(n1, dmv_cuda._smem_optin) == "split"
    rng = np.random.default_rng(400 + n1)
    lengths = [n1 - 1, 1, 0, *rng.integers(1, n1, 61).tolist()]
    dec, attach, lens = _dmv_batch(lengths, n1, 500 + n1, cuda)
    before = dmv_cuda.launch_counts()["fused_split"]
    got = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    assert dmv_cuda.launch_counts()["fused_split"] == before + 1
    wants = [dmv_value_and_grads_plain(dec, attach, lens, kind)]
    if kind == "max":
        for g, w in zip(got, wants[0]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        return
    wants.append([x.float() for x in dmv_value_and_grads_plain(dec, attach, lens, kind,
                                                               torch.float64)])
    for want in wants:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


def test_dmv_fused_log_at_n1_101_matches_the_plain_version_in_f64(cuda):
    """The long-caption path (exp=lang_only on 86-100 words, n1 = 101, charts
    in global scratch): K1's log gradients within 5e-4 + 1e-4|x| of the plain
    version in f64, whose own round-off is far below that: the outside pass
    carries log-marginals, near 0, where outside scores grow to log Z (that
    form came out 1.4e-4 relative off here)."""
    from vlgae_tpu_torch.ops import dmv_cuda

    rng = np.random.default_rng(101)
    lengths = [100, *rng.integers(86, 101, 63).tolist()]
    dec, attach, lens = _dmv_batch(lengths, 101, 101, cuda)
    got = dmv_cuda.dmv_fused(dec, attach, lens, "log")
    want = [x.float() for x in dmv_value_and_grads_plain(dec, attach, lens, "log",
                                                         torch.float64)]
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


def test_dmv_dispatch_goes_to_the_kernel(cuda):
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import dmv_value_and_grads

    before = dmv_cuda.launch_counts()["fused"]
    dmv_value_and_grads(*_dmv_batch((3, 2), 4, 0, cuda), "log")
    assert dmv_cuda.launch_counts()["fused"] == before + 1


@pytest.mark.parametrize("A,V,B,Q,D", [
    (3, 10, 4, 5, 7), (4, 130, 7, 21, 130), (5, 65, 62, 202, 128),
    (64, 703, 64, 102, 128), (64, 1324, 64, 130, 128), (64, 1275, 64, 130, 128)])
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
    before = match.launch_counts()["fwd"]
    got = match_maxes(vis, txt, vb, tb)
    assert match.launch_counts()["fwd"] == before + 1
    want = match_maxes_plain(vis, txt, vb, tb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_match_fwd_and_bwd_at_word_alldeps_widest_q(cuda):
    """word+alldep's language factors at the recipe's longest captions (N =
    57 positions: Q = N + N^2 = 3,306) at the training V = 739: K5 takes 25
    q-chunks of 136 and equals its plain version, K6 too (8 captions and
    images, quarter-integer operands and 12-bit cotangents: exact)."""
    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import (match_fwd_q_tiling, match_maxes,
                                           match_maxes_bwd, match_maxes_bwd_plain,
                                           match_maxes_plain)

    A, V, B, Q, D = 8, 739, 8, 3306, 128
    assert match_fwd_q_tiling(Q) == (25, 17)
    vis, txt, vb, tb, dm, dmv = _match_case(A, V, B, Q, D, cuda)
    before = match.launch_counts()["fwd_by_q_chunks"].get(25, 0)
    got = match_maxes(vis, txt, vb, tb)
    assert match.launch_counts()["fwd_by_q_chunks"].get(25, 0) == before + 1
    for g, w in zip(got, match_maxes_plain(vis, txt, vb, tb)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _, li, _, lvi = got
    want = match_maxes_bwd_plain(vis, txt, li, lvi, dm, dmv)
    for g, w in zip(match_maxes_bwd(vis, txt, li, lvi, dm, dmv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("V", [1324, 1275])
def test_match_fwd_takes_one_q_chunk_on_the_patch_grid(cuda, V):
    """The patch grid of exp=vlgae_vit (V = 1,324 in training, 1,275 in
    evaluation) at its longest captions (Q = 130): one q-chunk of 136
    words, one pass over the images, exactly the plain version's outputs on
    quarter-integers."""
    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import match_fwd_q_tiling

    assert match_fwd_q_tiling(130) == (1, 17)
    args = _quarter_match_inputs(np.random.default_rng(V), 64, V, 64, 130, 128, cuda)
    before = match.launch_counts()["fwd_by_q_chunks"].get(1, 0)
    _assert_match_fwd_equals_plain(args)
    assert match.launch_counts()["fwd_by_q_chunks"].get(1, 0) == before + 1


def _quarter_match_inputs(rng, A, V, B, Q, D, device, scale=8):
    """bf16-exact operands (k/4 with |k| <= scale) and -1e9 masks."""
    vis = torch.tensor(rng.integers(-scale, scale + 1, (A, V, D)) * 0.25,
                       device=device).bfloat16()
    txt = torch.tensor(rng.integers(-scale, scale + 1, (B, Q, D)) * 0.25,
                       device=device).bfloat16()
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=device)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=device)
    return vis, txt, vb, tb


def _assert_match_fwd_equals_plain(args):
    from vlgae_tpu_torch.ops.match import match_maxes_cuda, match_maxes_plain

    got = match_maxes_cuda(*args)
    want = match_maxes_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


# (A, V, B, Q, D): Q around an 8-word column group and the 104-word chunk
# (the wgmma's N), V around a warp's 16 rows and the 64-row stage (its M), B
# around the 4-caption tile, D around the 16-deep MMA step and the 128-deep
# stage; 50 caption tiles, so that 2 blocks share 5 images, 3 and 2
MATCH_EDGES = [
    (2, 15, 1, 7, 8), (2, 16, 2, 8, 16), (2, 17, 3, 9, 24),
    (3, 63, 4, 103, 128), (3, 64, 5, 104, 128), (3, 65, 7, 105, 128),
    (2, 129, 9, 209, 64), (1, 33, 6, 31, 130), (2, 20, 3, 9, 384),
    (2, 70, 5, 110, 127), (2, 70, 5, 110, 129), (1, 1, 1, 1, 1),
    (5, 70, 200, 9, 16), (7, 130, 150, 30, 128),
    # Q around the other builds (chunks of 40, 72 and 120 words), the recipe's
    # Q = 2 * (padded length + 1), and where two and three equal chunks begin
    (2, 70, 5, 18, 64), (2, 70, 5, 34, 128), (2, 70, 5, 39, 128), (3, 65, 6, 40, 128),
    (3, 65, 6, 41, 128), (2, 70, 5, 50, 128), (2, 70, 5, 66, 128), (2, 70, 5, 72, 128),
    (2, 70, 5, 73, 128), (2, 70, 5, 82, 128), (2, 70, 5, 98, 128), (3, 130, 9, 114, 128),
    (2, 70, 5, 119, 128), (2, 70, 5, 120, 128), (2, 70, 5, 121, 128),
    (2, 66, 3, 160, 136), (2, 66, 3, 241, 64), (2, 66, 3, 313, 32),
    # each side of the widest build (136 words: the patch grid's Q = 130 in
    # one chunk, 137 in two), with an odd number of image tiles a block
    (2, 130, 5, 129, 128), (3, 130, 5, 130, 128), (2, 130, 5, 136, 128),
    (2, 130, 5, 137, 128), (5, 193, 9, 130, 64)]


@pytest.mark.parametrize("A,V,B,Q,D", MATCH_EDGES)
def test_match_fwd_tile_edges(cuda, A, V, B, Q, D):
    rng = np.random.default_rng(A + V + B + Q + D)
    _assert_match_fwd_equals_plain(_quarter_match_inputs(rng, A, V, B, Q, D, cuda))


@pytest.mark.parametrize("A,V,B,Q,D", [(3, 70, 6, 110, 8), (4, 130, 5, 21, 3),
                                       (2, 64, 4, 104, 128), (3, 130, 5, 136, 128)])
def test_match_fwd_ties_and_whole_masked_rows(cuda, A, V, B, Q, D):
    """Operands in {-1/4, 0, 1/4}: nearly every maximum is tied, so every
    merge (lanes, warps, image tiles, q-chunks) must prefer the smaller
    index; a wholly masked image, caption, region and word tie at exactly
    -1e9 or -2e9 and give index 0."""
    rng = np.random.default_rng(D)
    vis, txt, vb, tb = _quarter_match_inputs(rng, A, V, B, Q, D, cuda, scale=1)
    vb[0, :] = -1e9
    vb[:, 1] = -1e9
    tb[1, :] = -1e9
    tb[:, 0] = -1e9
    _, li, _, lvi = _assert_match_fwd_equals_plain((vis, txt, vb, tb))
    assert int(li[:, 0].max()) == 0 and int(lvi[1].max()) == 0
    zeros = (torch.zeros_like(vis), torch.zeros_like(txt), torch.zeros_like(vb),
             torch.zeros_like(tb))
    _, li, _, lvi = _assert_match_fwd_equals_plain(zeros)
    assert int(li.max()) == 0 and int(lvi.max()) == 0


def test_match_fwd_takes_operands_off_16_byte_alignment(cuda):
    """A contiguous operand that starts 2 bytes into an allocation cannot be
    copied 16 bytes at a time: the same kernel stages it by 2-byte loads."""
    from vlgae_tpu_torch.ops.match import match_fwd_plan

    rng = np.random.default_rng(11)
    vis, txt, vb, tb = _quarter_match_inputs(rng, 3, 70, 5, 40, 128, cuda)
    buf = torch.zeros(vis.numel() + 1, dtype=torch.bfloat16, device=cuda)
    buf[1:] = vis.flatten()
    off = buf[1:].view(vis.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert match_fwd_plan(3, 70, 5, 40, 128, off.data_ptr(),
                          txt.data_ptr())["staging"] == "scalar"
    _assert_match_fwd_equals_plain((off, txt, vb, tb))


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


def _match_case(A, V, B, Q, D, device, seed=0, dyadic=False):
    """Quarter-integer operands in [-2, 2] and -1e9 masks; cotangents
    quarter-integers too, or with ``dyadic`` k·2^-10 (|k| < 2048), which
    are not bf16-exact, so the bf16 rounding of the summed cell weight
    shows, while at shapes with few terms per output row (|sum| < 2^12)
    every product and f32 sum stays exact."""
    rng = np.random.default_rng(seed + A + V + B)
    vis = torch.tensor(rng.integers(-8, 9, (A, V, D)) * 0.25, device=device).bfloat16()
    txt = torch.tensor(rng.integers(-8, 9, (B, Q, D)) * 0.25, device=device).bfloat16()
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=device)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=device)

    def cot(shape):
        if dyadic:
            return rng.integers(-2047, 2048, shape) * 2.0 ** -10
        return rng.integers(-8, 9, shape) * 0.25

    dm = torch.tensor(cot((B, A, Q)), dtype=torch.float32, device=device)
    dmv = torch.tensor(cot((B, A, V)), dtype=torch.float32, device=device)
    return vis, txt, vb, tb, dm, dmv


@pytest.mark.parametrize("A,V,B,Q,D", [
    (3, 10, 4, 5, 7), (5, 65, 62, 202, 130), (4, 33, 1, 129, 128),
    (1, 40, 6, 31, 16), (64, 739, 64, 102, 128), (64, 1324, 64, 130, 128)])
def test_match_bwd_matches_plain_and_is_deterministic(cuda, A, V, B, Q, D):
    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import (match_maxes, match_maxes_bwd,
                                           match_maxes_bwd_plain)

    vis, txt, vb, tb, dm, dmv = _match_case(A, V, B, Q, D, cuda)
    _, li, _, lvi = match_maxes(vis, txt, vb, tb)
    before = match.launch_counts()["bwd"]
    got = match_maxes_bwd(vis, txt, li, lvi, dm, dmv)
    again = match_maxes_bwd(vis, txt, li, lvi, dm, dmv)
    assert match.launch_counts()["bwd"] == before + 2
    want = match_maxes_bwd_plain(vis, txt, li, lvi, dm, dmv)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))


def test_match_bwd_rounds_the_weight_after_the_two_directions_add(cuda):
    """The CPU pair of test_torch_match_bwd.py on the card: bf16(dm + dmv),
    not bf16(dm) + bf16(dmv) = 1.1171875."""
    from vlgae_tpu_torch.ops.match import match_maxes_bwd_cuda

    one = torch.ones(1, 1, 1, dtype=torch.bfloat16, device=cuda)
    win = torch.zeros(1, 1, 1, dtype=torch.int32, device=cuda)
    dm = torch.full((1, 1, 1), float.fromhex("0x1.1de51cp+0"), device=cuda)
    dmv = torch.full((1, 1, 1), float.fromhex("-0x1.e92802p-9"), device=cuda)
    dvis, dtxt = match_maxes_bwd_cuda(one, one, win, win, dm, dmv)
    assert float(dvis) == float(dtxt) == 1.109375


@pytest.mark.parametrize("A,V,B,Q,D", [
    (3, 10, 4, 5, 7), (4, 33, 1, 129, 128), (1, 40, 6, 31, 16),
    (2, 20, 3, 9, 384)])
def test_match_bwd_is_exact_on_12_bit_cotangents(cuda, A, V, B, Q, D):
    """Cotangents that are not bf16-exact, so a K6 that skipped the
    rounding of the summed weight, or rounded each direction apart, would
    differ; D = 384 is the kernel's largest feature width."""
    from vlgae_tpu_torch.ops.match import match_maxes, match_maxes_bwd_cuda
    from vlgae_tpu_torch.ops.match import match_maxes_bwd_plain as plain

    vis, txt, vb, tb, dm, dmv = _match_case(A, V, B, Q, D, cuda, dyadic=True)
    _, li, _, lvi = match_maxes(vis, txt, vb, tb)
    got = match_maxes_bwd_cuda(vis, txt, li, lvi, dm, dmv)
    want = plain(vis, txt, li, lvi, dm, dmv)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    separate = plain(vis, txt, li, lvi, dm.bfloat16().float(), dmv.bfloat16().float())
    assert not all(torch.equal(w, s) for w, s in zip(want, separate))


@pytest.mark.parametrize("A,V,B,Q,D", [
    (3, 10, 4, 5, 7), (5, 65, 62, 202, 130), (4, 33, 1, 129, 128),
    (64, 739, 64, 102, 128), (64, 1324, 64, 130, 128)])
def test_match_bwd_lists_equal_their_plain_version(cuda, A, V, B, Q, D):
    from vlgae_tpu_torch.ops.match import match_bwd_launch, match_bwd_lists_plain, match_maxes

    vis, txt, vb, tb, dm, dmv = _match_case(A, V, B, Q, D, cuda)
    _, li, _, lvi = match_maxes(vis, txt, vb, tb)
    got = match_bwd_launch(vis, txt, li, lvi, dm, dmv)[2]
    for name, want in match_bwd_lists_plain(li, lvi).items():
        assert torch.equal(got[name], want), name


def _hot_case(kind, device, A, V, B, Q, D):
    """Winner indices built directly, quarter-integer operands and
    cotangents. ``"hot_q"``: word 1 of every caption wins every region of
    every image (a dtxt row with A·V cross partners); ``"hot_v"``: region 2
    of every image wins every word (a dvis row with B·Q); ``"own_cross"``:
    every cell (b, a, q, q % V) wins both ways where that is possible."""
    rng = np.random.default_rng(A + V + B + Q + D)
    vis = torch.tensor(rng.integers(-8, 9, (A, V, D)) * 0.25, device=device).bfloat16()
    txt = torch.tensor(rng.integers(-8, 9, (B, Q, D)) * 0.25, device=device).bfloat16()
    li = torch.tensor(rng.integers(0, V, (B, A, Q)), dtype=torch.int32, device=device)
    lvi = torch.tensor(rng.integers(0, Q, (B, A, V)), dtype=torch.int32, device=device)
    if kind == "hot_q":
        lvi[:] = 1
    elif kind == "hot_v":
        li[:] = 2
    else:
        q = torch.arange(Q, device=device)
        li[:] = (q % V).int()
        lvi[:, :, :min(Q, V)] = torch.arange(min(Q, V), device=device).int()
    dm = torch.tensor(rng.integers(-8, 9, (B, A, Q)) * 0.25, dtype=torch.float32,
                      device=device)
    dmv = torch.tensor(rng.integers(-8, 9, (B, A, V)) * 0.25, dtype=torch.float32,
                       device=device)
    return vis, txt, li, lvi, dm, dmv


@pytest.mark.parametrize("kind", ["hot_q", "hot_v", "own_cross"])
@pytest.mark.parametrize("A,V,B,Q,D", [(6, 70, 5, 40, 128), (64, 739, 64, 102, 128),
                                       (3, 45, 4, 50, 130)])
def test_match_bwd_hot_rows_and_own_cross_cells_are_exact(cuda, kind, A, V, B, Q, D):
    """Rows whose lists run over many segments (a word that wins all A·V
    cells of its caption, a region that wins all B·Q of its image) and cells
    that win both ways (one weight, bf16(dm + dmv)): equal to the plain
    version, bit-identical on a rerun, the lists equal to theirs."""
    from vlgae_tpu_torch.ops.match import (match_bwd_launch, match_bwd_lists_plain,
                                           match_maxes_bwd_cuda, match_maxes_bwd_plain)

    args = _hot_case(kind, cuda, A, V, B, Q, D)
    got = match_maxes_bwd_cuda(*args)
    again = match_maxes_bwd_cuda(*args)
    want = match_maxes_bwd_plain(*args)
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
    lists = match_bwd_launch(*args)[2]
    for name, want in match_bwd_lists_plain(*args[2:4]).items():
        assert torch.equal(lists[name], want), name


def test_match_autograd_on_the_card_launches_k5_and_k6(cuda, monkeypatch):
    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import MatchMaxesFn

    def refuse(*_):
        raise AssertionError("a plain version ran for a CUDA tensor")

    monkeypatch.setattr(match, "match_maxes_plain", refuse)
    monkeypatch.setattr(match, "match_maxes_bwd_plain", refuse)
    vis, txt, vb, tb, dm, dmv = _match_case(4, 37, 8, 21, 16, cuda)
    vf = vis.float().requires_grad_(True)
    tf = txt.float().requires_grad_(True)
    c0 = match.launch_counts()
    m, _, mv, _ = MatchMaxesFn.apply(vf.bfloat16(), tf.bfloat16(), vb, tb)
    ((m * dm).sum() + (mv * dmv).sum()).backward()
    c1 = match.launch_counts()
    assert (c1["fwd"], c1["bwd"]) == (c0["fwd"] + 1, c0["bwd"] + 1)
    assert vf.grad is not None and tf.grad is not None


def test_match_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from vlgae_tpu_torch.ops.match import match_maxes, match_maxes_bwd_cuda

    vis, txt, vb, tb, dm, dmv = _match_case(2, 9, 3, 6, 8, cuda)
    _, li, _, lvi = match_maxes(vis, txt, vb, tb)
    with pytest.raises(TypeError):
        match_maxes_bwd_cuda(vis.float(), txt, li, lvi, dm, dmv)
    with pytest.raises(TypeError):
        match_maxes_bwd_cuda(vis, txt, li.long(), lvi, dm, dmv)
    with pytest.raises(TypeError):
        match_maxes_bwd_cuda(vis, txt, li, lvi, dm.double(), dmv)
    with pytest.raises(ValueError):
        match_maxes_bwd_cuda(vis, txt, li, lvi, dm[:, :, :5], dmv)
    with pytest.raises(RuntimeError):
        match_maxes_bwd_cuda(vis, txt, li, lvi, dm.cpu(), dmv)
    with pytest.raises(ValueError):
        match_maxes_bwd_cuda(vis, txt, li.transpose(1, 2).contiguous().transpose(1, 2),
                             lvi, dm, dmv)
    wide = torch.zeros(2, 9, 385, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 384"):
        match_maxes_bwd_cuda(wide, torch.zeros(3, 6, 385, device=cuda,
                                               dtype=torch.bfloat16), li, lvi, dm, dmv)


# on an H100 the outside kernel stages its potentials up to n1 = 56 and keeps
# its charts in shared memory up to 59, the inside kernel stages up to 75 and
# keeps its charts in shared memory up to 85; neither stages past 168
DMV_CASES = [
    ((0,), 1), ((1, 0), 2), ((2, 1), 3), ((4, 0, 3), 5), ((0, 1, 8, 3, 8, 5), 9),
    ((9, 1, 0, 4), 10), ((16, 3, 0, 9), 17), ((50, 1, 0, 27, 13), 51),
    ((55, 1, 30), 56), ((56, 2, 0, 33), 57), ((59, 0, 21), 60), ((75, 3, 0), 76),
    ((84, 2, 40), 85), ((85, 0, 52, 7), 86), ((99, 86, 0, 1), 100), ((169, 0, 120), 170)]
DMV_MAPPING = {1: "warp", 2: "warp", 3: "warp", 5: "warp", 9: "warp", 10: "smem",
               17: "smem", 51: "smem", 56: "smem", 57: "smem", 60: "smem", 76: "smem",
               85: "smem", 86: "global", 100: "global", 170: "global"}


def _cotangent(B, device):
    """Multiples of 1/4 (a sum of equal terms is exact in either order),
    with a zero."""
    g = torch.arange(1, B + 1, device=device) * 0.25
    g[B // 2] = 0.0
    return g


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("lengths,n1", DMV_CASES)
def test_dmv_inside_matches_plain(cuda, kind, lengths, n1):
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import dmv_total

    dec, attach, lens = _dmv_batch(lengths, n1, sum(lengths), cuda)
    before = dmv_cuda.launch_counts()
    got = dmv_cuda.dmv_inside(dec, attach, lens, kind)
    after = dmv_cuda.launch_counts()
    mapping = DMV_MAPPING[n1]
    assert after["inside"][mapping] == before["inside"][mapping] + 1
    assert sum(after["inside"].values()) == sum(before["inside"].values()) + 1
    assert after["fused"] == before["fused"]
    want = dmv_total(dec, attach, lens, kind)
    fused = dmv_cuda.dmv_fused(dec, attach, lens, kind)[0]
    if kind == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(got, fused, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(got, fused, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("B", [63, 65])
@pytest.mark.parametrize("n1", [1, 2, 3, 5, 9])
def test_dmv_inside_warp_mapping_on_ragged_blocks(cuda, kind, B, n1):
    """The warp mapping (a warp a sentence, its potentials staged, one
    __syncwarp() a width) at B one below and one above a multiple of four,
    so that at two or four sentences a block the last block is ragged: the
    total and the saved charts against the plain versions (max exact), -1e12
    off the triangle, reruns bit-identical, one warp launch a call."""
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import dmv_inside_charts_plain

    rng = np.random.default_rng(B * 10 + n1)
    lengths = rng.integers(0, n1, B)
    lengths[:2] = (0, n1 - 1)
    lengths[-2:] = (n1 - 1, 0)
    dec, attach, lens = _dmv_batch(tuple(lengths), n1, B + n1, cuda)
    want_total, want_charts = dmv_inside_charts_plain(dec, attach, lens, kind)
    off = want_charts == -1e12
    tol = dict(rtol=0, atol=0) if kind == "max" else dict(rtol=1e-5, atol=1e-3)
    for save in (False, True):
        fn = dmv_cuda.dmv_inside_save if save else dmv_cuda.dmv_inside
        key = "inside_save" if save else "inside"
        before = dmv_cuda.launch_counts()[key]
        got = fn(dec, attach, lens, kind)
        again = fn(dec, attach, lens, kind)
        after = dmv_cuda.launch_counts()[key]
        assert after["warp"] == before["warp"] + 2
        assert sum(after.values()) == sum(before.values()) + 2
        got, again = (got, again) if save else ((got,), (again,))
        for g, a in zip(got, again):
            assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        torch.testing.assert_close(got[0], want_total, **tol)
        if save:
            charts = got[1]
            assert bool((charts[off] == -1e12).all())
            torch.testing.assert_close(charts[~off], want_charts[~off], **tol)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("lengths,n1", DMV_CASES)
def test_dmv_inside_save_and_outside_match_plain_and_fused(cuda, kind, lengths, n1):
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import dmv_inside_charts_plain, dmv_outside_plain

    dec, attach, lens = _dmv_batch(lengths, n1, sum(lengths) + 1, cuda)
    B = len(lengths)
    before = dmv_cuda.launch_counts()
    total, charts = dmv_cuda.dmv_inside_save(dec, attach, lens, kind)
    after = dmv_cuda.launch_counts()
    mapping = DMV_MAPPING[n1]
    assert after["inside_save"][mapping] == before["inside_save"][mapping] + 1
    want_total, want_charts = dmv_inside_charts_plain(dec, attach, lens, kind)
    off = want_charts == -1e12
    assert bool((charts[off] == -1e12).all())
    tol = dict(rtol=0, atol=0) if kind == "max" else dict(rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(total, want_total, **tol)
    torch.testing.assert_close(charts[~off], want_charts[~off], **tol)

    gout = _cotangent(B, cuda)
    got = dmv_cuda.dmv_outside(dec, attach, lens, gout, total, charts, kind)
    assert dmv_cuda.launch_counts()["outside"] == after["outside"] + 1
    out_global = dmv_cuda.outside_mapping(n1, dmv_cuda._smem_optin) == "global"
    assert dmv_cuda.launch_counts()["outside_global"] == after["outside_global"] + out_global
    again = dmv_cuda.dmv_outside(dec, attach, lens, gout, total, charts, kind)
    on_plain = dmv_cuda.dmv_outside(dec, attach, lens, gout, want_total,
                                    want_charts.contiguous(), kind)
    want = dmv_outside_plain(dec, attach, lens, gout, total, charts, kind)
    _, fd, fa = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    fused = (gout.view(-1, 1, 1, 1, 1) * fd, gout.view(-1, 1, 1, 1) * fa)
    gtol = dict(rtol=0, atol=0) if kind == "max" else dict(rtol=1e-4, atol=5e-4)
    for g, a, p, w, f in zip(got, again, on_plain, want, fused):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        torch.testing.assert_close(g, w, **gtol)
        torch.testing.assert_close(p, w, **gtol)
        torch.testing.assert_close(g, f, **gtol)
        assert bool((g[B // 2] == 0).all())


@pytest.mark.parametrize("kind", ["log", "max"])
def test_dmv_pair_marks_every_best_tree_as_the_fused_kernel(cuda, kind):
    """Quarter-integer potentials tie often: the pair and the fused kernel
    must still agree (exactly in the max semiring)."""
    from vlgae_tpu_torch.ops import dmv_cuda

    rng = np.random.default_rng(5)
    lengths, n1 = (16, 9, 12, 0, 3, 16), 17
    B, n = len(lengths), n1 - 1
    parts = [torch.tensor(rng.integers(-8, 9, s) * 0.25, dtype=torch.float32)
             for s in ((B, n, 2, 2, 2), (B, n, n, 2), (B, n))]
    dec, attach = (t.to(cuda) for t in dmv_merge(*parts))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    gout = _cotangent(B, cuda)
    total, charts = dmv_cuda.dmv_inside_save(dec, attach, lens, kind)
    got = dmv_cuda.dmv_outside(dec, attach, lens, gout, total, charts, kind)
    ft, fd, fa = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    fused = (gout.view(-1, 1, 1, 1, 1) * fd, gout.view(-1, 1, 1, 1) * fa)
    tol = dict(rtol=0, atol=0) if kind == "max" else dict(rtol=1e-4, atol=5e-4)
    torch.testing.assert_close(total, ft, rtol=0 if kind == "max" else 1e-6,
                               atol=0 if kind == "max" else 1e-5)
    for g, f in zip(got, fused):
        torch.testing.assert_close(g, f, **tol)


def test_dmv_totals_on_the_card_take_the_kernels_by_what_is_needed(cuda, monkeypatch):
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import DMV1o, dmv_total_fast

    def refuse(*_):
        raise AssertionError("a plain version ran for a CUDA tensor")

    # the ops' CPU implementations reach the plain versions through this module
    for name in ("dmv_total", "dmv_inside_charts_plain", "dmv_outside_plain",
                 "dmv_value_and_grads_plain"):
        monkeypatch.setattr(dmv_cuda._plain, name, refuse)
    dec, attach, lens = _dmv_batch((8, 3, 0, 5), 9, 7, cuda)
    c0 = dmv_cuda.launch_counts()
    value = dmv_total_fast(dec.requires_grad_(True), attach, lens, "max")
    assert not value.requires_grad
    c1 = dmv_cuda.launch_counts()
    assert c1["inside"]["warp"] == c0["inside"]["warp"] + 1
    total = DMV1o((dec, attach.requires_grad_(True)), lens).partition
    (total * _cotangent(4, cuda)).sum().backward()
    c2 = dmv_cuda.launch_counts()
    assert c2["inside_save"]["warp"] == c1["inside_save"]["warp"] + 1
    assert c2["outside"] == c1["outside"] + 1
    assert c2["fused"] == c0["fused"]
    assert dec.grad is not None and attach.grad is not None
    with torch.no_grad():
        DMV1o((dec, attach), lens).max
    assert dmv_cuda.launch_counts()["inside"]["warp"] == c2["inside"]["warp"] + 1


def test_dmv_inside_outside_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from vlgae_tpu_torch.ops import dmv_cuda

    dec, attach, lens = _dmv_batch((3, 2), 4, 0, cuda)
    with pytest.raises(RuntimeError):
        dmv_cuda.dmv_inside(dec.cpu(), attach.cpu(), lens)
    with pytest.raises(TypeError):
        dmv_cuda.dmv_inside_save(dec.double(), attach, lens)
    with pytest.raises(ValueError):
        dmv_cuda.dmv_inside(dec, attach[:, :3], lens)
    with pytest.raises(ValueError):
        dmv_cuda.dmv_inside(dec, attach, lens, "std")
    total, charts = dmv_cuda.dmv_inside_save(dec, attach, lens)
    with pytest.raises(ValueError):
        dmv_cuda.dmv_outside(dec, attach, lens, total, total, charts[:, :3])
    with pytest.raises(TypeError):
        dmv_cuda.dmv_outside(dec, attach, lens, total.double(), total, charts)


# The Eisner CRF on the card: DependencyCRF maps arcs onto DMV potentials
# with free decisions (struct.distributions.eisner_as_dmv) and takes K1 for
# its tables, K2/K4 for a total without a gradient and the K3 pair with one;
# held against the plain Eisner fill of struct.deptree on the CPU, on
# tie-free standard-normal arcs: totals 1e-3 + 1e-5|x|, tables 5e-4 +
# 1e-4|x| in log, exact in max.
@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", [9, 51, 65, 101])
def test_dmv_fused_on_eisner_potentials_matches_the_plain_fill(cuda, kind, n1):
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import DependencyCRF, deptree_marginals, deptree_partition

    rng = np.random.default_rng(200 + n1)
    lengths = [0, 1, n1 - 1, *rng.integers(max(1, n1 - 16), n1, 13).tolist()]
    arc = torch.tensor(rng.standard_normal((len(lengths), n1, n1)), dtype=torch.float32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    crf = DependencyCRF(arc.to(cuda), lens.to(cuda))
    c0 = dmv_cuda.launch_counts()
    table = crf.marginals if kind == "log" else crf.argmax
    total = crf.partition if kind == "log" else crf.max
    c1 = dmv_cuda.launch_counts()
    assert c1["fused"] == c0["fused"] + 1
    assert sum(c1["inside"].values()) == sum(c0["inside"].values()) + 1
    want_t = deptree_partition(arc, lens, kind)
    want_g = deptree_marginals(arc, lens, kind)
    if kind == "max":
        torch.testing.assert_close(table.cpu(), want_g, rtol=0, atol=0)
        torch.testing.assert_close(total.cpu(), want_t, rtol=0, atol=1e-3)
        heads = crf.argmax_heads.cpu()
        assert torch.equal(heads, torch.argmax(want_g[:, :, 1:], dim=1))
    else:
        torch.testing.assert_close(total.cpu(), want_t, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(table.cpu(), want_g, rtol=1e-4, atol=5e-4)


def test_crf_on_the_card_takes_the_kernels_by_what_is_needed(cuda, monkeypatch):
    """A total with a gradient: the K3 pair, and the gradient reaches the
    arcs; a labeled arc's tables reach its labels; multiroot: the plain
    fill, no kernel."""
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import DependencyCRF

    rng = np.random.default_rng(7)
    lengths = torch.tensor([12, 0, 1, 7], dtype=torch.int32)
    arc = torch.tensor(rng.standard_normal((4, 13, 13, 3)), dtype=torch.float32)
    want_grad = arc.clone().requires_grad_(True)
    DependencyCRF(want_grad, lengths).partition.sum().backward()
    want_table = DependencyCRF(arc, lengths).marginals
    for name in ("dmv_total", "dmv_inside_charts_plain", "dmv_outside_plain",
                 "dmv_value_and_grads_plain"):
        monkeypatch.setattr(dmv_cuda._plain, name, lambda *_: 1 / 0)
    a = arc.to(cuda).requires_grad_(True)
    c0 = dmv_cuda.launch_counts()
    DependencyCRF(a, lengths.to(cuda)).partition.sum().backward()
    c1 = dmv_cuda.launch_counts()
    assert c1["outside"] == c0["outside"] + 1
    assert sum(c1["inside_save"].values()) == sum(c0["inside_save"].values()) + 1
    torch.testing.assert_close(a.grad.cpu(), want_grad.grad, rtol=1e-4, atol=5e-4)
    table = DependencyCRF(arc.to(cuda), lengths.to(cuda)).marginals
    torch.testing.assert_close(table.cpu(), want_table, rtol=1e-4, atol=5e-4)
    c2 = dmv_cuda.launch_counts()
    DependencyCRF(arc.to(cuda), lengths.to(cuda), multiroot=True).marginals
    assert dmv_cuda.launch_counts() == c2


def test_classic_dmv_on_the_card_matches_the_cpu(cuda):
    """The classic DMV's E-step (K3a + K3b through the table gather) and its
    decodes (K1 log then K1 max for MBR, K1 max for Viterbi) against the
    CPU. Counts to 1e-4 + 1e-4|x| (the gather's backward adds with float
    atomics on the card). Each sentence's tokens are distinct, so no two
    trees tie exactly: Viterbi heads equal. The MBR scores (summed
    marginals) differ by a few ulp between card and CPU, so the card's MBR
    heads must form a projective tree that the CPU scores within 1e-4 of
    its own best: equal heads wherever the best tree wins by more."""
    from vlgae_tpu_torch.models import dmv_model
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.struct import DMV1o
    from vlgae_tpu_torch.struct.alg import istree

    rng = np.random.default_rng(8)
    n_token, L = 60, 40
    lengths = torch.tensor([40, 0, 1, 2, *rng.integers(3, 41, 12).tolist()])
    token = torch.tensor(np.stack([rng.permutation(n_token)[:L] for _ in lengths]))
    cfg = dmv_model.DMVConfig(init_method="random", n_token=n_token)
    cpu = dmv_model.init_params(cfg, seed=3, device="cpu")
    card = dmv_model.init_params(cfg, seed=3, device=cuda)
    tok, lens = token.to(cuda), lengths.to(cuda)
    c0 = dmv_cuda.launch_counts()
    got = dmv_model.expected_counts(card, tok, lens)
    c1 = dmv_cuda.launch_counts()
    assert c1["outside"] == c0["outside"] + 1
    assert sum(c1["inside_save"].values()) == sum(c0["inside_save"].values()) + 1
    want = dmv_model.expected_counts(cpu, token, lengths)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4, atol=1e-4)
    before = dmv_cuda.launch_counts()["fused"]
    viterbi = dmv_model.decode(card, tok, lens, mbr=False)
    assert dmv_cuda.launch_counts()["fused"] == before + 1
    assert torch.equal(viterbi.cpu(), dmv_model.decode(cpu, token, lengths, mbr=False))
    mbr = dmv_model.decode(card, tok, lens, mbr=True).cpu()
    assert dmv_cuda.launch_counts()["fused"] == before + 3
    want_mbr = dmv_model.decode(cpu, token, lengths, mbr=True)
    arc = DMV1o(dmv_model.forward(cpu, token), lengths).marginals.sum(-1)

    def score(heads):
        s = torch.gather(arc[:, :, 1:], 1, heads[:, None, :])[:, 0]
        return torch.where(torch.arange(L)[None, :] < lengths[:, None], s, 0.0).sum(-1)

    for h, n in zip(mbr, lengths.tolist()):
        assert n == 0 or istree(h[:n].tolist(), proj=True)
    assert bool((score(mbr) >= score(want_mbr) - 1e-4).all())


def _moe_inputs(T, H, inter, E, k, e0, e1, device, seed=0, live=0.8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, H, generator=g).to(torch.bfloat16)
    sel = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    gates = torch.softmax(torch.randn(T, k, generator=g), -1)
    mask = torch.rand(T, generator=g) < live
    w_in = (0.02 * torch.randn(e1 - e0, 2 * inter, H, generator=g)).to(torch.bfloat16)
    w_out = (0.02 * torch.randn(e1 - e0, H, inter, generator=g)).to(torch.bfloat16)
    return [t.to(device) for t in (x, sel, gates)] + [e0, e1] + [
        t.to(device) for t in (mask, w_in, w_out)]


@pytest.mark.parametrize("T,H,inter,E,k,e0,e1,live", [
    (2560, 4096, 768, 72, 10, 0, 9, 0.8),    # the granite cell's layer
    (37, 128, 64, 8, 3, 2, 6, 0.8),          # a ragged route block and tile
    (300, 256, 128, 72, 10, 63, 72, 0.9),    # the last experts' slice
    (200, 128, 64, 64, 10, 0, 64, 1.0),      # 64 held: every bit of the mask
    (130, 128, 64, 8, 2, 0, 8, 0.0),         # no live position: zeros
])
def test_moe_experts_matches_plain(cuda, T, H, inter, E, k, e0, e1, live):
    """K7 against its plain version on the card: the same f32 sums of
    bf16-exact products in other orders (and now and then another bf16
    rounding of an activation), so within 2e-3 of the largest entry;
    reruns bit-identical; one ``moe.k7`` count a call."""
    from vlgae_tpu_torch.ops import moe
    from vlgae_tpu_torch.utils import trace

    args = _moe_inputs(T, H, inter, E, k, e0, e1, cuda, seed=T + e0, live=live)
    before = trace.counters().get("moe.k7", 0)
    got = moe.moe_experts(*args)
    again = moe.moe_experts(*args)
    torch.cuda.synchronize()
    assert trace.counters()["moe.k7"] == before + 2
    want = moe.moe_experts_plain(*args)
    assert torch.equal(got, again)
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= 2e-3 * scale
    mask = args[5]
    if (~mask).any():
        assert float(got[~mask].abs().max()) == 0
