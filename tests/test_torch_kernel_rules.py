"""What the wrappers of the port's CUDA kernels decide in Python before a
launch, as pure functions of the shapes and the card's opt-in shared memory
(232,448 bytes on an H100): the DMV kernels' chart pitch, bytes of shared
memory per sentence, shared/global thresholds, threads per block and group
widths (``vlgae_tpu_torch.ops.dmv_cuda``), and K5's tiling, image groups,
resident side and staging path
(``vlgae_tpu_torch.ops.match.match_fwd_plan``). The kernels themselves run
on the card only (tests/test_torch_kernels_cuda.py)."""

import pytest

from vlgae_tpu_torch.ops import dmv_cuda, match

H100_OPTIN = 232448
H100_SMS = 132


@pytest.mark.parametrize("n1", [1, 2, 9, 10, 16, 17, 32, 48, 51, 56, 64, 85, 101])
def test_chart_pitch_is_odd_and_spreads_rows_over_banks(n1):
    p = dmv_cuda.chart_pitch(n1)
    assert p % 2 == 1 and n1 <= p <= n1 + 1
    # the lanes of one cell read float pairs a row (2 * p floats) apart:
    # 16 consecutive rows must start on 16 different pairs of the 32 banks
    banks = {(2 * p * t) % 32 for t in range(16)}
    assert len(banks) == 16


@pytest.mark.parametrize("n1,fused,inside", [
    (1, 64 + 8 + 32, 32), (9, 64 * 81 + 8 * 81 + 32 * 9, 32 * 81),
    (10, 64 * 110 + 800 + 320, 32 * 110),
    (51, 64 * 51 * 51 + 8 * 51 * 51 + 32 * 51, 32 * 51 * 51),
    (56, 64 * 56 * 57 + 8 * 56 * 56 + 32 * 56, 32 * 56 * 57)])
def test_shared_memory_bytes_per_sentence(n1, fused, inside):
    """K1 keeps eight charts at the odd pitch and the staged potentials
    (231,168 bytes at n1 = 56, 1,280 under the H100's limit); the inside
    kernel four charts."""
    assert dmv_cuda.fused_smem_bytes(n1) == fused
    assert dmv_cuda.inside_smem_bytes(n1) == inside
    assert dmv_cuda.fused_smem_bytes(56) == 231168 == H100_OPTIN - 1280


@pytest.mark.parametrize("n1,outside,potentials", [
    (1, 64 * 1, 8 + 32), (9, 64 * 81, 8 * 81 + 32 * 9), (10, 64 * 110, 800 + 320),
    (51, 64 * 51 * 51, 8 * 51 * 51 + 32 * 51), (57, 64 * 57 * 57, 8 * 57 * 57 + 32 * 57),
    (64, 64 * 64 * 65, 8 * 64 * 64 + 32 * 64), (101, 64 * 101 * 101, 8 * 101 * 101 + 32 * 101)])
def test_the_pairs_shared_memory_bytes_per_sentence(n1, outside, potentials):
    """The outside kernel keeps the four saved charts and four adjoint charts
    (OCr, OCl, and OA or the incomplete spans' flags OIr, OIl) at the odd
    pitch; the potentials staged beside the charts of either kernel are
    attach [n1][n1][2] and dec [n1][8] f32."""
    assert dmv_cuda.outside_smem_bytes(n1) == outside
    assert dmv_cuda.potential_smem_bytes(n1) == potentials
    optin = H100_OPTIN
    ip, op = dmv_cuda.inside_plan(n1, optin), dmv_cuda.outside_plan(n1, optin)
    charts = {"warp": dmv_cuda.inside_smem_bytes(n1), "smem": dmv_cuda.inside_smem_bytes(n1),
              "global": 0}[ip["mapping"]]
    # the warp mapping: a slice of charts and potentials per sentence (warp)
    sentences = ip["threads"] // 32 if ip["mapping"] == "warp" else 1
    assert ip["smem_bytes"] == sentences * (charts + (potentials if ip["stage"] else 0)) <= optin
    charts = outside if op["mapping"] == "smem" else 0
    assert op["smem_bytes"] == charts + (potentials if op["stage"] else 0) <= optin


# the last n1 of each placement of the pair's kernels: (mapping, staged)
@pytest.mark.parametrize("optin,inside,outside", [
    (H100_OPTIN, {("warp", True): 9, ("smem", True): 75, ("smem", False): 85,
                  ("global", True): 168},
     {("smem", True): 56, ("smem", False): 59, ("global", True): 168}),
    (49152, {("warp", True): 9, ("smem", True): 34, ("smem", False): 39,
             ("global", True): 76},
     {("smem", True): 25, ("smem", False): 27, ("global", True): 76}),
    (101376, {("warp", True): 9, ("smem", True): 49, ("smem", False): 55,
              ("global", True): 110},
     {("smem", True): 37, ("smem", False): 39, ("global", True): 110})])
def test_the_pairs_placements_follow_the_cards_limit(optin, inside, outside):
    """Charts in shared memory while they fit, the potentials staged beside
    them while both fit, else read from global memory; past the last
    threshold charts and potentials both stay in global memory."""
    for plan, lasts in ((dmv_cuda.inside_plan, inside), (dmv_cuda.outside_plan, outside)):
        bounds = sorted(lasts.items(), key=lambda kv: kv[1])
        for n1 in range(1, 200):
            got = plan(n1, optin)
            want = next((k for k, last in bounds if n1 <= last), ("global", False))
            assert (got["mapping"], got["stage"]) == want, (plan.__name__, n1)
    # the wrappers' mapping rules say the same
    for n1 in range(1, 200):
        assert dmv_cuda.outside_mapping(n1, optin) == dmv_cuda.outside_plan(n1, optin)["mapping"]
        assert dmv_cuda.inside_mapping(n1, optin) == dmv_cuda.inside_plan(n1, optin)["mapping"]


@pytest.mark.parametrize("optin,last_fused,last_split,last_inside", [
    (H100_OPTIN, 56, 75, 85), (49152, 25, 34, 39), (101376, 37, 49, 55)])
def test_shared_or_global_thresholds_follow_the_cards_limit(optin, last_fused, last_split,
                                                            last_inside):
    """K1's eight charts sit in shared memory, with the potentials staged
    beside them, while all fit; then its four inside charts alone (the
    adjoint charts in global scratch) while they fit; beyond, all eight go
    to global scratch and the potentials alone are staged while they fit
    (n1 <= 168 on an H100)."""
    last_staged = max(n1 for n1 in range(1, 400)
                      if dmv_cuda.potential_smem_bytes(n1) <= optin)
    for n1 in range(1, 200):
        plan = dmv_cuda.fused_plan(n1, optin)
        want = "smem" if n1 <= last_fused else "split" if n1 <= last_split else "global"
        assert plan["mapping"] == dmv_cuda.fused_mapping(n1, optin) == want
        charts = dmv_cuda.FUSED_SMEM_CHARTS[want]
        assert plan["stage"] == (n1 <= last_staged)
        assert plan["smem_bytes"] == (dmv_cuda.fused_smem_bytes(n1, charts) if charts else
                                      dmv_cuda.potential_smem_bytes(n1) if plan["stage"]
                                      else 0) <= optin
        # the charts not in shared memory: 8 bytes a cell pair each, pitch n1
        assert plan["scratch_bytes"] == 8 * (8 - charts) * n1 * n1
        want = "warp" if n1 <= 9 else "smem" if n1 <= last_inside else "global"
        assert dmv_cuda.inside_mapping(n1, optin) == want
    assert optin != H100_OPTIN or last_staged == 168


@pytest.mark.parametrize("optin", [H100_OPTIN, 101376])
@pytest.mark.parametrize("n1", [55, 56, 57, 58, 64, 65, 74, 75, 76, 77, 101])
def test_k1_split_placement_between_shared_and_global(optin, n1):
    """The placement between K1's ``smem`` (eight charts) and ``global``:
    the four inside charts at the odd pitch in shared memory beside the
    staged potentials, the four adjoint charts in global scratch (32 * n1 *
    n1 bytes a sentence, half of ``global``'s): n1 = 57 to 75 on an H100
    (171,080 bytes at n1 = 65, 227,400 at 75; 235,904 at 76 does not fit),
    38 to 49 on a card of 101,376. Its blocks take six lanes a start, at
    most 512 threads (the kernel's bound with charts in shared memory), a
    quarter of them for the inside pass."""
    pitch = dmv_cuda.chart_pitch(n1)
    four = 32 * n1 * pitch + 8 * n1 * n1 + 32 * n1
    assert dmv_cuda.fused_smem_bytes(n1, 4) == four
    eight = dmv_cuda.fused_smem_bytes(n1)
    plan = dmv_cuda.fused_plan(n1, optin)
    split = eight > optin >= four
    assert (plan["mapping"] == "split") == split
    if optin == H100_OPTIN:
        assert split == (57 <= n1 <= 75)
        assert {65: 171080, 75: 227400, 76: 235904}.get(n1, four) == four
    if split:
        assert plan["stage"] and plan["smem_bytes"] == four
        assert plan["scratch_bytes"] == 32 * n1 * n1
        want = min(dmv_cuda.FUSED_SMEM_MAX_THREADS, 1 << (6 * n1 - 1).bit_length())
        assert plan["threads"] == dmv_cuda.block_threads(n1, optin) == want
        assert plan["inside_threads"] == want // 4
    if plan["mapping"] != "global":
        assert plan["threads"] <= dmv_cuda.FUSED_SMEM_MAX_THREADS


@pytest.mark.parametrize("n1", range(1, 10))
def test_the_warp_plan_stages_each_sentence_in_its_own_slice(n1):
    """The inside kernel's warp mapping (n1 <= 9): a warp a sentence, its
    four charts at the odd pitch and its potentials staged in its own slice
    (3,528 bytes at n1 = 9), ``WARP_SENTENCES_PER_BLOCK`` (one, two or four)
    sentences a block, and even four slices inside the 48 KB a block gets
    without an opt-in, on any card's limit."""
    want = 32 * n1 * (n1 | 1) + 8 * n1 * n1 + 32 * n1
    assert dmv_cuda.warp_smem_bytes(n1) == want
    assert want % 8 == 0  # every slice stays 8-byte aligned for cp.async
    assert dmv_cuda.warp_smem_bytes(9) == 3528
    k = dmv_cuda.WARP_SENTENCES_PER_BLOCK
    assert k in (1, 2, 4)
    for optin in (H100_OPTIN, 101376, 49152):
        assert dmv_cuda.inside_plan(n1, optin) == {
            "mapping": "warp", "stage": True, "smem_bytes": k * want, "threads": 32 * k}
    assert 4 * want <= 48 * 1024


def test_the_warp_fill_holds_one_term_a_lane():
    """``inside_fill_1b<IS_MAX, true>`` keeps a lane's term of a width in
    registers, so every group of the warp mapping must be at least as wide
    as its width's split points: it is for every sentence of n1 <= 9 on 32
    lanes (the power of two at least w), and n1 = 10 would break it (csrc's
    ``kWarpMaxN1``, the wrapper's ``WARP_MAX_N1``)."""
    assert dmv_cuda.WARP_MAX_N1 == 9
    for n in range(1, dmv_cuda.WARP_MAX_N1 + 1):  # positions of a sentence
        for w in range(1, n):
            assert dmv_cuda.group_lanes(n - w, w, 32) >= w, (n, w)
    assert dmv_cuda.group_lanes(10 - 5, 5, 32) < 5


@pytest.mark.parametrize("n1", range(1, 10))
def test_the_warp_mapping_saves_every_cell_once_by_rows(n1):
    """``save_chart_rows`` of csrc/dmv_inside.cu at nt = 32 with 1 << lg
    lanes a row (lg = 32 - __clz(n1 - 1): the power of two at least n1), and
    as the block mappings call it (lg = 5): every float pair of the four
    saved charts is stored once."""
    lg = (n1 - 1).bit_length()
    assert 1 << lg >= n1 and (n1 == 1 or 1 << (lg - 1) < n1)
    for lg_, nt in ((lg, 32), (5, 32), (5, 128)):
        stores = []
        for tid in range(nt):
            lane = tid & ((1 << lg_) - 1)
            for chart in range(4):
                for w in range(tid >> lg_, n1, nt >> lg_):
                    stores += [(chart, w, i) for i in range(lane, n1, 1 << lg_)]
        assert sorted(stores) == [(c, w, i) for c in range(4) for w in range(n1)
                                  for i in range(n1)]


@pytest.mark.parametrize("n1,want", [
    (1, 32), (4, 32), (5, 32), (9, 64), (10, 64), (17, 128), (32, 128),
    (33, 256), (51, 256), (57, 512), (64, 512), (65, 512), (75, 512), (76, 512),
    (101, 1024), (400, 1024)])
def test_block_threads_is_a_power_of_two_by_n1(n1, want):
    """K1's block, all of which runs its outside pass: about four lanes a
    start position with all charts in shared memory, six with the adjoint
    charts in global scratch (``split``) and with all in global scratch
    (chosen on the card by scripts/tune_torch_dmv_threads.py)."""
    t = dmv_cuda.block_threads(n1, H100_OPTIN)
    assert t == want and t & (t - 1) == 0 and 32 <= t <= dmv_cuda.MAX_THREADS
    assert dmv_cuda.block_threads(n1 + 1, H100_OPTIN) >= t
    assert dmv_cuda.fused_plan(n1, H100_OPTIN)["threads"] == t


@pytest.mark.parametrize("n1,want", [
    (1, 32), (10, 32), (16, 32), (17, 32), (32, 32), (33, 64), (51, 64),
    (57, 128), (64, 128), (65, 128), (75, 128), (101, 256), (129, 256), (400, 256)])
def test_inside_threads_is_one_lane_a_cell(n1, want):
    """The first threads of K1's block, which run its inside pass on a named
    barrier: a quarter of the block, at least a warp (one to three lanes a
    start position at n1 = 17 to 101)."""
    t = dmv_cuda.inside_threads(n1, H100_OPTIN)
    assert t == want and t & (t - 1) == 0 and 32 <= t <= dmv_cuda.MAX_THREADS
    # never more than K1's block, whose first threads run the inside fill
    block = dmv_cuda.block_threads(n1, H100_OPTIN)
    assert t == max(32, block // 4) and t <= block
    assert t >= min(n1, 256)
    assert dmv_cuda.fused_plan(n1, H100_OPTIN)["inside_threads"] == t


@pytest.mark.parametrize("n1,inside,outside", [
    (10, 32, 64), (16, 32, 64), (17, 64, 128), (32, 64, 128), (33, 128, 256),
    (51, 128, 256), (57, 128, 256), (59, 128, 256), (60, 128, 512), (64, 128, 512),
    (65, 256, 1024), (85, 256, 1024), (86, 512, 1024), (101, 512, 1024),
    (129, 1024, 1024), (400, 1024, 1024)])
def test_the_pairs_threads_by_n1(n1, inside, outside):
    """Threads per block of the pair's one-barrier kernels on an H100 (chosen
    on the card by scripts/tune_torch_dmv_threads.py): the inside kernel
    about two lanes a task with charts in shared memory, four in global
    memory; the outside kernel four and eight. K1's block takes four and six
    (``block_threads``), its inside pass a quarter of it
    (``inside_threads``)."""
    got = (dmv_cuda.inside_block_threads(n1, H100_OPTIN),
           dmv_cuda.outside_threads(n1, H100_OPTIN))
    assert got == (inside, outside)
    assert dmv_cuda.inside_plan(n1, H100_OPTIN)["threads"] == inside
    assert dmv_cuda.outside_plan(n1, H100_OPTIN)["threads"] == outside
    for t in got:
        assert t & (t - 1) == 0 and 32 <= t <= dmv_cuda.MAX_THREADS


@pytest.mark.parametrize("ntasks,nterms,threads,want", [
    (50, 1, 512, 1), (50, 50, 512, 8), (26, 25, 512, 16), (100, 25, 512, 4),
    (5, 46, 512, 32), (2, 100, 1024, 32), (8, 8, 32, 4), (1, 3, 32, 4),
    (600, 40, 512, 1)])
def test_group_lanes(ntasks, nterms, threads, want):
    assert dmv_cuda.group_lanes(ntasks, nterms, threads) == want


def test_the_card_tests_reach_every_group_width():
    """The n1 of tests/test_torch_kernels_cuda.py's DMV cases, with the
    threads their mapping gives them, use every sub-warp width from one
    lane to a whole warp: in K1's inside and outside passes (in each of its
    three placements: the split one's cases at n1 = 57, 58, 65, 74, 75;
    the global one's at 81 and 101), and
    in the one-barrier fills of every mapping of the inside kernel (the warp
    mapping's n1 at 32 lanes: widths 1 to 8) and of the outside kernel."""
    by_mapping = {}
    for n1 in (2, 3, 5, 9, 10, 17, 51, 57, 58, 65, 74, 75, 81, 101):
        plan = dmv_cuda.fused_plan(n1, H100_OPTIN)
        ins, outs = by_mapping.setdefault(plan["mapping"], (set(), set()))
        ins |= dmv_cuda.inside_1b_group_widths(n1, plan["inside_threads"])
        outs |= dmv_cuda.outside_1b_group_widths(n1, plan["threads"])
    assert set(by_mapping) == {"smem", "split", "global"}
    for mapping, (k1_inside, k1_outside) in by_mapping.items():
        assert k1_inside == k1_outside == {1, 2, 4, 8, 16, 32}, mapping
    inside, outside = set(), set()
    for n1 in (1, 2, 3, 5, 9):
        assert dmv_cuda.inside_plan(n1, H100_OPTIN)["mapping"] == "warp"
        inside |= dmv_cuda.inside_1b_group_widths(n1, 32)
    assert inside == {1, 2, 4, 8}
    for n1 in (10, 17, 51, 57, 85, 86, 100):
        threads = dmv_cuda.inside_block_threads(n1, H100_OPTIN)
        inside |= dmv_cuda.inside_1b_group_widths(n1, threads)
    for n1 in (1, 2, 3, 5, 9, 10, 17, 51, 57, 85, 86, 100):
        threads = dmv_cuda.outside_threads(n1, H100_OPTIN)
        outside |= dmv_cuda.outside_1b_group_widths(n1, threads)
    assert inside == outside == {1, 2, 4, 8, 16, 32}


def test_k1_runs_the_one_barrier_fills_alone():
    """K1 (csrc/dmv_fused.cu) reaches the fills only through
    ``inside_fill_1b`` and ``outside_fill_1b``, and csrc/dmv_common.cuh
    defines no other fill: the two-barrier ``inside_fill`` / ``outside_fill``
    (and ``OutsideCharts``, ``sync_group``, which served them alone) are
    gone."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(dmv_cuda.__file__), os.pardir, "csrc")

    def code(name):  # the source without its comments
        text = open(os.path.join(csrc, name)).read()
        return re.sub(r"//[^\n]*", "", text)

    fused, common = code("dmv_fused.cu"), code("dmv_common.cuh")
    assert set(re.findall(r"\b(\w+_fill\w*)\s*<", fused)) == {"inside_fill_1b",
                                                              "outside_fill_1b"}
    defined = set(re.findall(r"\b(\w+_fill\w*)\s*\(", common))
    assert defined == {"inside_fill_1b", "outside_fill_1b"}
    for gone in ("OutsideCharts", "sync_group", "complete_adjoint_step"):
        assert not re.search(rf"\b{gone}\b", common + fused), gone
    assert "log-marginal" in open(os.path.join(csrc, "dmv_fused.cu")).read()


def test_match_fwd_plan_at_the_recipes_shapes():
    for V, tiles in ((703, 11), (739, 12)):
        plan = match.match_fwd_plan(64, V, 64, 102, 128)
        # one chunk of 104 words, on PR 4's kernel: 16 tiles of 4 captions x
        # 8 image groups: 128 blocks on 132 multiprocessors, each serving 8
        # images
        assert plan["kernel"] == "generic" and plan["staging"] == "cp.async"
        assert plan["grid"] == (8, 16) and plan["cap_tile"] == 4
        assert plan["resident"] == "captions" and plan["work_items"] == 16 * 64
        assert (plan["q_chunks"], plan["v_tiles"], plan["k_chunks"]) == (1, tiles, 1)
        assert plan["q_chunk_words"] == 104
        assert plan["smem_bytes"] == 185984 <= H100_OPTIN
        # every block streams its 8 images once and stages its four captions once
        assert plan["l2_to_smem_bytes"] == 2 * 128 * 16 * (64 * V + 8 * 4 * 102)


def test_match_fwd_plan_takes_the_patch_grid_in_one_pass():
    for V, tiles in ((1324, 21), (1275, 20)):
        plan = match.match_fwd_plan(64, V, 64, 130, 128)
        # the TMA kernel: 32 tiles of 2 captions x 4 image groups, 16 images
        # a block, each streamed once for all 130 words
        assert plan["kernel"] == "tma" and plan["staging"] == "tma"
        assert (plan["q_chunks"], plan["q_chunk_words"]) == (1, 136)
        assert plan["grid"] == (4, 32) and plan["v_tiles"] == tiles
        assert plan["smem_bytes"] == 180384 <= H100_OPTIN
        assert plan["l2_to_smem_bytes"] == 2 * 128 * 32 * (64 * V + 4 * 2 * 130)
    # exp=vlgae_vit's captions (up to 63 words, padded to 64: Q <= 130) all
    # take one pass
    for words in range(8, 65, 8):
        assert match.match_fwd_q_tiling(2 * (words + 1))[0] == 1


@pytest.mark.parametrize("Q,kernel,chunks,words", [
    (34, "generic", 1, 40), (66, "generic", 1, 72), (102, "generic", 1, 104),
    (104, "generic", 1, 104), (105, "tma", 1, 120), (114, "tma", 1, 120),
    (120, "tma", 1, 120), (121, "tma", 1, 136), (130, "tma", 1, 136), (136, "tma", 1, 136),
    (137, "generic", 2, 72), (208, "generic", 2, 104), (209, "tma", 2, 120),
    (241, "tma", 2, 136), (3306, "tma", 25, 136)])
def test_match_fwd_tma_kernel_takes_chunks_of_120_and_136_words(Q, kernel, chunks, words):
    """Chunks of 120 and 136 words go to the TMA kernel; narrower ones to PR
    4's kernel, which no TMA design timed at 40-104 words beat."""
    plan = match.match_fwd_plan(64, 739, 64, Q, 128)
    assert (plan["kernel"], plan["q_chunks"], plan["q_chunk_words"]) == (kernel, chunks, words)
    assert plan["cap_tile"] == (2 if kernel == "tma" else 4)


@pytest.mark.parametrize("A,B,sms,cap,want", [
    (64, 64, 132, 4, 8), (64, 64, 66, 4, 4), (64, 64, 264, 4, 16), (64, 4, 132, 4, 64),
    (5, 200, 132, 4, 2), (3, 1000, 132, 4, 1), (1, 1, 132, 4, 1), (64, 61, 132, 4, 8),
    (7, 0, 132, 4, 7), (0, 5, 132, 4, 1),
    (64, 64, 132, 2, 4), (64, 32, 132, 2, 8), (64, 16, 132, 2, 16), (64, 8, 132, 2, 33),
    (64, 63, 132, 2, 4), (3, 5, 132, 2, 3)])
def test_match_fwd_groups_fill_the_card_once(A, B, sms, cap, want):
    g = match.match_fwd_groups(A, B, sms, cap)
    assert g == want and 1 <= g <= max(1, A)
    # about one block a multiprocessor, unless one block per image is fewer
    if 0 < -(-B // cap) <= sms and g < A:
        assert sms // 2 < g * -(-B // cap) <= sms


@pytest.mark.parametrize("B,V,Q", [
    (64, 703, 102), (64, 739, 102), (64, 739, 114), (64, 1324, 130), (64, 1275, 130),
    (64, 739, 34), (64, 739, 66), (64, 739, 3306),
    (32, 739, 114), (16, 739, 114), (8, 739, 114)])
def test_match_fwd_grid_gives_every_multiprocessor_work(B, V, Q):
    """A = 64 images against the whole batch (the shapes K5 runs at) and a
    rank's shard at world 2, 4 and 8 (B = 32, 16, 8 at the recipe's longest
    captions): at least 132 work items (caption tile, image), and a grid of
    one block a multiprocessor but for less than one column of caption
    tiles, whose blocks serve numbers of images that differ by one at most."""
    plan = match.match_fwd_plan(64, V, B, Q, 128, sm_count=H100_SMS)
    groups, cap_tiles = plan["grid"]
    assert plan["work_items"] == cap_tiles * 64 >= H100_SMS
    assert H100_SMS - cap_tiles < groups * cap_tiles <= H100_SMS
    per_block = [len(range(x, 64, groups)) for x in range(groups)]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("Q,chunks,words", [
    (1, 1, 40), (18, 1, 40), (34, 1, 40), (40, 1, 40), (41, 1, 72), (50, 1, 72),
    (66, 1, 72), (72, 1, 72), (73, 1, 104), (82, 1, 104), (98, 1, 104),
    (102, 1, 104), (104, 1, 104), (105, 1, 120), (114, 1, 120), (120, 1, 120),
    (121, 1, 136), (129, 1, 136), (130, 1, 136), (136, 1, 136), (137, 2, 72),
    (144, 2, 72), (145, 2, 104), (202, 2, 104), (208, 2, 104), (209, 2, 120),
    (240, 2, 120), (241, 2, 136), (272, 2, 136), (273, 3, 104), (312, 3, 104),
    (313, 3, 120), (408, 3, 136), (409, 4, 104), (3306, 25, 136)])
def test_match_fwd_q_tiling_wastes_few_columns(Q, chunks, words):
    """Captions are padded to multiples of 8 words and Q = 2 * (length + 1):
    18, 34, ..., 114 on exp=vlgae, 130 on exp=vlgae_vit, one chunk each (130
    and the widest build's 136 in one pass, 137 in two); 3,306 (word+alldep)
    in 25. Beyond the widest build equal chunks; never a wide chunk for a
    few words left over."""
    got = match.match_fwd_q_tiling(Q)
    assert got == (chunks, words // 8) and words // 8 in match.FWD_Q_GROUPS
    assert chunks == -(-Q // 136) and chunks * words >= Q
    # a chunk wastes less than the widest step between two builds plus a group
    assert chunks * words - Q < (32 + 8) * chunks


@pytest.mark.parametrize("Q,chunks,words", [(114, 1, 120), (121, 2, 72), (130, 2, 72),
                                            (3306, 28, 120)])
def test_match_fwd_q_tiling_of_the_other_kernel(Q, chunks, words):
    """Rows the TMA kernel does not take (D > 128, or not 16-byte aligned)
    go to the other kernel, built up to 120 words."""
    assert match.match_fwd_q_tiling(Q, match.FWD_GENERIC_Q_GROUPS) == (chunks, words // 8)
    plan = match.match_fwd_plan(3, 70, 5, Q, 136)
    assert (plan["kernel"], plan["q_chunks"], plan["q_chunk_words"]) == ("generic", chunks,
                                                                         words)


def test_match_fwd_smem_fits_the_card_at_every_chunk_width():
    # the TMA kernel: the ring of 6 image tiles and their image biases, the
    # two resident captions and their word biases, 4 column candidates a
    # word and consumer warpgroup, a full and an empty barrier a stage, the
    # 1024-byte alignment
    for nt in match.FWD_TMA_Q_GROUPS:
        words = 8 * nt
        parts = (6 * 64 * 256, 6 * 64 * 4, 2 * words * 256, 2 * words * 4,
                 2 * 4 * words * 8, 2 * 6 * 8, 1024)
        assert match.match_fwd_smem_bytes(nt) == sum(parts) <= H100_OPTIN
        assert match.match_fwd_plan(2, 70, 5, words, 64)["smem_bytes"] == sum(parts)
    assert match.match_fwd_smem_bytes(17) == 180384
    # the other kernel
    sizes = [match.match_fwd_smem_bytes(nt, "cp.async") for nt in match.FWD_GENERIC_Q_GROUPS]
    assert sizes == sorted(sizes) and sizes[-1] == 206720 <= H100_OPTIN
    assert all(match.match_fwd_plan(2, 70, 5, 8 * nt, 136)["smem_bytes"] == s
               for nt, s in zip(match.FWD_GENERIC_Q_GROUPS, sizes))


@pytest.mark.parametrize("shape,want", [
    # (A, V, B, Q, D): image groups, tiles of 2 captions (the TMA kernel,
    # chunks of 120 or 136 words) or 4 (the other, up to 120), image tiles of
    # 64 rows, k-chunks of 128
    ((5, 65, 62, 202, 130), (5, 16, 2, 2, 2)),
    ((3, 64, 4, 104, 128), (3, 1, 1, 1, 1)), ((3, 64, 7, 120, 128), (3, 4, 1, 1, 1)),
    ((3, 63, 5, 105, 129), (3, 2, 1, 1, 2)), ((3, 63, 5, 121, 129), (3, 2, 2, 1, 2)),
    ((1, 1, 1, 1, 8), (1, 1, 1, 1, 1)),
    ((2, 20, 3, 9, 384), (2, 1, 1, 1, 3)),
    ((5, 70, 200, 9, 16), (2, 50, 1, 2, 1)),
    ((3, 1324, 5, 130, 128), (3, 3, 1, 21, 1)), ((64, 1324, 64, 130, 128), (4, 32, 1, 21, 1)),
    ((2, 70, 5, 137, 128), (2, 2, 2, 2, 1))])
def test_match_fwd_plan_counts_ragged_tiles(shape, want):
    plan = match.match_fwd_plan(*shape)
    got = (*plan["grid"], plan["q_chunks"], plan["v_tiles"], plan["k_chunks"])
    assert got == want


@pytest.mark.parametrize("D,vis_ptr,txt_ptr,want", [
    (128, 0, 0, "tma"), (8, 256, 512, "tma"), (64, 16, 32, "tma"), (136, 0, 0, "cp.async"),
    (384, 16, 32, "cp.async"), (130, 0, 0, "scalar"), (7, 0, 0, "scalar"),
    (128, 8, 0, "scalar"), (128, 0, 2, "scalar")])
def test_match_fwd_staging_needs_16_byte_rows(D, vis_ptr, txt_ptr, want):
    plan = match.match_fwd_plan(4, 33, 6, 120, D, vis_ptr, txt_ptr)
    assert plan["staging"] == want
    assert plan["kernel"] == ("tma" if want == "tma" else "generic")


def test_match_fwd_tma_kernel_takes_rows_whose_index_fits_16_bits():
    """The TMA kernel keeps a column's winning image row in 16 bits."""
    assert match.match_fwd_plan(2, 65536, 3, 130, 128)["kernel"] == "tma"
    plan = match.match_fwd_plan(2, 65537, 3, 130, 128)
    assert (plan["kernel"], plan["staging"]) == ("generic", "cp.async")


@pytest.mark.parametrize("V,Q", [(739, 102), (703, 102), (739, 114), (739, 34)])
def test_match_bwd_plan_at_the_recipes_shapes(V, Q):
    """K6 at A = B = 64, D = 128: the lists hold one int per cell of each
    direction's index table, the row starts N+1 per group, a mark a segment,
    and the workspace two partial rows a segment; together under 32 MB, with
    no workspace of max(4·A·V·D, 16·B·Q·D) floats (97 MB at V = 739)."""
    plan = match.match_bwd_plan(64, V, 64, Q, 128)
    assert plan["positions"] == 64 * 64 * (V + Q)
    per = -(-plan["positions"] // match.BWD_SEGMENT)
    assert plan["segments"] == 2 * per
    assert plan["layout"] == {"list_vis": (64, 64 * Q), "list_txt": (64, 64 * V),
                              "starts_vis": (64 * (V + 1) + 1,),
                              "starts_txt": (64 * (Q + 1) + 1,), "marks": (2 * per,)}
    lists = 64 * 64 * (Q + V)
    assert plan["ints"] == lists + 64 * (V + 1) + 1 + 64 * (Q + 1) + 1 + 2 * per
    assert plan["workspace_floats"] == 2 * 2 * per * 128
    assert plan["workspace_floats"] <= lists
    assert plan["bytes"] == 4 * (plan["ints"] + plan["workspace_floats"]) < 32 * 2 ** 20
    assert plan["bytes"] < 4 * max(4 * 64 * V * 128, 16 * 64 * Q * 128)
    assert plan["features"] == "vec4"
    assert plan["build_warps"] == (32, 32)
    assert plan["build_smem"] == 4 * 33 * (V + 1) <= match.BWD_BUILD_SMEM <= H100_OPTIN


def test_match_bwd_plan_at_the_training_shape_in_bytes():
    plan = match.match_bwd_plan(64, 739, 64, 102, 128)
    lists = plan["layout"]["list_vis"], plan["layout"]["list_txt"]
    assert 4 * sum(g * n for g, n in lists) == 13_778_944 and plan["bytes"] == 27_827_528


@pytest.mark.parametrize("D,vis_ptr,txt_ptr,want", [
    (128, 0, 0, "vec4"), (8, 256, 8, "vec4"), (384, 8, 16, "vec4"), (4, 0, 0, "vec4"),
    (130, 0, 0, "scalar"), (7, 0, 0, "scalar"), (128, 2, 0, "scalar"),
    (128, 0, 4, "scalar")])
def test_match_bwd_loads_8_bytes_a_lane_only_on_aligned_rows(D, vis_ptr, txt_ptr, want):
    assert match.match_bwd_plan(4, 33, 6, 31, D, vis_ptr, txt_ptr)["features"] == want


@pytest.mark.parametrize("n_rows,warps", [(1, 32), (102, 32), (739, 32), (1500, 15),
                                          (6000, 3), (12286, 1)])
def test_match_bwd_build_warps_fit_their_counts_in_shared_memory(n_rows, warps):
    plan = match.match_bwd_plan(2, n_rows, 3, 1, 16)
    assert plan["build_warps"][0] == warps
    assert plan["build_smem"] == 4 * (warps + 1) * (n_rows + 1) <= match.BWD_BUILD_SMEM


def test_match_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="D <= 384"):
        match.match_bwd_plan(2, 9, 3, 6, 385)
    with pytest.raises(ValueError, match="V, Q <="):
        match.match_bwd_plan(2, 12288, 3, 6, 16)
    with pytest.raises(ValueError, match="overflow"):
        match.match_bwd_plan(4096, 4096, 128, 100, 16)


def test_k1_holds_a_lanes_terms_within_the_cap_and_the_card_tests_reach_both_paths():
    """K1's log fills (the FUSED path of csrc/dmv_common.cuh) keep a lane's
    terms of a task in registers for the sums, instead of reading their
    cells again, when the block-uniform bound ceil(terms / G) is at most
    ``kRegTerms``: w split points in the inside pass, and len - w for each
    of the outside pass's two loops (len - i - w wider spans and i spans
    from the left); half that with the adjoint charts in global scratch,
    and none with all charts there (``kHold`` of csrc/dmv_fused.cu: what a
    thread's registers take without a spill). Under that bound no lane of
    any task has more terms than the cap; and the n1 of
    tests/test_torch_kernels_cuda.py's K1 cases, at their longest sentence,
    reach both the held and the re-read path in both passes where K1 holds
    terms (``smem``, ``split``)."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(dmv_cuda.__file__), os.pardir, "csrc")
    common = open(os.path.join(csrc, "dmv_common.cuh")).read()
    regs = int(re.search(r"constexpr int kRegTerms = (\d+);", common).group(1))
    assert regs == 4
    fused = open(os.path.join(csrc, "dmv_fused.cu")).read()
    hold = "constexpr int kHold = SMEM_CHARTS == 8 ? kRegTerms : SMEM_CHARTS == 4 ? kRegTerms / 2 : 0;"
    assert hold in fused

    def lanes_terms(count, G):  # terms of each lane of a group, strided by G
        return [len(range(gl, count, G)) for gl in range(G)]

    reached = {}
    for n1 in (9, 10, 17, 51, 57, 58, 65, 74, 75, 81, 101):
        plan = dmv_cuda.fused_plan(n1, H100_OPTIN)
        paths = reached.setdefault(plan["mapping"], set())
        cap = {"smem": regs, "split": regs // 2, "global": 0}[plan["mapping"]]
        length = n1 - 1
        n = length + 1
        for w in range(1, n):
            G = dmv_cuda.group_lanes(n - w, w, plan["inside_threads"])
            held = cap > 0 and -(-w // G) <= cap
            paths.add(("inside", held))
            assert not held or max(lanes_terms(w, G)) <= cap
        for w in range(length, -1, -1):
            G = dmv_cuda.group_lanes(n - w, length - w + 1, plan["threads"])
            held = cap > 0 and -(-(length - w) // G) <= cap
            paths.add(("outside", held))
            if held:
                for i in range(n - w):
                    assert max(lanes_terms(length - i - w, G) + lanes_terms(i, G)) <= cap
    both = {(p, h) for p in ("inside", "outside") for h in (True, False)}
    assert reached == {"smem": both, "split": both,
                       "global": {("inside", False), ("outside", False)}}
