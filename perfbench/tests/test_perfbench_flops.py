"""The frozen bound arithmetic against hand counts on tiny shapes and
against the program's own script, and the model count's pieces."""

import sys

import pytest
import torch

from perfbench.core import manifest
from perfbench.flops import bounds, model


def test_dmv_inside_ops_by_hand():
    # n = 2 words: widths 1, 2 of n + 1 = 3 positions: 12 * (1 * 2 + 2 * 1)
    assert bounds.dmv_inside_ops([2]) == 48
    assert bounds.dmv_inside_ops([0, 1]) == 12


@pytest.mark.parametrize("what", ["inside", "save", "outside", "fused"])
def test_dmv_bound_matches_chip_smoke(what):
    sys.path.insert(0, manifest.ROOT)
    import chip_smoke

    lengths = [3, 7, 0, 12, 5]
    want = chip_smoke.dmv_bound(lengths, 13, what)["bound_ms"] / 1e3
    assert bounds.dmv_bound(lengths, 13, what) == pytest.approx(want, rel=1e-12)


def test_k5_and_k6_bounds_by_hand():
    A, V, B, Q, D = 2, 3, 2, 4, 8
    by_bytes = (2 * (5 + 6) * D + 4 * (A * V + B * Q) + 8 * B * A * (Q + V)) / bounds.PEAK_BYTES_PER_S
    by_ops = 2 * 5 * 6 * D / bounds.PEAK_FLOPS["bf16"]
    assert bounds.k5_bound(A, V, B, Q, D, 5, 6) == pytest.approx(max(by_bytes, by_ops))
    li = torch.zeros(B, A, Q, dtype=torch.int32)  # every position's best factor is 0
    lvi = torch.zeros(B, A, V, dtype=torch.int32)  # every factor's best position is 0
    # cells (q, 0) for every q and (0, v) for every v: Q + V - 1 a (b, a)
    assert bounds.k6_cells(li, lvi) == B * A * (Q + V - 1)


def test_transformer_ops_by_hand():
    # one layer, S = 2, H = 4, I = 8: 2*2*(4*16 + 2*4*8) + 4*4*4
    assert model.transformer_ops(2, 4, 1, 8) == 2 * 2 * (64 + 64) + 64


def test_step_ops_by_hand():
    w = {"bert": {"hidden_size": 8, "num_hidden_layers": 1, "intermediate_size": 16},
         "hidden": 4, "match_hidden": 2, "feat_dim": 6, "tag_dim": 2, "rank": 2,
         "mid_bottleneck": 3, "n_token": 5}
    rec = {"seq_len": [3, 5], "subword_len": [6, 9], "boxes": [4, 4],
           "k5_live": [(10, 12, 2)], "D": 2}
    ev = model.step_ops(w, rec, False)
    tr = model.step_ops(w, dict(rec, k6_cells=[30]), True)
    heads = 2 * 3 * 2 * 4 * 12 * 4  # two captions' images, three bf16 heads
    assert ev["bf16"] == heads + 2 * 10 * 12 * 2
    assert tr["bf16"] == 3 * heads + 2 * 10 * 12 * 2 + 4 * 30 * 2
    bert = model.transformer_ops(6, 8, 1, 16) + model.transformer_ops(9, 8, 1, 16)
    dp = 2 * 3 * bounds.dmv_inside_ops([3, 5])
    assert tr["f32"] > ev["f32"] > bert + dp
