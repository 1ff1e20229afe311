"""Peaks of the card and the bound of each kernel launch.

Frozen copy of ``chip_smoke.py``'s ``PEAK_BYTES_PER_S``, ``PEAK_FLOPS``,
``bound``, ``dmv_inside_ops``, ``dmv_bound``, of the live-row count of
``_big_k5_timing`` and of ``_k6_bound`` (commit 71fea60). The work is
counted from the inputs of a launch, whatever computes it: each input byte
read once, each output byte written once, the operations these inputs need.
"""

from __future__ import annotations

# one H100 SXM (NVIDIA's data sheet, dense rates): HBM bytes/s and the
# operations/s of f32 outside the tensor cores (TF32 is off in the port)
# and of bf16 on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FLOPS[dtype])


def dmv_inside_ops(lengths) -> int:
    """Operations of the inside pass for these lengths: a span of width w
    has 6 split-point sums of w terms, each term one semiring product and
    one semiring sum."""
    total = 0
    for length in lengths:
        n = int(length) + 1
        total += sum(12 * w * (n - w) for w in range(1, n))
    return total


def dmv_bound(lengths, n1: int, what: str) -> float:
    """Seconds: the bound of a DMV kernel launch at this batch. ``what``:
    "inside" (the total alone), "save" (plus the charts written),
    "outside" (charts, cotangent and total read, both tables written; twice
    the inside pass's operations) or "fused" (inside + outside, the tables
    written)."""
    B = len(lengths)
    potentials = 4 * B * (n1 * 8 + n1 * n1 * 2) + 4 * B
    charts = 4 * B * 4 * n1 * n1 * 2
    ops = dmv_inside_ops(lengths)
    n_bytes, n_ops = {
        "inside": (potentials + 4 * B, ops),
        "save": (potentials + 4 * B + charts, ops),
        "outside": (2 * potentials - 4 * B + charts + 8 * B, 2 * ops),
        "fused": (2 * potentials, 3 * ops),
    }[what]
    return bound_s(n_bytes, n_ops, "f32")


def k5_bound(A: int, V: int, B: int, Q: int, D: int, n_v: int, n_q: int) -> float:
    """Seconds: K5 on the live rows of its masks (``n_v`` of the ``A * V``
    factors, ``n_q`` of the ``B * Q`` caption positions: a masked row gives
    -INF whatever its product), bf16 operands of the live rows and f32
    masks read once, four ``[B, A, Q|V]`` outputs written once, a
    multiply-add per live (factor, position, feature)."""
    return bound_s(2 * (n_v + n_q) * D + 4 * (A * V + B * Q) + 8 * B * A * (Q + V),
                   2 * n_v * n_q * D, "bf16")


def k6_bound(A: int, V: int, B: int, Q: int, D: int, cells: int) -> float:
    """Seconds: K6 for what its winners need: one multiply-add per feature
    and output (dvis, dtxt) for each distinct winning cell (b, a, q, v)."""
    return bound_s(2 * 2 * (A * V + B * Q) * D + 8 * B * A * (Q + V),
                   4 * cells * D, "bf16")


def k6_cells(li, lvi) -> int:
    """The distinct winning cells of K6's index tables (``li [B, A, Q]``,
    the best factor of each position; ``lvi [B, A, V]``, the best position
    of each factor)."""
    import torch

    B, A, Q = li.shape
    V = lvi.shape[2]
    dev = li.device
    ba = torch.arange(B * A, device=dev).view(B, A, 1)
    q_side = (ba * Q + torch.arange(Q, device=dev)) * V + li.long()
    v_side = (ba * Q + lvi.long()) * V + torch.arange(V, device=dev)
    return int(torch.unique(torch.cat([q_side.flatten(), v_side.flatten()])).numel())
