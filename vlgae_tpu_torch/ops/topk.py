"""Exact top-k by iterated argmax (counterpart of vlgae_tpu/ops/topk.py).

``torch.argmax`` returns the first maximal index, so the i-th pass picks
the i-th element of a tie plateau in ascending index order — the order of
the reference. ``torch.topk`` leaves tie order unspecified and is not used.
"""

from __future__ import annotations

import torch


def exact_top_k(x, k: int):
    """Top-k values and int32 indices over the last axis, ties to the
    smallest index. For NaN-free floating inputs and small k."""
    if k <= 0:
        raise ValueError(f"exact_top_k needs k >= 1, got {k}")
    V = x.shape[-1]
    if k > V:
        raise ValueError(f"exact_top_k: k={k} > lane width {V}")
    if not x.is_floating_point():
        raise TypeError(f"exact_top_k supports floating dtypes only, got {x.dtype}")
    # the selection copy is clamped to the finite minimum so masked-out
    # winners (set to -inf) sort strictly below every remaining entry
    w = torch.clamp_min(x, torch.finfo(x.dtype).min)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(w, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i)[..., 0])
        idxs.append(i[..., 0].int())
        w = w.scatter(-1, i, float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)
