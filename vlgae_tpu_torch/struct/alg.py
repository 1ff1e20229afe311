"""Tree predicates (host-side NumPy; copied from vlgae_tpu/struct/alg.py)."""

from __future__ import annotations


def isprojective(heads) -> bool:
    """Projectivity check incl. partial annotation.

    ``heads``: 1-based head ids per word; ``-1`` = unannotated; 0 = root.
    """
    pairs = [(h, d) for d, h in enumerate(heads, 1) if h >= 0]
    for i, (hi, di) in enumerate(pairs):
        for hj, dj in pairs[i + 1:]:
            (li, ri), (lj, rj) = sorted([hi, di]), sorted([hj, dj])
            if li <= hj <= ri and hi == dj:
                return False
            if lj <= hi <= rj and hj == di:
                return False
            if (li < lj < ri or li < rj < ri) and (li - lj) * (ri - rj) > 0:
                return False
    return True
