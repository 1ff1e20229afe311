"""Loss reduction and scheduled coefficients (counterpart of
vlgae_tpu/utils/fn.py)."""

from __future__ import annotations

import re
from typing import List


def reduce_loss(loss, num_token, batch_size, mode: str = "token"):
    """Loss normalisation: per token, per sentence, or the plain sum."""
    if mode == "token":
        return loss / num_token
    if mode == "batch":
        return loss / batch_size
    if mode == "sum":
        return loss
    raise ValueError(mode)


_COEFF_ITEM = re.compile(r"\s*([-+0-9.eE]+)\s*@\s*(\d+)\s*")


def parse_coeff_schedule(command) -> List[tuple]:
    """Parse a piecewise-linear schedule such as ``"[0@0, 0.5@100]"``
    (value@epoch); a plain number is a constant."""
    if isinstance(command, (int, float)):
        return [(float(command), 0)]
    s = str(command).strip()
    if not s.startswith("["):
        return [(float(s), 0)]
    points = []
    for item in s.strip("[]").split(","):
        m = _COEFF_ITEM.fullmatch(item)
        if not m:
            raise ValueError(f"bad coeff item: {item!r}")
        points.append((float(m.group(1)), int(m.group(2))))
    if any(p0[1] >= p1[1] for p0, p1 in zip(points, points[1:])):
        raise ValueError(f"schedule epochs must increase: {command!r}")
    return points


def coeff_at(points: List[tuple], idx: int) -> float:
    """Evaluate a piecewise-linear schedule at ``idx``."""
    if idx <= points[0][1]:
        return points[0][0]
    for (v0, e0), (v1, e1) in zip(points, points[1:]):
        if idx <= e1:
            t = (idx - e0) / (e1 - e0)
            return v0 + t * (v1 - v0)
    return points[-1][0]
