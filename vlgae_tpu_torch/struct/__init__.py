"""Structured DP over dependency trees (plain PyTorch + kernel dispatch)."""

from .distributions import (DMV1o, DMVTotalFn, dmv_merge, dmv_total_fast,
                            dmv_value_and_grads)
from .dmv import (NEGINF, dmv_inside_charts_plain, dmv_outside_plain, dmv_total,
                  dmv_value_and_grads_plain)

__all__ = [
    "DMV1o",
    "DMVTotalFn",
    "NEGINF",
    "dmv_inside_charts_plain",
    "dmv_merge",
    "dmv_outside_plain",
    "dmv_total",
    "dmv_total_fast",
    "dmv_value_and_grads",
    "dmv_value_and_grads_plain",
]
