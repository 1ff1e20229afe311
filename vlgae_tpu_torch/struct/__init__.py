"""Structured DP over dependency trees (plain PyTorch + kernel dispatch)."""

from .distributions import DMVTotalFn, dmv_merge, dmv_value_and_grads
from .dmv import NEGINF, dmv_total, dmv_value_and_grads_plain

__all__ = [
    "DMVTotalFn",
    "NEGINF",
    "dmv_merge",
    "dmv_total",
    "dmv_value_and_grads",
    "dmv_value_and_grads_plain",
]
