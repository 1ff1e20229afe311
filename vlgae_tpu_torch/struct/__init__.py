"""Structured DP over dependency trees (plain PyTorch + kernel dispatch)."""

from .deptree import (deptree_marginals, deptree_nonproj_marginals,
                      deptree_nonproj_partition, deptree_partition)
from .distributions import (DependencyCRF, DMV1o, DMVTotalFn, deptree_grads_fast,
                            deptree_total_fast, dmv_merge, dmv_total_fast,
                            dmv_value_and_grads, eisner_as_dmv)
from .dmv import (GO, HASCHILD, LEFT, NEGINF, NOCHILD, RIGHT, STOP,
                  dmv_inside_charts_plain, dmv_outside_plain, dmv_total,
                  dmv_value_and_grads_plain)

__all__ = [
    "DMV1o",
    "DMVTotalFn",
    "DependencyCRF",
    "GO",
    "HASCHILD",
    "LEFT",
    "NEGINF",
    "NOCHILD",
    "RIGHT",
    "STOP",
    "deptree_grads_fast",
    "deptree_marginals",
    "deptree_nonproj_marginals",
    "deptree_nonproj_partition",
    "deptree_partition",
    "deptree_total_fast",
    "dmv_inside_charts_plain",
    "dmv_merge",
    "dmv_outside_plain",
    "dmv_total",
    "dmv_total_fast",
    "dmv_value_and_grads",
    "dmv_value_and_grads_plain",
    "eisner_as_dmv",
]
