"""Percent of the card's peak that the model's needed operations (counted
on the real rows by ``perfbench.flops.model``, each at the peak of its
precision) take of the traced stretch's mean step time."""

from ..flops.model import ideal_s, step_ops


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    tl = ctx["timeline"]
    k = ctx["bounds"]
    ideal = 0.0
    for i, rec in enumerate(ctx["steps"]):
        rec = dict(rec, k5_live=k["k5_live"][i:i + 1],
                   k6_cells=k["k6_cells"][i:i + 1], D=ctx["widths"]["match_hidden"])
        ideal += ideal_s(step_ops(ctx["widths"], rec, part == "train"))
    return 100.0 * ideal / tl["window_s"]
