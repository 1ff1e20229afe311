"""Percent of the card's peak that the model's needed operations (counted
on the real rows by the configuration's family, each at the peak of its
precision) take of the traced stretch's mean step time."""

from ..flops.bounds import PEAK_FLOPS


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    ideal = sum(sum(n / PEAK_FLOPS[k] for k, n in ops.items()) for ops in ctx["step_ops"])
    return 100.0 * ideal / ctx["timeline"]["window_s"]
