"""Percent of the traced stretch in which no operation ran on the device."""


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    tl = ctx["timeline"]
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
