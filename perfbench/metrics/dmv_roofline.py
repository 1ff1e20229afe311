"""Percent: the summed bound of the stretch's DP launches (K1, each by
``dmv_bound(..., "fused")`` on its own lengths) over their device time."""


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    t = sum(v for n, v in ctx["timeline"]["kernel_s"].items() if "dmv_" in n)
    b = ctx["bounds"].get("k1_s", 0.0)
    if not t or not b:
        return None
    return 100.0 * b / t
