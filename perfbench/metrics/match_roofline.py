"""Percent: the summed bound of the stretch's matching launches (K5 on the
live rows of its masks, and in training K6 on its distinct winning cells)
over their device time."""


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    t = sum(v for n, v in ctx["timeline"]["kernel_s"].items() if "match_fwd" in n or "match_bwd" in n)
    b = ctx["bounds"].get("k5_s", 0.0) + ctx["bounds"].get("k6_s", 0.0)
    if not t or not b:
        return None
    return 100.0 * b / t
