"""Percent: the summed bound of the stretch's K7 launches (the held experts'
grouped SwiGLU MLP, ``flops/granite.py::k7_bound`` on the pairs each was
given) over the device time of K7's kernels (named ``moe_*``)."""


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    t = sum(v for n, v in ctx["timeline"]["kernel_s"].items() if "moe_" in n)
    b = ctx["bounds"].get("k7_s", 0.0)
    if not t or not b:
        return None
    return 100.0 * b / t
