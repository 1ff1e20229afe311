"""Device operations (kernels, copies and fills) a step, over the traced
stretch: a count of what the pipeline dispatches."""


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    return ctx["timeline"]["n_device_ops"] / ctx["timeline"]["n_steps"]
