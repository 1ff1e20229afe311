"""Host ms a step waited for its batch (the data layer: the next batch of
the data module and its padding), the mean over the traced stretch."""


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    return ctx["timeline"]["span_s"].get("bench.batch_wait", 0.0) * 1e3 / ctx["timeline"]["n_steps"]
