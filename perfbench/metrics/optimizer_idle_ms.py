"""Device idle ms a step while the host was in the port's optimizer step
(``vlgae.optimizer``: the gradient sum, the clip, Adam, ``zero_grad``),
over the traced stretch (``spans.reduce``)."""

from ..core.spans import idle_under


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    return idle_under(ctx.get("program"), ("vlgae.optimizer",))
