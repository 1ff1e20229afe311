"""Device idle ms a step while the host was in the port's forward
(``vlgae.forward`` and its stage spans) or loss (``vlgae.loss`` and its
stage spans), over the traced stretch (``spans.reduce``)."""

from ..core.spans import idle_under


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    return idle_under(ctx.get("program"), ("vlgae.forward", "vlgae.loss"))
