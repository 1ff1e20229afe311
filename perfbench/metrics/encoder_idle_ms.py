"""Device idle ms a step while the host was in the port's text encoder
(``vlgae.forward.text`` and its stage spans ``.mamba``, ``.attention``,
``.moe``), over the traced stretch (``spans.reduce``)."""

from ..core.spans import idle_under


def read(ctx, part):
    if ctx["loop"] != part:
        return None
    return idle_under(ctx.get("program"), ("vlgae.forward.text",))
