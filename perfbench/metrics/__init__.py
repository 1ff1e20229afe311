"""Per-layer metric readers, one module a metric family: the family is the
part of a metric's name before the first dot (``mfu`` of ``mfu.train``),
the rest is handed to its ``read(ctx, part)``. A reader returns a number,
or None where its cell has nothing for it to read."""

from __future__ import annotations

import importlib


def read(name: str, ctx: dict):
    family, _, part = name.partition(".")
    return importlib.import_module(f"{__name__}.{family}").read(ctx, part)
