"""What each kernel launch of a traced stretch was given, recorded by
wrapping the program's kernel entry points from outside (the program is not
changed). The configuration's family names the entry points and the bound
of each (``Kernel``). What ``take`` keeps is read after the stretch, so the
stretch itself makes no host sync."""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, NamedTuple


class Kernel(NamedTuple):
    """An entry point of the program to record: ``module.entry``; ``take``
    gets the call's arguments and returns what to keep (tensors detached);
    ``bound(kept) -> (seconds, live)``, the launch's bound and what the
    family's operation count reads of it."""
    name: str
    module: str
    entry: str
    take: Callable
    bound: Callable


@contextlib.contextmanager
def launches(kernels):
    """Yield ``{name: [kept]}`` of ``kernels``, filled while the block runs."""
    rec = {k.name: [] for k in kernels}
    mods = [importlib.import_module(k.module) for k in kernels]
    orig = [getattr(m, k.entry) for m, k in zip(mods, kernels)]

    def wrap(k, fn):
        def wrapped(*args, **kwargs):
            rec[k.name].append(k.take(*args, **kwargs))
            return fn(*args, **kwargs)
        return wrapped

    for m, k, fn in zip(mods, kernels, orig):
        setattr(m, k.entry, wrap(k, fn))
    try:
        yield rec
    finally:
        for m, k, fn in zip(mods, kernels, orig):
            setattr(m, k.entry, fn)


def bounds(kernels, rec) -> dict:
    """Per kernel, the summed bound seconds of its recorded launches
    (``<name>_s``) and each launch's ``live`` in order (``<name>``)."""
    out = {}
    for k in kernels:
        read = [k.bound(kept) for kept in rec[k.name]]
        out[k.name + "_s"] = sum(s for s, _ in read)
        out[k.name] = [live for _, live in read]
    return out
