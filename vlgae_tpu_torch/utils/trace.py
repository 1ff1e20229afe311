"""Spans and counters of the port.

:func:`span` marks a stage of the program (names start with ``vlgae.``).
While a ``torch.profiler`` session runs it is a
``torch.profiler.record_function`` range, a CPU event on the same timeline
as the device's kernels, so that an idle gap of the card can be put down to
the innermost span the host was in. Without a profiler it returns one shared
no-op context: ``record_function`` costs about 12 us to enter and leave even
when nothing records it, the check below about 0.1 us.

The counters are plain ints in one dict of this process, always on:
:func:`count` adds to one under a lock (threads add to them: the data
module's batch producer and its consumer), :func:`counters` returns a copy
of all, :func:`reset` drops them (a dropped counter is absent, read as 0).
Their names say the layer first (``data.``, ``upload.``, ``dmv.``,
``match.``, ``graph.``: the train step's CUDA graphs,
``training/graphs.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_NOOP = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_lock = threading.Lock()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else a no-op
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (created at 0)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    with _lock:
        return dict(_counts)


def reset(prefix: str = "") -> None:
    """Drop the counters whose names start with ``prefix`` (all of them by
    default)."""
    with _lock:
        for name in [k for k in _counts if k.startswith(prefix)]:
            del _counts[name]
