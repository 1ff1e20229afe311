"""Modules a run may not load: JAX and its libraries, and the JAX package
the port was made from. Names are compared whole by their top-level part
(``vlgae_tpu_torch`` is not ``vlgae_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "vlgae_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
