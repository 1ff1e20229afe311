"""Model export for serving (counterpart of vlgae_tpu/training/export.py).

The deterministic forward (eval mode, no gradient), closed over the
weights, goes through ``torch.export`` into a self-contained program that a
serving process loads without the model-building code. It keeps only the
score tensors the decode reads, ``merged_dec`` and ``merged_attach``, as the
JAX package's ``jax.export`` artifact does. Shapes are fixed by the example
inputs, as ``jax.export`` fixes them from their ``ShapeDtypeStruct`` s. The
kernels the forward reaches are custom ops (``vlgae::dmv_fused``,
``vlgae::match_maxes``, ...): the program calls them by name, so the
process that loads it imports :mod:`vlgae_tpu_torch.ops` first (which
:func:`load_forward` does) and runs the kernels on the card, their plain
versions on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops import dmv_cuda, match  # noqa: F401  (registers the vlgae:: ops)

KEYS = ("merged_dec", "merged_attach")


class _Forward(nn.Module):
    """``model(inputs)`` without autograd, reduced to :data:`KEYS`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, inputs: Dict[str, torch.Tensor]):
        out = self.model(inputs)
        return {k: out[k] for k in KEYS if k in out}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_forward(model: nn.Module, example_inputs: Dict, path: str) -> int:
    """Export the deterministic forward of ``model`` on inputs shaped as
    ``example_inputs`` (arrays or tensors; moved to the model's device) to
    ``path`` with ``torch.export.save``. Returns the artifact's byte size."""
    device = _device(model)
    inputs = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
              for k, v in dict(example_inputs).items()}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(_Forward(model), (inputs,), strict=False)
    finally:
        model.train(was_training)
    # the artifact holds the program and its weights, not the example batch
    # (torch.export keeps it for ``save`` to write beside them)
    program.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_forward(path: str):
    """The exported forward as a callable of the inputs dict."""
    return torch.export.load(path).module()
