"""Neural building blocks (counterpart of vlgae_tpu/models/nn.py).

Eval-only forward passes: dropout is off at eval and not ported here.
Flax defaults are set explicitly: ``leaky_relu`` slope 0.01; a Dense
layer's ``kernel [in, out]`` is the transposed ``Linear.weight`` (see
:mod:`vlgae_tpu_torch.convert`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01  # jax.nn.leaky_relu default


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def linear(x, layer: nn.Linear, dtype=None):
    """``layer(x)``; with ``dtype`` (bf16) operands and bias are cast to it
    and the output returns as f32 (flax ``Dense(dtype=...)`` + astype)."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias).float()


class MLP(nn.Module):
    """Linear -> LeakyReLU (dropout only in training)."""

    def __init__(self, n_in: int, n_hidden: int, activate: bool = True,
                 dtype=None):
        super().__init__()
        self.linear = nn.Linear(n_in, n_hidden)
        self.activate = activate
        self.dtype = dtype

    def forward(self, x):
        x = linear(x, self.linear, self.dtype)
        return leaky_relu(x) if self.activate else x


class ScalarMix(nn.Module):
    """Softmax-weighted layer mixture with gamma."""

    def __init__(self, n_layers: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(n_layers))
        self.gamma = nn.Parameter(torch.ones(1))

    def forward(self, tensors):
        nw = torch.softmax(self.weights, 0)
        return self.gamma * sum(w * t for w, t in zip(nw, tensors))


def _bottleneck(n_hidden, n_bottleneck):
    if n_bottleneck == 0:
        return nn.Linear(n_hidden, n_hidden)
    return nn.Sequential(nn.Linear(n_hidden, n_bottleneck),
                         nn.Linear(n_bottleneck, n_hidden))


class DMVSkipConnectEncoder(nn.Module):
    """Expand token reps to [..., dir, val, hidden] with skip connections.

    Valence axis order HASCHILD=0, NOCHILD=1; direction LEFT=0, RIGHT=1.
    Flax names the bottleneck pair ``<NAME>_down``/``<NAME>_up`` (or
    ``<NAME>`` without a bottleneck); :mod:`convert` maps those onto the
    ``Sequential``'s ``0``/``1``.
    """

    def __init__(self, hidden_size: int, n_bottleneck: int = 0,
                 n_mid: int = 0):
        super().__init__()
        H = hidden_size
        self.n_bottleneck = n_bottleneck
        self.HASCHILD = _bottleneck(H, n_bottleneck)
        self.NOCHILD = _bottleneck(H, n_bottleneck)
        self.valence = nn.Linear(H, H)
        self.LEFT = _bottleneck(H, n_bottleneck)
        self.RIGHT = _bottleneck(H, n_bottleneck)
        self.direction = nn.Linear(H, H)
        self.mid1 = nn.Linear(H, n_mid or H)
        self.mid2 = nn.Linear(n_mid or H, H)

    def forward(self, x):
        has_child = self.HASCHILD(x) + x
        no_child = self.NOCHILD(x) + x
        h = torch.stack([has_child, no_child], dim=-2)
        h = leaky_relu(self.valence(leaky_relu(h)))
        x_ = x[..., None, :]
        left = self.LEFT(h) + x_
        right = self.RIGHT(h) + x_
        h = torch.stack([left, right], dim=-3)
        h = leaky_relu(self.direction(leaky_relu(h)))
        h = self.mid1(h)
        return self.mid2(leaky_relu(h))


class DMVFactorizedBilinear(nn.Module):
    """Low-rank bilinear scorer. ``x2`` carries a leading batch axis of 1
    (shared over the batch of ``x1``)."""

    def __init__(self, n_in: int, r: int = 64):
        super().__init__()
        self.project1 = nn.Linear(n_in, r)
        self.project2 = nn.Linear(n_in, r)

    def forward(self, x1, x2, tokens_last: bool = False):
        x1 = self.project1(x1)
        x2 = self.project2(x2)
        if x1.dim() != 5 or x2.shape[0] != 1:
            raise NotImplementedError("DMVFactorizedBilinear takes 5-D inputs")
        spec = "bhdve,cdve->bhdvc" if tokens_last else "bhdve,cdve->bhcdv"
        return torch.einsum(spec, x1, x2[0])
