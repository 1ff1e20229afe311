"""Neural building blocks (counterpart of vlgae_tpu/models/nn.py).

Flax defaults are set explicitly: ``leaky_relu`` slope 0.01; a Dense
layer's ``kernel [in, out]`` is the transposed ``Linear.weight`` (see
:mod:`vlgae_tpu_torch.convert`).

Dropout and the reparameterised draws of the variational layers act only in
``.train()`` mode and draw from an explicit ``torch.Generator`` that the
owner of the model hands to every such module (:func:`set_dropout_generator`);
the formulas are those of the JAX package, written as functions of a given
keep mask or noise so the tests can feed both packages the same draws.
Under data parallelism a draw over the batch is made at the global batch's
size and each rank keeps its rows (:func:`set_batch_rows`), so the masks
are those of one process over the whole batch. A module whose outputs are
sharded over a model group (tensor parallelism) draws at the full feature
width and keeps its columns (``feature_cols``) likewise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01  # jax.nn.leaky_relu default


def leaky_relu(x):
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)``, so that the
    derivative at exactly 0 is 1 (``F.leaky_relu``'s is the slope). Exact
    zeros are common in bf16: the relation factor's pairwise mean of two
    projections that are each other's negatives."""
    return torch.where(x >= 0, x, x * LEAKY_SLOPE)


def shared_dropout(x, p: float, keep):
    """``x * keep / (1 - p)`` with ``keep`` of shape ``(x.shape[0], 1,
    *x.shape[2:])``: one mask per (row, feature), shared along dim 1."""
    return x * keep / (1 - p)


def shared_keep_shape(x):
    return (x.shape[0], 1) + tuple(x.shape[2:])


def independent_dropout(items, p: float, keeps):
    """Mutually compensating dropout across embedding items: item ``i``
    is scaled by ``keeps[i] * n_items / max(sum(keeps), 1)`` (per-item
    ``[B, L]`` keep masks)."""
    total = sum(keeps)
    scale = len(items) / torch.clamp_min(total, 1.0)
    return [x * (m * scale)[..., None] for x, m in zip(items, keeps)]


class Dropping(nn.Module):
    """Base of the modules that draw at random in training (dropout masks,
    the reparameterised draws of the variational layers): keeps the
    generator the draws come from and, under data parallelism, this rank's
    rows ``(start, stop, total)`` of the global batch."""

    generator = None
    batch_rows = None
    # (start, stop, total) of the last axis this rank holds, under tensor
    # parallelism
    feature_cols = None
    # dim 0 of what the module draws for is the batch (not a table)
    batched = True

    def _generator(self):
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__} draws at random in training mode but has "
                "no generator; call set_dropout_generator(model, generator)")
        return self.generator

    def _draw_shape(self, shape, batched: bool):
        """``(shape to draw, index to keep)``: a draw over the batch
        (``batched``, dim 0 the batch) is made for the whole global batch
        when this rank holds only some of its rows, and at the full feature
        width when it holds only some columns (``feature_cols``)."""
        shape = tuple(shape)
        rows = self.batch_rows if batched else None
        cols = self.feature_cols
        if rows is None and cols is None:
            return shape, None
        keep = [slice(None)] * len(shape)
        if rows is not None:
            start, stop, total = rows
            if shape[0] != stop - start:
                raise ValueError(f"{type(self).__name__}: a batched draw of {shape} "
                                 f"on rows {start}:{stop} of {total}")
            shape, keep[0] = (total,) + shape[1:], slice(start, stop)
        if cols is not None:
            start, stop, total = cols
            shape, keep[-1] = shape[:-1] + (total,), slice(start, stop)
        return shape, tuple(keep)

    def keep_mask(self, shape, p: float, like):
        """A float 0/1 mask with P(1) = 1 - p, drawn from the generator."""
        return self._keep_mask(shape, p, like, self.batched)

    def table_keep_mask(self, shape, p: float, like):
        """:meth:`keep_mask` for a table (dim 0 not the batch)."""
        return self._keep_mask(shape, p, like, False)

    def _keep_mask(self, shape, p, like, batched):
        shape, index = self._draw_shape(shape, batched)
        keep = torch.empty(shape, dtype=like.dtype, device=like.device).bernoulli_(
            1 - p, generator=self._generator())
        return keep if index is None else keep[index]

    def noise(self, shape, like):
        """Standard normal draws from the generator (the reparameterised
        sample ``mean + exp(lvar / 2) * noise``)."""
        shape, index = self._draw_shape(shape, self.batched)
        z = torch.randn(shape, dtype=like.dtype, device=like.device,
                        generator=self._generator())
        return z if index is None else z[index]

    def active(self, p: float) -> bool:
        return self.training and p > 0


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Hand ``generator`` to every module of ``model`` that draws at random
    (dropout and the variational layers)."""
    for m in model.modules():
        if isinstance(m, Dropping):
            m.generator = generator


def set_batch_rows(model: nn.Module, rows) -> None:
    """Tell every module of ``model`` that draws at random which rows
    ``(start, stop, total)`` of the global batch this rank holds (``None``:
    all of them)."""
    for m in model.modules():
        if isinstance(m, Dropping):
            m.batch_rows = rows


def linear(x, layer: nn.Linear, dtype=None):
    """``layer(x)``; with ``dtype`` (bf16) operands and bias are cast to it
    and the output returns as f32 (flax ``Dense(dtype=...)`` + astype)."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias).float()


class MLP(Dropping):
    """Linear -> LeakyReLU -> shared dropout (in training). ``batched``:
    dim 0 of the input is the batch (not a vocabulary table)."""

    def __init__(self, n_in: int, n_hidden: int, activate: bool = True,
                 dtype=None, dropout: float = 0.0, batched: bool = True):
        super().__init__()
        self.linear = nn.Linear(n_in, n_hidden)
        self.activate = activate
        self.dtype = dtype
        self.dropout = dropout
        self.batched = batched

    def forward(self, x):
        x = linear(x, self.linear, self.dtype)
        if self.activate:
            x = leaky_relu(x)
        if self.active(self.dropout):
            x = shared_dropout(x, self.dropout,
                               self.keep_mask(shared_keep_shape(x), self.dropout, x))
        return x


class ResLayer(nn.Module):
    """Residual two-layer ReLU block (then LeakyReLU when ``activate``)."""

    def __init__(self, n_hidden: int, activate: bool = True):
        super().__init__()
        self.linear1 = nn.Linear(n_hidden, n_hidden)
        self.linear2 = nn.Linear(n_hidden, n_hidden)
        self.activate = activate

    def forward(self, x):
        h = torch.relu(self.linear2(torch.relu(self.linear1(x))))
        if self.activate:
            h = leaky_relu(h)
        return h + x


class Biaffine(nn.Module):
    """Dozat's biaffine scorer: ``s[b, o, x, y] = [x; 1] W_o [y; 1]``
    (``[b, x, y]`` when ``n_out == 1``)."""

    def __init__(self, n_in_x: int, n_in_y: int, n_out: int = 1,
                 bias_x: bool = True, bias_y: bool = True):
        super().__init__()
        self.bias_x, self.bias_y = bias_x, bias_y
        self.weight = nn.Parameter(torch.zeros(n_out, n_in_x + bias_x, n_in_y + bias_y))

    def forward(self, x, y):
        if self.bias_x:
            x = torch.cat([x, torch.ones_like(x[..., :1])], -1)
        if self.bias_y:
            y = torch.cat([y, torch.ones_like(y[..., :1])], -1)
        s = torch.einsum("bxi,oij,byj->boxy", x, self.weight, y)
        return s[:, 0] if self.weight.shape[0] == 1 else s


class BiaffineScorer(nn.Module):
    """Each input through its own MLP, both scaled by ``hidden_dim **
    -0.25`` (a biaffine product of about unit variance), then
    :class:`Biaffine`; scores ``[B, x, y, out_dim]``."""

    def __init__(self, n_in: int, hidden_dim: int, out_dim: int = 1,
                 mlp_dropout: float = 0.0, mlp_activate: bool = True,
                 scale: bool = True, n_in2: int = None):
        super().__init__()
        self.mlp1 = MLP(n_in, hidden_dim, mlp_activate, dropout=mlp_dropout)
        self.mlp2 = MLP(n_in2 or n_in, hidden_dim, mlp_activate, dropout=mlp_dropout)
        self.affine = Biaffine(hidden_dim, hidden_dim, out_dim, bias_x=True,
                               bias_y=out_dim > 1)
        self.hidden_dim, self.out_dim, self.scale = hidden_dim, out_dim, scale

    def forward(self, x, x2):
        h1, h2 = self.mlp1(x), self.mlp2(x2)
        if self.scale:
            s = self.hidden_dim ** -0.25
            h1, h2 = h1 * s, h2 * s
        out = self.affine(h1, h2)
        if self.out_dim == 1:
            return out[..., None]
        return torch.movedim(out, 1, -1)


def multivariate_kl(mean_q, mean_p, lvar_q, lvar_p, reduction: str = "sum"):
    """KL(q || p) between diagonal Gaussians, over the last axis, then
    summed (``"sum"``), averaged (``"mean"``) or kept per row."""
    var_q, var_p = torch.exp(lvar_q), torch.exp(lvar_p)
    kl = 0.5 * ((lvar_p - lvar_q).sum(-1) + (var_q / var_p).sum(-1)
                + ((mean_p - mean_q) ** 2 / var_p).sum(-1) - mean_q.shape[-1])
    if reduction == "sum":
        return kl.sum()
    if reduction == "mean":
        return kl.mean()
    return kl


def variational_kl(mean, lvar, target=None):
    """The KL term of a Gaussian posterior ``N(mean, exp(lvar))``: against
    a learned prior ``target = (target_mean, target_lvar)`` (each ``[1, z]``,
    information bottleneck) summed over all rows, or without one against
    ``N(0, 1)`` (VAE), summed."""
    if target is not None:
        z = mean.shape[-1]
        m, lv = mean.reshape(-1, z), lvar.reshape(-1, z)
        return multivariate_kl(m, target[0].expand_as(m), lv, target[1].expand_as(lv))
    return -0.5 * torch.sum(lvar - mean ** 2 - torch.exp(lvar) + 1)


class ScalarMix(Dropping):
    """Softmax-weighted layer mixture with gamma; layer dropout in
    training (a dropped layer's weight is 0, the kept ones / (1 - p))."""

    batched = False  # one weight a layer

    def __init__(self, n_layers: int, dropout: float = 0.0):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(n_layers))
        self.gamma = nn.Parameter(torch.ones(1))
        self.dropout = dropout

    def forward(self, tensors):
        nw = torch.softmax(self.weights, 0)
        if self.active(self.dropout):
            keep = self.keep_mask(nw.shape, self.dropout, nw)
            nw = torch.where(keep.bool(), nw / (1 - self.dropout), 0.0)
        return self.gamma * sum(w * t for w, t in zip(nw, tensors))


def _bottleneck(n_hidden, n_bottleneck):
    if n_bottleneck == 0:
        return nn.Linear(n_hidden, n_hidden)
    return nn.Sequential(nn.Linear(n_hidden, n_bottleneck),
                         nn.Linear(n_bottleneck, n_hidden))


class DMVSkipConnectEncoder(Dropping):
    """Expand token reps to [..., dir, val, hidden] with skip connections.

    Valence axis order HASCHILD=0, NOCHILD=1; direction LEFT=0, RIGHT=1.
    Flax names the bottleneck pair ``<NAME>_down``/``<NAME>_up`` (or
    ``<NAME>`` without a bottleneck); :mod:`convert` maps those onto the
    ``Sequential``'s ``0``/``1``.
    """

    def __init__(self, hidden_size: int, n_bottleneck: int = 0,
                 n_mid: int = 0, dropout: float = 0.0):
        super().__init__()
        H = hidden_size
        self.n_bottleneck = n_bottleneck
        self.dropout = dropout
        self.HASCHILD = _bottleneck(H, n_bottleneck)
        self.NOCHILD = _bottleneck(H, n_bottleneck)
        self.valence = nn.Linear(H, H)
        self.LEFT = _bottleneck(H, n_bottleneck)
        self.RIGHT = _bottleneck(H, n_bottleneck)
        self.direction = nn.Linear(H, H)
        self.mid1 = nn.Linear(H, n_mid or H)
        self.mid2 = nn.Linear(n_mid or H, H)

    def forward(self, x):
        return self._encode(x, self.keep_mask)

    def table(self, x):
        """:meth:`forward` over a table (dim 0 not the batch): the same
        weights, the dropout mask drawn whole on every rank."""
        return self._encode(x, self.table_keep_mask)

    def _encode(self, x, keep_mask):
        has_child = self.HASCHILD(x) + x
        no_child = self.NOCHILD(x) + x
        h = torch.stack([has_child, no_child], dim=-2)
        h = leaky_relu(self.valence(leaky_relu(h)))
        x_ = x[..., None, :]
        left = self.LEFT(h) + x_
        right = self.RIGHT(h) + x_
        h = torch.stack([left, right], dim=-3)
        h = leaky_relu(self.direction(leaky_relu(h)))
        if self.active(self.dropout):
            # element-wise (full-shape) mask
            h = h * keep_mask(h.shape, self.dropout, h) / (1 - self.dropout)
        h = self.mid1(h)
        return self.mid2(leaky_relu(h))


class DMVFactorizedBilinear(nn.Module):
    """Low-rank bilinear scorer of 5-D inputs; ``x2``'s leading batch axis
    is 1 (shared over the batch of ``x1``) or ``x1``'s."""

    def __init__(self, n_in: int, r: int = 64):
        super().__init__()
        self.project1 = nn.Linear(n_in, r)
        self.project2 = nn.Linear(n_in, r)

    def forward(self, x1, x2, tokens_last: bool = False):
        x1 = self.project1(x1)
        x2 = self.project2(x2)
        if x1.dim() != 5 or x2.dim() != 5:
            raise NotImplementedError("DMVFactorizedBilinear takes 5-D inputs")
        if x2.shape[0] == 1:
            spec = "bhdve,cdve->bhdvc" if tokens_last else "bhdve,cdve->bhcdv"
            return torch.einsum(spec, x1, x2[0])
        spec = "bhdve,bcdve->bhdvc" if tokens_last else "bhdve,bcdve->bhcdv"
        return torch.einsum(spec, x1, x2)
