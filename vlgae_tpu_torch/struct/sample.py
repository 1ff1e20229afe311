"""Sampling and sparsemax semirings (counterpart of
``vlgae_tpu/struct/sample.py``).

The "gradient" of a sampled or relaxed sum routes mass through a sampled
child, so the gradient of a chart total gives exact forward-filter
backward-sample trees, straight-through Gumbel relaxations or sparsemax
marginals.

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device: each semiring instance holds one, and the backward passes draw
from it in the order autograd calls them. The routing of one reduction is
a plain function of its noise (:func:`multi_route`, :func:`gumbel_route`),
so a test can hand it the draws of another implementation.
"""

from __future__ import annotations

import torch

from .semirings import _BaseLog, _stack_axis


def _uniform(generator, shape, like):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def gumbel_noise(generator, shape, like):
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` in [tiny, 1)."""
    u = _uniform(generator, shape, like).clamp_min(torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


# -- one exact sample per backward ------------------------------------------------


class _SampledLogsumexp(torch.autograd.Function):
    """``logsumexp`` whose backward sends the cotangent to one child per
    reduced slot, drawn from the softmax over the slot."""

    @staticmethod
    def forward(ctx, x, generator, axis):
        ctx.save_for_backward(x)
        ctx.generator, ctx.axis = generator, axis
        return torch.logsumexp(x, dim=axis)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        moved = torch.movedim(x, ctx.axis, -1)
        probs = torch.softmax(moved, -1).reshape(-1, moved.shape[-1])
        idx = torch.multinomial(probs, 1, generator=ctx.generator)
        onehot = torch.zeros_like(probs).scatter_(1, idx, 1.0).view(moved.shape)
        return g.unsqueeze(ctx.axis) * torch.movedim(onehot, -1, ctx.axis), None, None


def SampledSemiring(generator):
    """Forward-filter backward-sample semiring: the gradient of the total is
    one exact sample."""

    class _Sampled(_BaseLog):
        @classmethod
        def sum(cls, xs, axis=-1):
            return _SampledLogsumexp.apply(xs, generator, _stack_axis(axis))

    return _Sampled


# -- k samples per backward, bit-packed ---------------------------------------------


def multi_route(x, g, u, axis: int, k: int):
    """The backward of one bit-packed reduction, given its uniforms.

    ``x`` holds the reduced slot's scores along ``axis``, ``g`` (shaped as
    ``x`` without ``axis``) an integer bitmask per cell: sample ``i`` passes
    through the cell iff bit ``i`` is set. ``u [k, *g.shape]`` are the
    uniforms of the k inverse-CDF draws. Each set bit goes to its drawn
    child, weighted ``2**i``; every sample passes a chart cell once, so the
    sums of these masks stay exact integers in f32 (below 2^24 for k <= 16).
    """
    moved = torch.movedim(x, axis, -1)  # [..., n]
    n = moved.shape[-1]
    cdf = torch.cumsum(torch.softmax(moved, -1), -1)
    idx = (u[..., None] > cdf[None]).sum(-1).clamp(0, n - 1)  # [k, ...]
    onehot = torch.arange(n, device=x.device) == idx[..., None]  # [k, ..., n]
    gi = torch.round(g).to(torch.int64)
    shifts = torch.arange(k, device=x.device).view((k,) + (1,) * g.dim())
    bits = (gi[None] >> shifts) & 1  # [k, ...]
    weights = bits.to(x.dtype) * (2.0 ** shifts).to(x.dtype)
    out = torch.where(onehot, weights[..., None], 0.0).sum(0)  # [..., n]
    return torch.movedim(out, -1, axis)


class _MultiSampledLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, generator, axis, k):
        ctx.save_for_backward(x)
        ctx.generator, ctx.axis, ctx.k = generator, axis, k
        return torch.logsumexp(x, dim=axis)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        u = _uniform(ctx.generator, (ctx.k,) + tuple(g.shape), x)
        return multi_route(x, g, u, ctx.axis, ctx.k), None, None, None


def MultiSampledSemiring(generator, k: int = 16):
    """k samples per backward by bit packing; k <= 16 keeps the packed mass
    exactly representable in f32."""
    if not 1 <= k <= 16:
        raise ValueError("bit packing supports 1 to 16 samples")

    class _Multi(_BaseLog):
        @classmethod
        def sum(cls, xs, axis=-1):
            return _MultiSampledLogsumexp.apply(xs, generator, _stack_axis(axis), k)

    return _Multi


def multi_sample_grads(inside_total_fn, potentials, generator, num_samples: int):
    """``num_samples`` exact samples for ``ceil(num_samples / 16)`` inside
    passes.

    ``inside_total_fn(potentials, semiring) -> [B]`` totals. Returns sample
    indicators ``[num_samples, *potentials.shape]``: per chunk of up to 16
    samples, one backward with the cotangent ``2**k - 1`` and the bits
    decoded from the rounded packed gradient. Chunks draw on, so they are
    independent."""
    chunks = []
    left = num_samples
    while left > 0:
        k = min(16, left)
        S = MultiSampledSemiring(generator, k)
        with torch.enable_grad():
            p = potentials.detach().float().requires_grad_(True)
            val = inside_total_fn(p, S)
            (packed,) = torch.autograd.grad(
                val, p, grad_outputs=torch.full_like(val, float(2 ** k - 1)))
        gi = torch.round(packed).to(torch.int64)
        shifts = torch.arange(k, device=gi.device).view((k,) + (1,) * gi.dim())
        chunks.append(((gi[None] >> shifts) & 1).float())
        left -= k
    return torch.cat(chunks, 0)


# -- straight-through Gumbel -------------------------------------------------------


def gumbel_route(x, g, gumbel, axis: int, temp: float):
    """The backward of one straight-through Gumbel reduction, given its
    Gumbel noise (shaped as ``x`` with ``axis`` moved last): ``g`` times
    ``soft + (hard - soft)``, where ``hard`` is the one-hot of
    ``argmax((x + gumbel) / temp)`` and ``soft`` its softmax."""
    moved = torch.movedim(x, axis, -1)
    update = (moved + gumbel) / temp
    hard = torch.nn.functional.one_hot(update.argmax(-1), moved.shape[-1]).to(x.dtype)
    soft = torch.softmax(update, -1)
    st = soft + (hard - soft).detach()
    return g.unsqueeze(axis) * torch.movedim(st, -1, axis)


class _GumbelLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, generator, axis, temp):
        ctx.save_for_backward(x)
        ctx.generator, ctx.axis, ctx.temp = generator, axis, temp
        return torch.logsumexp(x, dim=axis)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        shape = torch.movedim(x, ctx.axis, -1).shape
        noise = gumbel_noise(ctx.generator, shape, x)
        return gumbel_route(x, g, noise, ctx.axis, ctx.temp), None, None, None


def GumbelCRFSemiring(generator, temp: float = 1.0):
    """Straight-through Gumbel-CRF semiring."""

    class _Gumbel(_BaseLog):
        @classmethod
        def sum(cls, xs, axis=-1):
            return _GumbelLogsumexp.apply(xs, generator, _stack_axis(axis), temp)

    return _Gumbel


# -- sparsemax --------------------------------------------------------------------


def project_simplex(v, axis: int = -1, z: float = 1.0):
    """Euclidean projection of ``v`` onto the simplex along ``axis``."""
    axis = axis % v.dim()
    v_sorted = torch.sort(v, dim=axis, descending=True).values
    cssv = torch.cumsum(v_sorted, dim=axis) - z
    n = v.shape[axis]
    shape = [1] * v.dim()
    shape[axis] = n
    ind = torch.arange(1, n + 1, dtype=v.dtype, device=v.device).view(shape)
    cond = (v_sorted - cssv / ind) >= 0
    k = cond.sum(dim=axis, keepdim=True)
    tau = torch.gather(cssv, axis, k - 1) / k.to(v.dtype)
    return torch.clamp_min(v - tau, 0)


def sparsemax_grad(dout, w_star, axis: int):
    """The sparsemax Jacobian-vector product: ``dout`` on the support of
    ``w_star``, minus its mean over the support."""
    supp = w_star > 0
    out = torch.where(supp, dout, 0.0)
    nnz = torch.clamp_min(supp.to(dout.dtype).sum(axis, keepdim=True), 1.0)
    out = out - out.sum(axis, keepdim=True) / nnz
    return torch.where(supp, out, 0.0)


class _SimplexProjectSum(torch.autograd.Function):
    """``(x * w).sum - ||w||`` with ``w`` the simplex projection of ``x``;
    the gradient is ``w``."""

    @staticmethod
    def forward(ctx, x, axis):
        w = project_simplex(x, axis)
        ctx.save_for_backward(w)
        ctx.axis = axis
        return (x * w).sum(axis) - torch.linalg.vector_norm(w, dim=axis)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g.unsqueeze(ctx.axis) * w, None


class SparseMaxSemiring(_BaseLog):
    """Differentiable sparsemax DP."""

    @classmethod
    def sum(cls, xs, axis=-1):
        return _SimplexProjectSum.apply(xs, _stack_axis(axis))
