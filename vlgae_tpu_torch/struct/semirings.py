"""Semirings for chart dynamic programs (counterpart of
``vlgae_tpu/struct/semirings.py``).

* ``LogSemiring``      -- (logsumexp, +): partition; gradients give marginals.
* ``MaxSemiring``      -- (max, +): Viterbi; gradients give argmax indicators.
* ``StdSemiring``      -- (+, *): counting.
* ``TempMaxSemiring(alpha)`` -- logsumexp at temperature 1/alpha.
* ``KMaxSemiring(k)``  -- top-k Viterbi (a stacked channel per rank).
* ``EntropySemiring``  -- expectation semiring computing H[p].
* ``CrossEntropySemiring`` -- H[p, q] over paired potentials.
* ``KLDivergenceSemiring`` -- KL[p || q] over paired potentials.
* ``RiskSemiring``     -- expected cost E_p[cost].

A semiring is a class of static methods over *stacked* tensors
``[size, ...]``: one chart layout serves every semiring, and a chart fill
(:func:`~.dmv.dmv_inside`, :func:`~.deptree.deptree_inside`) is written
once. ``axis`` arguments name an axis of the per-channel view (without the
stacked dimension).

Gradients at exact ties: ``torch.amax`` splits the gradient evenly among
equal maxima, as ``jax.grad`` of ``jnp.max`` does (``torch.max(dim)`` would
send all of it to one element). ``torch.topk`` routes its gradient to the
chosen indices, as ``lax.top_k`` does; the order among equal values may
differ between the two.
"""

from __future__ import annotations

import torch

# the semiring zero of the log-like semirings (struct/dmv.py NEGINF)
NEGINF = -1e12


def _stack_axis(axis: int) -> int:
    """Translate a per-channel axis to an axis in the stacked layout."""
    return axis + 1 if axis >= 0 else axis


def _full(size, shape, value, dtype, device):
    return torch.full((size,) + tuple(shape), value, dtype=dtype, device=device)


class Semiring:
    """Base semiring. Values are stacked tensors ``[size, ...]``."""

    size: int = 1
    zero: float = NEGINF
    one: float = 0.0

    # -- conversion ------------------------------------------------------
    @classmethod
    def convert(cls, xs):
        """Lift raw potentials to the stacked representation."""
        return xs[None]

    @classmethod
    def unconvert(cls, xs):
        """Read the result channel out of the stacked representation."""
        return xs[0]

    # -- algebra ---------------------------------------------------------
    @classmethod
    def mul(cls, a, b):
        raise NotImplementedError

    @classmethod
    def sum(cls, xs, axis: int = -1):
        """Semiring sum over the per-channel ``axis`` of stacked ``xs``."""
        raise NotImplementedError

    @classmethod
    def prod(cls, xs, axis: int = -1):
        """Semiring product over the per-channel ``axis``."""
        raise NotImplementedError

    @classmethod
    def times(cls, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = cls.mul(out, x)
        return out

    # -- constants -------------------------------------------------------
    @classmethod
    def zeros(cls, shape, dtype=torch.float32, device=None):
        """Stacked tensor of additive identities; ``shape`` excludes the
        stacked dimension."""
        return _full(cls.size, shape, cls.zero, dtype, device)

    @classmethod
    def ones(cls, shape, dtype=torch.float32, device=None):
        return _full(cls.size, shape, cls.one, dtype, device)

    @classmethod
    def mask(cls, xs, keep):
        """Entries where ``keep`` (broadcast against the per-channel view)
        is False become the semiring zero."""
        zero = cls.zeros(xs.shape[1:], xs.dtype, xs.device)
        return torch.where(keep[None], xs, zero)


class _BaseLog(Semiring):
    zero = NEGINF
    one = 0.0

    @classmethod
    def mul(cls, a, b):
        return a + b

    @classmethod
    def prod(cls, xs, axis=-1):
        return torch.sum(xs, dim=_stack_axis(axis))


class LogSemiring(_BaseLog):
    """(logsumexp, +, -inf, 0). Gradients of the total give marginals."""

    @classmethod
    def sum(cls, xs, axis=-1):
        return torch.logsumexp(xs, dim=_stack_axis(axis))


class MaxSemiring(_BaseLog):
    """(max, +, -inf, 0). Gradients of the total give argmax indicators;
    ``amax`` splits them evenly among exact ties, as ``jnp.max`` does."""

    @classmethod
    def sum(cls, xs, axis=-1):
        return torch.amax(xs, dim=_stack_axis(axis))


class StdSemiring(Semiring):
    """Counting semiring (+, *, 0, 1)."""

    zero = 0.0
    one = 1.0

    @classmethod
    def mul(cls, a, b):
        return a * b

    @classmethod
    def sum(cls, xs, axis=-1):
        return torch.sum(xs, dim=_stack_axis(axis))

    @classmethod
    def prod(cls, xs, axis=-1):
        return torch.prod(xs, dim=_stack_axis(axis))


def TempMaxSemiring(alpha: float):
    """Temperature-annealed max: ``sum = logsumexp(alpha * x) / alpha``
    (alpha -> inf recovers MaxSemiring, alpha = 1 LogSemiring)."""

    class _TempMax(_BaseLog):
        @classmethod
        def sum(cls, xs, axis=-1):
            return torch.logsumexp(alpha * xs, dim=_stack_axis(axis)) / alpha

    _TempMax.__name__ = f"TempMaxSemiring({alpha})"
    return _TempMax


def KMaxSemiring(k: int):
    """Top-k max semiring: values stacked ``[k, ...]`` sorted descending,
    channel 0 is the max."""

    class _KMax(_BaseLog):
        size = k

        @classmethod
        def convert(cls, xs):
            rest = torch.full((k - 1,) + tuple(xs.shape), NEGINF,
                              dtype=xs.dtype, device=xs.device)
            return torch.cat([xs[None], rest], 0)

        @classmethod
        def unconvert(cls, xs):
            return xs[0]

        @classmethod
        def ones(cls, shape, dtype=torch.float32, device=None):
            out = _full(k, shape, NEGINF, dtype, device)
            out[0] = 0.0
            return out

        @classmethod
        def mul(cls, a, b):
            # every pair of ranks, then the k best
            c = a[:, None] + b[None, :]
            c = c.reshape((k * k,) + tuple(c.shape[2:]))
            top = torch.topk(torch.movedim(c, 0, -1), k, dim=-1).values
            return torch.movedim(top, -1, 0)

        @classmethod
        def sum(cls, xs, axis=-1):
            # fold the reduced axis into the rank axis, keep the k best
            xs = torch.movedim(xs, _stack_axis(axis), -1)  # [k, ..., m]
            xs = torch.movedim(xs, 0, -2)  # [..., k, m]
            flat = xs.reshape(tuple(xs.shape[:-2]) + (-1,))
            top = torch.topk(flat, k, dim=-1).values  # [..., k]
            return torch.movedim(top, -1, 0)

    _KMax.__name__ = f"KMaxSemiring({k})"
    return _KMax


def _log_softmax_parts(x, ax):
    part = torch.logsumexp(x, dim=ax)
    log_sm = x - part.unsqueeze(ax)
    return part, log_sm, torch.exp(log_sm)


class EntropySemiring(Semiring):
    """Expectation semiring computing (log Z, H): channel 0 the log inside
    scores, channel 1 the running entropy term."""

    size = 2

    @classmethod
    def convert(cls, xs):
        return torch.stack([xs, torch.zeros_like(xs)])

    @classmethod
    def unconvert(cls, xs):
        return xs[1]

    @classmethod
    def zeros(cls, shape, dtype=torch.float32, device=None):
        z = torch.zeros((2,) + tuple(shape), dtype=dtype, device=device)
        z[0] = NEGINF
        return z

    @classmethod
    def ones(cls, shape, dtype=torch.float32, device=None):
        return torch.zeros((2,) + tuple(shape), dtype=dtype, device=device)

    @classmethod
    def mul(cls, a, b):
        return a + b

    @classmethod
    def prod(cls, xs, axis=-1):
        return torch.sum(xs, dim=_stack_axis(axis))

    @classmethod
    def sum(cls, xs, axis=-1):
        # xs[c] is the per-channel view, so ``axis`` indexes it directly
        part, log_sm, sm = _log_softmax_parts(xs[0], axis)
        ent = torch.sum(xs[1] * sm - log_sm * sm, dim=axis)
        return torch.stack([part, ent])

    @classmethod
    def mask(cls, xs, keep):
        return torch.stack([torch.where(keep, xs[0], NEGINF),
                            torch.where(keep, xs[1], 0.0)])


class _PairedExpectation(Semiring):
    """Shared machinery of the cross-entropy, KL and risk semirings:
    channels (p, q, value)."""

    size = 3

    @classmethod
    def convert(cls, xs):
        p, q = xs
        return torch.stack([p, q, torch.zeros_like(p)])

    @classmethod
    def unconvert(cls, xs):
        return xs[2]

    @classmethod
    def zeros(cls, shape, dtype=torch.float32, device=None):
        z = torch.zeros((3,) + tuple(shape), dtype=dtype, device=device)
        z[0] = NEGINF
        z[1] = NEGINF
        return z

    @classmethod
    def ones(cls, shape, dtype=torch.float32, device=None):
        return torch.zeros((3,) + tuple(shape), dtype=dtype, device=device)

    @classmethod
    def mul(cls, a, b):
        return a + b

    @classmethod
    def prod(cls, xs, axis=-1):
        return torch.sum(xs, dim=_stack_axis(axis))

    @classmethod
    def mask(cls, xs, keep):
        return torch.stack([torch.where(keep, xs[0], NEGINF),
                            torch.where(keep, xs[1], NEGINF),
                            torch.where(keep, xs[2], 0.0)])


class CrossEntropySemiring(_PairedExpectation):
    """Computes (log Zp, log Zq, H[p, q])."""

    @classmethod
    def sum(cls, xs, axis=-1):
        part_p, _, sm_p = _log_softmax_parts(xs[0], axis)
        part_q, log_sm_q, _ = _log_softmax_parts(xs[1], axis)
        ce = torch.sum(xs[2] * sm_p - log_sm_q * sm_p, dim=axis)
        return torch.stack([part_p, part_q, ce])


class KLDivergenceSemiring(_PairedExpectation):
    """Computes (log Zp, log Zq, KL[p || q])."""

    @classmethod
    def sum(cls, xs, axis=-1):
        part_p, log_sm_p, sm_p = _log_softmax_parts(xs[0], axis)
        part_q, log_sm_q, _ = _log_softmax_parts(xs[1], axis)
        kl = torch.sum(xs[2] * sm_p - log_sm_q * sm_p + log_sm_p * sm_p, dim=axis)
        return torch.stack([part_p, part_q, kl])


class RiskSemiring(_PairedExpectation):
    """Computes the expected cost E_p[cost]; ``convert`` takes
    ``(log_potentials, cost)``."""

    @classmethod
    def zeros(cls, shape, dtype=torch.float32, device=None):
        z = torch.zeros((3,) + tuple(shape), dtype=dtype, device=device)
        z[0] = NEGINF
        return z

    @classmethod
    def mask(cls, xs, keep):
        return torch.stack([torch.where(keep, xs[0], NEGINF),
                            torch.where(keep, xs[1], 0.0),
                            torch.where(keep, xs[2], 0.0)])

    @classmethod
    def sum(cls, xs, axis=-1):
        part_p, _, sm_p = _log_softmax_parts(xs[0], axis)
        risk = torch.sum((xs[1] + xs[2]) * sm_p, dim=axis)
        return torch.stack([part_p, torch.zeros_like(part_p), risk])
