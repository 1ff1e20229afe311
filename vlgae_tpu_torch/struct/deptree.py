"""Projective dependency tree (Eisner) inside pass, plain PyTorch, and the
matrix-tree functions of non-projective trees.

Counterpart of ``vlgae_tpu/struct/deptree.py``: the Log and Max fill
(``kind="log"|"max"``) and :func:`deptree_inside` in any semiring of
:mod:`.semirings`. Chart semantics and recursions are those of the
reference:

  - ``Cr[w, i]``: complete right span, head ``i`` covering ``i..i+w``;
  - ``Cl[w, i]``: complete left span, head ``i+w`` covering ``i..i+w``;
  - ``Ir[w, i]`` / ``Il[w, i]``: incomplete spans head ``i`` -> dep ``i+w``
    / head ``i+w`` -> dep ``i``;

  ilr[w,i]  = ⊕_t Cr[t,i] ⊗ Cl[w-1-t,i+1+t]
  Il[w,i]   = ilr ⊗ arc[i+w, i]
  Ir[w,i]   = ilr ⊗ arc[i, i+w]
  Cl[w,i]   = ⊕_t Il[w-t,i+t] ⊗ Cl[t,i]
  Cr[w,i]   = ⊕_t Ir[t+1,i] ⊗ Cr[w-1-t,i+1+t]

Single root is enforced by the semiring zero in ``Cr[w, 0]`` unless
``w == length``; ``multiroot`` skips it. The total is ``Cr[length, 0]``.
Arc potentials are ``[B, N1, N1]`` head x child with the root at row 0;
entries beyond each sentence's length are the semiring zero before the
fill. A labeled ``[B, N1, N1, L]`` table is reduced over its labels first
(:func:`reduce_labels`).

The rows are kept as in :mod:`.dmv`: per-width lists ``[B, N1]`` indexed by
span start, with end-indexed twins, so every split-point reduction is one
stack and one shifted slice. Gradients come from autograd (``amax`` splits
exact ties evenly, like ``jax.grad``). On the card the single-root CRF runs
on the DMV kernels instead (:class:`~.distributions.DependencyCRF`); this
fill serves ``multiroot`` on every device, and the CPU tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dmv import NEGINF, _convert, _reduce, _shift_generic, _step, _zero_fill
from .semirings import LogSemiring


def reduce_labels(arc, kind: str):
    """``[B, N1, N1, L] -> [B, N1, N1]``: the semiring sum over labels.
    In the log semiring the gradient reaches the labels as their softmax
    weights; in the max semiring it is split evenly among the maximal
    labels (``amax``), as ``jnp.max``'s gradient is."""
    arc = arc.float()
    if kind == "log":
        return torch.logsumexp(arc, dim=-1)
    return arc.amax(dim=-1)


def _shift(rows, k):
    """``out[:, e] = rows[:, e - k]`` along dim 1 (semiring zero fill)."""
    if k > 0:
        return F.pad(rows[:, :-k], (k, 0), value=NEGINF)
    return F.pad(rows[:, -k:], (0, -k), value=NEGINF)


def deptree_partition(arc, lengths, kind="log", multiroot: bool = False):
    """Per-sentence log Z (``kind="log"``) or best-tree score (``"max"``),
    ``[B]``, of ``arc [B, N1, N1]`` (or labeled ``[B, N1, N1, L]``) with
    ``lengths [B]`` word counts (clamped to ``[0, N1 - 1]``). Differentiable
    by autograd. ``kind`` may also be a semiring class (:mod:`.semirings`):
    then the total of :func:`deptree_inside` in that semiring, unconverted."""
    if not isinstance(kind, str):
        value, _ = deptree_inside(arc, lengths, kind, multiroot=multiroot)
        return kind.unconvert(value)
    if kind not in ("log", "max"):
        raise ValueError(f"kind must be 'log' or 'max', got {kind!r}")
    arc = reduce_labels(arc, kind) if arc.dim() == 4 else arc.float()
    B, N1 = arc.shape[:2]
    dev = arc.device
    lengths = lengths.to(device=dev, dtype=torch.long).clamp(0, N1 - 1)
    ar = torch.arange(N1, device=dev)
    inside = ar[None, :] <= lengths[:, None]  # [B, N1]
    arc = torch.where(inside[:, :, None] & inside[:, None, :], arc, NEGINF)

    def diag(w, left):
        i = ar[: N1 - w]
        rows = arc[:, i + w, i] if left else arc[:, i, i + w]
        return F.pad(rows, (0, w), value=NEGINF)  # [B, N1]

    one = arc.new_zeros(B, N1)
    Cr, Cl, CrE, ClE = [one], [one], [one], [one]
    Ir, IlE = [None], [None]
    for w in range(1, N1):
        valid = (ar < N1 - w)[None, :]
        crs = torch.stack(Cr[:w])  # [t, B, i] = Cr[t, i]
        cle = _shift(torch.stack([ClE[w - 1 - t] for t in range(w)]).flatten(0, 1),
                     -w).view(w, B, N1)  # Cl[w-1-t, i+1+t]
        ilr = _reduce(crs + cle, kind)
        il = torch.where(valid, ilr + diag(w, True), NEGINF)
        ir = torch.where(valid, ilr + diag(w, False), NEGINF)
        Ir.append(ir)
        IlE.append(_shift(il, w))
        ile = _shift(torch.stack([IlE[w - t] for t in range(w)]).flatten(0, 1),
                     -w).view(w, B, N1)  # Il[w-t, i+t]
        cl = _reduce(ile + torch.stack(Cl[:w]), kind)
        cre = _shift(torch.stack([CrE[w - 1 - t] for t in range(w)]).flatten(0, 1),
                     -w).view(w, B, N1)  # Cr[w-1-t, i+1+t]
        cr = _reduce(torch.stack(Ir[1:w + 1]) + cre, kind)
        keep = valid if multiroot else valid & (
            (ar[None, :] != 0) | (lengths[:, None] == w))
        cr = torch.where(keep, cr, NEGINF)
        cl = torch.where(valid, cl, NEGINF)
        Cr.append(cr)
        Cl.append(cl)
        CrE.append(_shift(cr, w))
        ClE.append(_shift(cl, w))
    return torch.stack(Cr)[:, :, 0].gather(0, lengths[None, :])[0]


def deptree_marginals(arc, lengths, kind="log", multiroot: bool = False):
    """``d sum(total) / d arc``: arc marginals (log) or the best tree's arc
    indicators (max), in the shape of ``arc``; ``kind`` a string or a
    semiring class, as in :func:`deptree_partition`. No graph is kept."""
    with torch.enable_grad():
        a = arc.detach().float().requires_grad_(True)
        total = deptree_partition(a, lengths, kind, multiroot).sum()
        if not total.requires_grad:  # n1 = 1: no arc takes part
            return torch.zeros_like(a)
        (g,) = torch.autograd.grad(total, a)
    return g


def deptree_inside(arc, lengths, semiring=LogSemiring, remat: bool = False,
                   multiroot: bool = False):
    """Inside pass of the projective dependency CRF in any semiring.

    ``arc [B, N1, N1]`` (head x child, root scores in row 0) or a pair of
    them for the paired semirings; a labeled ``[B, N1, N1, L]`` table is
    first summed over its labels in the semiring, and the gradient still
    reaches the labeled table. ``lengths [B]`` word counts (clamped to
    ``[0, N1 - 1]``); arcs beyond a sentence's length are the semiring zero.
    ``multiroot`` skips the single-root zeroing of ``Cr[w, 0]``; ``remat``
    recomputes each width step in the backward pass.

    Returns ``(value [size, B], charts)``, charts ``Cr, Cl, Ir, Il`` stacked
    ``[size, w, B, i]`` (``Ir``/``Il`` from width 1).
    """
    S = semiring
    if not isinstance(arc, (tuple, list)) and arc.dim() == 4:
        arc = S.sum(_convert(S, arc), axis=-1)
    else:
        arc = _convert(S, arc)
    s, B, N1 = arc.shape[:3]
    dev = arc.device
    lengths = lengths.to(device=dev, dtype=torch.long).clamp(0, N1 - 1)
    ar = torch.arange(N1, device=dev)
    inside = ar[None, :] <= lengths[:, None]  # [B, N1]
    arc = S.mask(arc, inside[:, :, None] & inside[:, None, :])

    def diag(w, left):
        i = ar[: N1 - w]
        rows = arc[:, :, i + w, i] if left else arc[:, :, i, i + w]
        return torch.cat([rows, _zero_fill(S, rows, (B, w))], 2)  # [s, B, N1]

    def shifted(rows_by_t, k):  # [s, t, B, N1] -> shift along i
        return _shift_generic(S, rows_by_t, k, 3)

    one = S.ones((B, N1), arc.dtype, dev)
    Cr, Cl, CrE, ClE = [one], [one], [one], [one]
    Ir, Il, IlE = [None], [None], [None]

    def step(w):
        valid = (ar < N1 - w)[None, :]
        crs = torch.stack(Cr[:w], 1)  # Cr[t, i]
        cle = shifted(torch.stack([ClE[w - 1 - t] for t in range(w)], 1), -w)
        ilr = S.sum(S.mul(crs, cle), axis=0)
        il = S.mask(S.mul(ilr, diag(w, True)), valid)
        ir = S.mask(S.mul(ilr, diag(w, False)), valid)
        ile = shifted(torch.stack(
            [_shift_generic(S, il, w, 2) if t == 0 else IlE[w - t]
             for t in range(w)], 1), -w)  # Il[w-t, i+t]
        cl = S.sum(S.mul(ile, torch.stack(Cl[:w], 1)), axis=0)
        cre = shifted(torch.stack([CrE[w - 1 - t] for t in range(w)], 1), -w)
        cr = S.sum(S.mul(torch.stack(Ir[1:w] + [ir], 1), cre), axis=0)
        keep = valid if multiroot else valid & (
            (ar[None, :] != 0) | (lengths[:, None] == w))
        return il, ir, S.mask(cl, valid), S.mask(cr, keep)

    for w in range(1, N1):
        il, ir, cl, cr = _step(S, remat, step, w)
        Il.append(il)
        Ir.append(ir)
        IlE.append(_shift_generic(S, il, w, 2))
        Cr.append(cr)
        Cl.append(cl)
        CrE.append(_shift_generic(S, cr, w, 2))
        ClE.append(_shift_generic(S, cl, w, 2))
    cr_all = torch.stack(Cr, 1)  # [s, w, B, i]
    value = cr_all[:, :, :, 0].gather(1, lengths[None, None, :].expand(s, 1, B))[:, 0]
    charts = {"Cr": cr_all, "Cl": torch.stack(Cl, 1)}
    if N1 > 1:
        charts["Ir"] = torch.stack(Ir[1:], 1)
        charts["Il"] = torch.stack(Il[1:], 1)
    return value, charts


def _laplacian(x, eps):
    """The matrix-tree Laplacian of ``x [B, N, N]`` (root scores on the
    diagonal), its first row replaced by the root weights."""
    N = x.shape[1]
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    ex = x.float().exp()
    lap = torch.where(eye, 0.0, ex + eps)
    lap = -lap + torch.diag_embed(lap.sum(1))
    return torch.cat([torch.diagonal(ex, dim1=-2, dim2=-1)[:, None, :],
                      lap[:, 1:]], 1)


def deptree_nonproj_marginals(arc_scores, eps: float = 1e-5):
    """Matrix-tree-theorem marginals of non-projective trees.

    ``arc_scores [B, N, N]`` holds root scores on the diagonal; the result
    ``[B, N, N]`` holds arc marginals with root marginals on the diagonal.
    The inverse is taken in f32, as vlgae_tpu computes it."""
    x = arc_scores.float()
    inv = torch.linalg.inv(_laplacian(x, eps))
    ex = x.exp()
    factor = torch.diagonal(inv, dim1=-2, dim2=-1)[:, :, None].expand_as(x).transpose(1, 2)
    term1 = ex * factor
    term2 = ex * inv.transpose(1, 2)
    term1 = torch.cat([torch.zeros_like(term1[:, :, :1]), term1[:, :, 1:]], 2)
    term2 = torch.cat([torch.zeros_like(term2[:, :1]), term2[:, 1:]], 1)
    roots = torch.diagonal(ex, dim1=-2, dim2=-1) * inv.transpose(1, 2)[:, 0]
    return term1 - term2 + torch.diag_embed(roots)


def deptree_nonproj_partition(arc_scores, eps: float = 1e-5):
    """Log-partition ``[B]`` of non-projective trees by the matrix-tree
    theorem (``slogdet`` in f32; the sign is dropped, as in vlgae_tpu)."""
    return torch.linalg.slogdet(_laplacian(arc_scores.float(), eps))[1]
