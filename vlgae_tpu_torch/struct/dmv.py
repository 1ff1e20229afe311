"""First-order DMV (with valence) inside pass, plain PyTorch.

Counterpart of ``vlgae_tpu/struct/dmv.py``. The kind-string functions
(``"log"``/``"max"``) are the plain versions of the CUDA kernels in ``csrc/dmv_fused.cu``
(:func:`dmv_value_and_grads_plain`), ``csrc/dmv_inside.cu``
(:func:`dmv_total`, :func:`dmv_inside_charts_plain`) and
``csrc/dmv_outside.cu`` (:func:`dmv_outside_plain`): the CPU tests and
``chip_smoke.py``'s comparison phases use them, the dispatch in
:mod:`vlgae_tpu_torch.struct.distributions` takes them only for tensors
that lie on the CPU. :func:`dmv_inside` is the same recursion in any
semiring of :mod:`.semirings` (entropy, k-max, sampling, ...), on the
tensors' own device.

Chart semantics and recursions are those of the reference
(NC/HC = NOCHILD/HASCHILD, ⊗/⊕ = semiring mul/sum):

  Il[w,i,v] = (⊕_t Cr[t,i,NC] ⊗ Cl[w-1-t,i+1+t,HC]) ⊗ attach[i+w,i,v] ⊗ dec[i+w,L,v,GO]
  Ir[w,i,v] = (⊕_t Cr[t,i,HC] ⊗ Cl[w-1-t,i+1+t,NC]) ⊗ attach[i,i+w,v] ⊗ dec[i,R,v,GO]
  Cl[w,i,v] = ⊕_t Il[w-t,i+t,v] ⊗ Cl[t,i,NC]
  Cr[w,i,v] = ⊕_t Ir[t+1,i,v] ⊗ Cr[w-1-t,i+1+t,NC]

with seeds ``Cr[0,i,v] = dec[i,R,v,STOP]``, ``Cl[0,i,v] = dec[i,L,v,STOP]``,
the single-root constraint (``Cr[w,0]`` is semiring-zero unless
``w == length``) and the total ``Cr[length,0,NC]``.

Each chart is kept as a list of per-width rows ``[B, N1, 2]`` indexed by
span start, plus an end-indexed twin (``E[w][e] = S[w][e-w]``), so every
split-point reduction of a width is one stack of earlier rows and one
shifted slice — the same trick as the reference's diagonal-major layout.
Gradients come from autograd: ``amax`` splits exact ties evenly, like
``jax.grad`` of ``jnp.max``, while the CUDA kernel marks every cell of
every best tree with 1; exact ties are outside the contract between the
two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .semirings import LogSemiring

# Constants of the reference (vlgae_tpu/struct/dmv.py, semirings.py).
NOCHILD = 1
HASCHILD = 0
LEFT = 0
RIGHT = 1
GO = 0
STOP = 1
NEGINF = -1e12


def _shift(rows, k):
    """``out[:, e] = rows[:, e - k]`` (k > 0) or ``rows[:, e + |k|]``
    (k < 0) along dim 1, filling with the semiring zero."""
    if k == 0:
        return rows
    if k > 0:
        return F.pad(rows[:, :-k], (0, 0, k, 0), value=NEGINF)
    return F.pad(rows[:, -k:], (0, 0, 0, -k), value=NEGINF)


def _reduce(x, kind):
    if kind == "log":
        return torch.logsumexp(x, dim=0)
    return torch.amax(x, dim=0)


def _inside_rows(dec, attach, lengths, kind, dtype=torch.float32):
    """The inside pass in ``dtype``: per-width lists ``(Cr, Cl, Ir, Il)`` of
    rows ``[B, N1, 2]`` indexed by span start (``Ir[0]``/``Il[0]`` are None),
    and the clamped lengths. Rows hold the semiring zero where the span runs
    past position N1 - 1; past a shorter sentence's end they hold values
    nothing reads."""
    if kind not in ("log", "max"):
        raise ValueError(f"kind must be 'log' or 'max', got {kind!r}")
    dec = dec.to(dtype)
    attach = attach.to(dtype)
    B, N1 = dec.shape[:2]
    dev = dec.device
    lengths = lengths.to(device=dev, dtype=torch.long).clamp(0, N1 - 1)
    att_r = attach + dec[:, :, None, RIGHT, :, GO]  # head i -> child c
    att_l = attach + dec[:, :, None, LEFT, :, GO]
    ar = torch.arange(N1, device=dev)

    def diag(table, w, left):
        i = ar[: N1 - w]
        rows = table[:, i + w, i] if left else table[:, i, i + w]
        return F.pad(rows, (0, 0, 0, w), value=NEGINF)  # [B, N1, 2]

    Cr = [dec[:, :, RIGHT, :, STOP]]
    Cl = [dec[:, :, LEFT, :, STOP]]
    CrE, ClE = list(Cr), list(Cl)
    Ir, IrE = [None], [None]
    Il, IlE = [None], [None]
    for w in range(1, N1):
        valid = (ar < N1 - w)[None, :, None]
        # incomplete spans: A[i] = ⊕_t Cr[t,i,·] ⊗ Cl[w-1-t,i+1+t,·]
        crs = torch.stack(Cr[:w])  # [t, B, N1, 2]
        cle = _shift(
            torch.stack([ClE[w - 1 - t] for t in range(w)]).flatten(0, 1), -w
        ).view(w, B, N1, 2)  # [t, B, i, v] = Cl[w-1-t, i+1+t, v]
        a_l = _reduce(crs[..., NOCHILD] + cle[..., HASCHILD], kind)
        a_r = _reduce(crs[..., HASCHILD] + cle[..., NOCHILD], kind)
        il = torch.where(valid, a_l[..., None] + diag(att_l, w, True), NEGINF)
        ir = torch.where(valid, a_r[..., None] + diag(att_r, w, False), NEGINF)
        Il.append(il)
        Ir.append(ir)
        IlE.append(_shift(il, w))
        IrE.append(_shift(ir, w))
        # complete spans
        ile = _shift(
            torch.stack([IlE[w - t] for t in range(w)]).flatten(0, 1), -w
        ).view(w, B, N1, 2)  # [t, B, i, v] = Il[w-t, i+t, v]
        cls = torch.stack(Cl[:w])[..., NOCHILD, None]
        cl = _reduce(ile + cls, kind)
        irs = torch.stack(Ir[1 : w + 1])  # [t, B, i, v] = Ir[t+1, i, v]
        cre = _shift(
            torch.stack([CrE[w - 1 - t] for t in range(w)]).flatten(0, 1), -w
        ).view(w, B, N1, 2)[..., NOCHILD, None]  # Cr[w-1-t, i+1+t, NC]
        cr = _reduce(irs + cre, kind)
        keep_root = (ar[None, :] != 0) | (lengths[:, None] == w)
        cr = torch.where(keep_root[..., None] & valid, cr, NEGINF)
        cl = torch.where(valid, cl, NEGINF)
        Cr.append(cr)
        Cl.append(cl)
        CrE.append(_shift(cr, w))
        ClE.append(_shift(cl, w))
    return Cr, Cl, Ir, Il, lengths


def dmv_total(dec, attach, lengths, kind: str = "log", dtype=torch.float32):
    """Per-sentence semiring total ``[B]`` (log Z or the Viterbi score).

    ``dec [B, N1, 2, 2, 2]`` and ``attach [B, N1, N1, 2]`` are merged
    (root at position 0) log-potentials, ``lengths [B]`` word counts
    (clamped to ``[0, N1 - 1]``); the pass runs in ``dtype`` (f32, the
    kernels' type; f64 gives a reference with less round-off).
    """
    Cr, _, _, _, lengths = _inside_rows(dec, attach, lengths, kind, dtype)
    root = torch.stack(Cr)[:, :, 0, NOCHILD]  # [w, B]
    return root.gather(0, lengths[None, :])[0]


def dmv_inside_charts_plain(dec, attach, lengths, kind: str = "log"):
    """``(total [B], charts [B, 4, N1, N1, 2])``: the four inside charts
    Cr, Cl, Ir, Il in the layout the chart-saving kernel writes
    (``charts[b, c, w, i, v]`` is the span ``[i, i+w]`` with valence ``v``),
    the semiring zero on cells outside the span triangle (``i + w`` past the
    sentence's length, and the width-0 row of Ir/Il)."""
    Cr, Cl, Ir, Il, lengths = _inside_rows(dec, attach, lengths, kind)
    B, N1 = Cr[0].shape[:2]
    zero = torch.full_like(Cr[0], NEGINF)
    charts = torch.stack([torch.stack([zero if r is None else r for r in rows], 1)
                          for rows in (Cr, Cl, Ir, Il)], 1)  # [B, 4, w, i, v]
    ar = torch.arange(N1, device=charts.device)
    inside = (ar[:, None] + ar[None, :])[None] <= lengths[:, None, None]  # [B, w, i]
    charts = torch.where(inside[:, None, :, :, None], charts, NEGINF)
    total = charts[torch.arange(B, device=charts.device), 0, lengths, 0, NOCHILD]
    return total, charts


def dmv_value_and_grads_plain(dec, attach, lengths, kind: str = "log",
                              dtype=torch.float32):
    """``(per_sentence [B], d total/d dec, d total/d attach)``.

    Marginals (log) or Viterbi-tree indicators (max) through autograd
    of :func:`dmv_total` in ``dtype``; no graph is kept for the caller.
    """
    with torch.enable_grad():
        d = dec.detach().to(dtype).requires_grad_(True)
        a = attach.detach().to(dtype).requires_grad_(True)
        per = dmv_total(d, a, lengths, kind, dtype)
        # with n1 = 1 (no words) attach takes no part: its gradient is 0
        gd, ga = torch.autograd.grad(per.sum(), (d, a), allow_unused=True)
    return per.detach(), gd, torch.zeros_like(a) if ga is None else ga


def dmv_outside_plain(dec, attach, lengths, gout, logz, charts, kind: str = "log",
                      dtype=torch.float32):
    """``(g_dec, g_attach)``: the gradient of ``sum(gout * total)`` with
    respect to the potentials, the contract of the outside kernel.

    The tables come from autograd of :func:`dmv_total` scaled by ``gout``;
    ``logz`` and ``charts`` (the hand-off of the chart-saving inside pass)
    are not read here, so a comparison pins their layout from the kernel's
    side: the outside kernel is run on the saved charts and on the plain
    charts, and the saved charts are compared with the plain ones. ``dtype``
    as :func:`dmv_total`'s."""
    _, gd, ga = dmv_value_and_grads_plain(dec, attach, lengths, kind, dtype)
    gout = gout.to(gd.dtype)
    return gout.view(-1, 1, 1, 1, 1) * gd, gout.view(-1, 1, 1, 1) * ga


# -- the generic fill: any semiring -------------------------------------------
# The kind-string functions above are the kernels' plain versions; the fill
# below takes a semiring class (:mod:`.semirings`) and serves the rest of the
# structured surface: entropy, the expectation semirings, k-max, counting,
# sampling and sparsemax. Its rows are stacked ``[size, B, N1, 2]``.


def _convert(S, x):
    """Lift raw or paired potentials into the stacked semiring layout."""
    if isinstance(x, (tuple, list)):
        return S.convert(tuple(xi.float() for xi in x))
    return S.convert(x.float())


def _zero_fill(S, like, shape):
    """The semiring zero, stacked, of per-channel ``shape``."""
    return S.zeros(shape, like.dtype, like.device)


def _shift_generic(S, rows, k, dim):
    """``out[..., e, ...] = rows[..., e - k, ...]`` along the stacked ``dim``
    (k > 0 right, k < 0 left), filled with the semiring zero."""
    if k == 0:
        return rows
    n = rows.shape[dim]
    fill_shape = list(rows.shape[1:])
    fill_shape[dim - 1] = abs(k)
    fill = _zero_fill(S, rows, fill_shape)
    if k > 0:
        return torch.cat([fill, rows.narrow(dim, 0, n - k)], dim)
    return torch.cat([rows.narrow(dim, -k, n + k), fill], dim)


def _step(S, remat, fn, *args):
    if remat:
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def dmv_inside(dec, attach, lengths, semiring=LogSemiring, remat: bool = False):
    """Inside pass of the first-order valence DMV in any semiring.

    ``dec [B, N1, 2, 2, 2]`` and ``attach [B, N1, N1, 2]`` are merged
    log-potentials (or pairs of them, for the paired semirings; lists go
    through ``semiring.convert``), ``lengths [B]`` word counts (clamped to
    ``[0, N1 - 1]``). ``remat`` recomputes each width step in the backward
    pass (``torch.utils.checkpoint``), trading compute for memory; the values
    are the same.

    Returns ``(value [size, B], charts)``: the stacked total (read it with
    ``semiring.unconvert``) and the four charts ``Cr, Cl, Ir, Il`` stacked
    ``[size, w, B, i, v]`` by width and span start (``Ir``/``Il`` from width
    1).
    """
    S = semiring
    dec = _convert(S, dec)  # [s, B, N1, 2, 2, 2]
    attach = _convert(S, attach)  # [s, B, N1, N1, 2]
    s, B, N1 = dec.shape[:3]
    dev = dec.device
    lengths = lengths.to(device=dev, dtype=torch.long).clamp(0, N1 - 1)
    att_r = S.mul(attach, dec[:, :, :, None, RIGHT, :, GO])  # head i -> child c
    att_l = S.mul(attach, dec[:, :, :, None, LEFT, :, GO])
    ar = torch.arange(N1, device=dev)

    def diag(table, w, left):
        i = ar[: N1 - w]
        rows = table[:, :, i + w, i] if left else table[:, :, i, i + w]
        return torch.cat([rows, _zero_fill(S, rows, (B, w, 2))], 2)  # [s, B, N1, 2]

    def shifted(rows_by_t, k):  # [s, t, B, N1, 2] -> shift along i
        return _shift_generic(S, rows_by_t, k, 3)

    Cr = [dec[:, :, :, RIGHT, :, STOP]]
    Cl = [dec[:, :, :, LEFT, :, STOP]]
    CrE, ClE = list(Cr), list(Cl)
    Ir, Il, IlE = [None], [None], [None]

    def step(w):
        valid = (ar < N1 - w)[None, :, None]  # [B, i, v] per-channel view
        crs = torch.stack(Cr[:w], 1)  # [s, t, B, i, v] = Cr[t, i, v]
        cle = shifted(torch.stack([ClE[w - 1 - t] for t in range(w)], 1), -w)
        # incomplete spans: ⊕_t Cr[t,i,·] ⊗ Cl[w-1-t,i+1+t,·]
        a_l = S.sum(S.mul(crs[..., NOCHILD], cle[..., HASCHILD]), axis=0)
        a_r = S.sum(S.mul(crs[..., HASCHILD], cle[..., NOCHILD]), axis=0)
        il = S.mask(S.mul(a_l[..., None], diag(att_l, w, True)), valid)
        ir = S.mask(S.mul(a_r[..., None], diag(att_r, w, False)), valid)
        ile = shifted(torch.stack(
            [_shift_generic(S, il, w, 2) if t == 0 else IlE[w - t]
             for t in range(w)], 1), -w)  # Il[w-t, i+t]
        cls = torch.stack(Cl[:w], 1)[..., NOCHILD, None]
        cl = S.sum(S.mul(ile, cls), axis=0)
        irs = torch.stack(Ir[1:w] + [ir], 1)  # Ir[t+1, i]
        cre = shifted(torch.stack([CrE[w - 1 - t] for t in range(w)], 1),
                      -w)[..., NOCHILD, None]  # Cr[w-1-t, i+1+t, NC]
        cr = S.sum(S.mul(irs, cre), axis=0)
        keep_root = (ar[None, :] != 0) | (lengths[:, None] == w)
        cr = S.mask(cr, keep_root[..., None] & valid)
        cl = S.mask(cl, valid)
        return il, ir, cl, cr

    for w in range(1, N1):
        il, ir, cl, cr = _step(S, remat, step, w)
        Il.append(il)
        Ir.append(ir)
        IlE.append(_shift_generic(S, il, w, 2))
        Cr.append(cr)
        Cl.append(cl)
        CrE.append(_shift_generic(S, cr, w, 2))
        ClE.append(_shift_generic(S, cl, w, 2))
    cr_all = torch.stack(Cr, 1)  # [s, w, B, i, v]
    root = cr_all[:, :, :, 0, NOCHILD]  # [s, w, B]
    value = root.gather(1, lengths[None, None, :].expand(s, 1, B))[:, 0]
    charts = {"Cr": cr_all, "Cl": torch.stack(Cl, 1)}
    if N1 > 1:
        charts["Ir"] = torch.stack(Ir[1:], 1)
        charts["Il"] = torch.stack(Il[1:], 1)
    return value, charts


def dmv_partition(dec, attach, lengths, semiring=LogSemiring):
    """Semiring total over all DMV trees, ``[B]`` (``semiring.unconvert``
    of :func:`dmv_inside`'s value). Differentiable by autograd."""
    value, _ = dmv_inside(dec, attach, lengths, semiring)
    return semiring.unconvert(value)


def dmv_marginals(dec, attach, lengths, semiring=LogSemiring):
    """``(d/d dec, d/d attach)`` of the summed semiring total: expected rule
    counts in the log semiring, Viterbi indicators in the max semiring. No
    graph is kept."""
    with torch.enable_grad():
        d = dec.detach().float().requires_grad_(True)
        a = attach.detach().float().requires_grad_(True)
        total = dmv_partition(d, a, lengths, semiring).sum()
        gd, ga = torch.autograd.grad(total, (d, a), allow_unused=True)
    return (torch.zeros_like(d) if gd is None else gd,
            torch.zeros_like(a) if ga is None else ga)
