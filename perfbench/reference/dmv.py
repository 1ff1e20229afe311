"""The first-order DMV with valence, plain PyTorch, from its recursion.

Charts over spans ``[i, i + w]`` (start ``i``, width ``w``), valence ``v``
(HASCHILD = 0, NOCHILD = 1), direction LEFT = 0 / RIGHT = 1, decision
GO = 0 / STOP = 1; ``R`` is the semiring sum (log-sum-exp or max), ``+``
its product:

  Il[w,i,v] = R_t (Cr[t,i,NC] + Cl[w-1-t,i+1+t,HC]) + attach[i+w,i,v] + dec[i+w,L,v,GO]
  Ir[w,i,v] = R_t (Cr[t,i,HC] + Cl[w-1-t,i+1+t,NC]) + attach[i,i+w,v] + dec[i,R,v,GO]
  Cl[w,i,v] = R_t Il[w-t,i+t,v] + Cl[t,i,NC]
  Cr[w,i,v] = R_t Ir[t+1,i,v] + Cr[w-1-t,i+1+t,NC]

seeded with ``Cr[0,i,v] = dec[i,R,v,STOP]`` and ``Cl[0,i,v] =
dec[i,L,v,STOP]``; the root sits at position 0 and may span the sentence
only whole (``Cr[w,0]`` is the zero unless ``w`` is the length); the total
is ``Cr[length,0,NC]``. Marginals and Viterbi indicators come from autograd
(``amax`` splits an exact tie evenly).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HC, NC = 0, 1
LEFT, RIGHT = 0, 1
GO, STOP = 0, 1
NEG = -1e12


def merge(dec, attach, root):
    """Fold the root into position 0: it takes one child to its right with
    valence NOCHILD (score ``root``) and decides freely."""
    B, N = dec.shape[:2]
    attach_w = torch.full((B, N + 1, N + 1, 2), NEG, dtype=attach.dtype, device=attach.device)
    attach_w[:, 0, 1:, NC] = root
    attach_w[:, 1:, 1:, :] = attach
    dec_w = torch.full((B, N + 1, 2, 2, 2), NEG, dtype=dec.dtype, device=dec.device)
    dec_w[:, 0, RIGHT] = 0.0
    dec_w[:, 1:] = dec
    return dec_w, attach_w


def total(dec, attach, lengths, kind: str):
    """Per-sentence log Z (``kind="log"``) or best-tree score (``"max"``)."""
    R = ((lambda x: torch.logsumexp(x, 0)) if kind == "log"
         else (lambda x: torch.amax(x, 0)))
    B, N1 = dec.shape[:2]
    dev = dec.device
    lengths = lengths.to(device=dev, dtype=torch.long).clamp(0, N1 - 1)
    Cr = [dec[:, :, RIGHT, :, STOP]]
    Cl = [dec[:, :, LEFT, :, STOP]]
    Ir, Il = [None], [None]
    ar = torch.arange(N1, device=dev)

    def pad(x, w):
        return F.pad(x, (0, 0, 0, w), value=NEG)

    def at(rows, idx, *tail):
        """``rows[t, b, idx[t, i], ...]``."""
        return torch.gather(rows, 2, idx[:, None, :].reshape(
            idx.shape[0], 1, idx.shape[1], *([1] * len(tail))).expand(
            idx.shape[0], B, idx.shape[1], *tail))

    for w in range(1, N1):
        n = N1 - w
        i = ar[:n]
        t = torch.arange(w, device=dev)
        nxt = i[None, :] + 1 + t[:, None]  # i + 1 + t
        same = i[None, :] + t[:, None]  # i + t
        cr_t = torch.stack(Cr[:w])[:, :, :n]  # Cr[t, i]
        cl_w = at(torch.stack(Cl[w - 1::-1]), nxt, 2)  # Cl[w-1-t, i+1+t]
        a_l = R(cr_t[..., NC] + cl_w[..., HC])
        a_r = R(cr_t[..., HC] + cl_w[..., NC])
        il = a_l[..., None] + attach[:, i + w, i, :] + dec[:, i + w, LEFT, :, GO]
        ir = a_r[..., None] + attach[:, i, i + w, :] + dec[:, i, RIGHT, :, GO]
        Il.append(pad(il, w))
        Ir.append(pad(ir, w))
        il_w = at(torch.stack(Il[w:0:-1]), same, 2)  # Il[w-t, i+t]
        cl = R(il_w + torch.stack(Cl[:w])[:, :, :n, NC, None])
        ir_t = torch.stack(Ir[1:w + 1])[:, :, :n]  # Ir[t+1, i]
        cr_w = at(torch.stack(Cr[w - 1::-1])[..., NC], nxt)  # Cr[w-1-t, i+1+t, NC]
        cr = R(ir_t + cr_w[..., None])
        keep = (i != 0)[None, :] | (lengths[:, None] == w)
        cr = torch.where(keep[..., None], cr, NEG)
        Cl.append(pad(cl, w))
        Cr.append(pad(cr, w))
    root = torch.stack(Cr)[:, :, 0, NC]  # [w, B]
    return root.gather(0, lengths[None, :])[0]


def value_and_grads(dec, attach, lengths, kind: str):
    """``(total [B], d/d dec, d/d attach)`` of detached potentials."""
    with torch.enable_grad():
        d = dec.detach().requires_grad_(True)
        a = attach.detach().requires_grad_(True)
        per = total(d, a, lengths, kind)
        gd, ga = torch.autograd.grad(per.sum(), (d, a), allow_unused=True)
    return per.detach(), gd, torch.zeros_like(a) if ga is None else ga
