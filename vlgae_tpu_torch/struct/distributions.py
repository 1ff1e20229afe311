"""DMV potentials and the DP dispatch (counterpart of
``vlgae_tpu/struct/distributions.py``: ``dmv_merge`` and
``dmv_value_and_grads_fast``), and :class:`DMVTotalFn`, the
differentiable DP total."""

from __future__ import annotations

import torch

from .dmv import NEGINF, NOCHILD, RIGHT, dmv_value_and_grads_plain


def dmv_merge(dec, attach, root, one: float = 0.0, zero: float = NEGINF):
    """Fold root potentials into position 0.

    The root token becomes the first token: it attaches exactly one child
    rightward with valence NOCHILD (score = ``root``) and its own
    decisions are free. ``dec [B, N, 2, 2, 2]``, ``attach [B, N, N, 2]``,
    ``root [B, N]`` -> ``(dec [B, N+1, 2, 2, 2], attach [B, N+1, N+1, 2])``.
    """
    B, N = dec.shape[:2]
    attach_w = attach.new_full((B, N + 1, N + 1, 2), zero)
    attach_w[:, 0, 1:, NOCHILD] = root.to(attach.dtype)
    attach_w[:, 1:, 1:, :] = attach
    dec_w = dec.new_full((B, N + 1, 2, 2, 2), zero)
    dec_w[:, 0, RIGHT] = one
    dec_w[:, 1:] = dec
    return dec_w, attach_w


def dmv_value_and_grads(dec, attach, lengths, kind: str = "log"):
    """Per-sentence totals and both gradient tables from one DP pass.

    Returns ``(per_sentence [B], d/d dec [B,N1,2,2,2], d/d attach
    [B,N1,N1,2])``: marginals in the log semiring, Viterbi indicators in
    the max semiring. A CUDA tensor goes to the fused kernel (K1); a CPU
    tensor takes the plain version. Nothing differentiates through the
    result.
    """
    if dec.is_cuda:
        from ..ops.dmv_cuda import dmv_fused

        return dmv_fused(dec, attach, lengths, kind)
    if dec.device.type != "cpu":
        raise RuntimeError(f"dmv_value_and_grads: unsupported device {dec.device}")
    return dmv_value_and_grads_plain(dec, attach, lengths, kind)


class DMVTotalFn(torch.autograd.Function):
    """Per-sentence DP total ``[B]`` with a gradient: the forward runs one
    pass of :func:`dmv_value_and_grads` (the fused kernel K1 on the card,
    the plain version on the CPU) and keeps both tables; the backward is
    those tables scaled by the cotangent (the fused path of
    vlgae_tpu/ops/dmv_pallas.py ``_make_dmv_total``). Lengths get no
    gradient."""

    @staticmethod
    def forward(ctx, dec, attach, lengths, kind="log"):
        total, g_dec, g_attach = dmv_value_and_grads(
            dec.detach(), attach.detach(), lengths, kind)
        ctx.save_for_backward(g_dec, g_attach)
        return total

    @staticmethod
    def backward(ctx, g):
        g_dec, g_attach = ctx.saved_tensors
        g = g.to(g_dec.dtype)
        return (g.view(-1, 1, 1, 1, 1) * g_dec,
                g.view(-1, 1, 1, 1) * g_attach, None, None)
