"""DMV potentials, the DP dispatch and the ``DMV1o`` distribution
(counterpart of ``vlgae_tpu/struct/distributions.py``).

The dispatch is by what the caller needs:

* the total alone, no gradient wanted - :func:`dmv_total_fast`: the
  value-only inside kernel on the card;
* the total and both tables now, for a cotangent of one -
  :func:`dmv_value_and_grads`: the fused kernel;
* a differentiable total whose cotangent arrives later -
  :class:`DMVTotalFn`: the chart-saving inside kernel in the forward, the
  outside kernel in the backward.

Each goes through a custom op of :mod:`vlgae_tpu_torch.ops.dmv_cuda`: a
CPU tensor takes the plain versions of :mod:`.dmv`; a CUDA tensor goes to
the kernel or the call raises.

The projective dependency CRF (:class:`DependencyCRF`) rides the same
dispatch when it has a single root: an Eisner CRF is a DMV with free (zero)
decisions and valence-independent attach scores (:func:`eisner_as_dmv`).
With ``multiroot`` it takes the plain fill of :mod:`.deptree` on any device.

The rest of the surface (entropy, cross-entropy, KL, risk, counting, k-max,
samples, Gumbel relaxations) runs the generic semiring fills of
:mod:`.dmv` and :mod:`.deptree` on the tensors' own device, as vlgae_tpu
runs them through its ``lax.scan`` fills rather than its kernels.
"""

from __future__ import annotations

import torch

from . import deptree as _deptree
from . import dmv as _dmv
from .deptree import reduce_labels
from .dmv import HASCHILD, NEGINF, NOCHILD, RIGHT
from .semirings import (CrossEntropySemiring, EntropySemiring, KLDivergenceSemiring,
                        KMaxSemiring, RiskSemiring, StdSemiring)


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
    tensor takes the plain version (``vlgae::dmv_fused``). Nothing
    differentiates through the result.
    """
    from ..ops.dmv_cuda import dmv_fused

    _on_card_or_cpu(dec, "dmv_value_and_grads")
    return dmv_fused(dec, attach, lengths, kind)


def _on_card_or_cpu(dec, what):
    if dec.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{what}: unsupported device {dec.device}")


def dmv_grads_fast(dec, attach, lengths, kind: str = "log"):
    """``(d/d dec, d/d attach)`` of the summed total: the tables of
    :func:`dmv_value_and_grads`."""
    return dmv_value_and_grads(dec, attach, lengths, kind)[1:]


@torch.no_grad()
def dmv_total_fast(dec, attach, lengths, kind: str = "log"):
    """Per-sentence totals ``[B]`` (log Z or the Viterbi score) when no
    gradient is wanted: the value-only inside kernel (K2; K4 for tiny and
    long charts) on a CUDA tensor, :func:`~.dmv.dmv_total` on the CPU
    (``vlgae::dmv_inside``). The result carries no graph."""
    from ..ops.dmv_cuda import dmv_inside

    _on_card_or_cpu(dec, "dmv_total_fast")
    return dmv_inside(dec, attach, lengths, kind)


class DMVTotalFn(torch.autograd.Function):
    """Per-sentence DP total ``[B]`` with a gradient, as the two-launch pair
    of vlgae_tpu/ops/dmv_pallas.py ``_make_dmv_total``: the forward runs
    the inside pass that saves its charts (K3a; K4 for tiny and long
    charts) and keeps them with the total; the backward runs the outside
    pass (K3b) with the cotangent that has arrived (``vlgae::dmv_inside_save``,
    ``vlgae::dmv_outside``). On the CPU both are the plain versions. Lengths
    get no gradient."""

    @staticmethod
    def forward(ctx, dec, attach, lengths, kind="log"):
        from ..ops.dmv_cuda import dmv_inside_save

        dec, attach = dec.detach().float(), attach.detach().float()
        total, charts = dmv_inside_save(dec, attach, lengths, kind)
        ctx.save_for_backward(dec, attach, lengths, total, charts)
        ctx.kind = kind
        return total

    @staticmethod
    def backward(ctx, g):
        dec, attach, lengths, total, charts = ctx.saved_tensors
        from ..ops.dmv_cuda import dmv_outside

        g = g.to(total.dtype).contiguous()
        g_dec, g_attach = dmv_outside(dec, attach, lengths, g, total, charts, ctx.kind)
        return g_dec, g_attach, None, None


def _total(dec, attach, lengths, kind: str = "log"):
    """The total by what the caller needs: :class:`DMVTotalFn` when a
    gradient can flow to the potentials, :func:`dmv_total_fast` otherwise."""
    if torch.is_grad_enabled() and (dec.requires_grad or attach.requires_grad):
        return DMVTotalFn.apply(dec, attach, lengths, kind)
    return dmv_total_fast(dec, attach, lengths, kind)


class DMV1o:
    """First-order valence DMV distribution over merged (with-root)
    potentials ``(dec, attach)``; see :func:`dmv_merge`. The totals
    differentiate when their inputs require a gradient; the tables come from
    one fused pass and carry no graph."""

    def __init__(self, log_potentials, lengths):
        self.dec, self.attach = log_potentials
        self.lengths = lengths

    @property
    def partition(self):
        return _total(self.dec, self.attach, self.lengths, "log")

    @property
    def max(self):
        return _total(self.dec, self.attach, self.lengths, "max")

    def _tables(self, kind):
        return dmv_value_and_grads(self.dec.detach(), self.attach.detach(),
                                   self.lengths, kind)[1:]

    @property
    def marginals(self):
        """Attach marginals ``[B, N1, N1, 2]``."""
        return self._tables("log")[1]

    @property
    def marginals_full(self):
        """(dec, attach) expected counts."""
        return self._tables("log")

    @property
    def argmax(self):
        """Viterbi attach indicators ``[B, N1, N1, 2]``."""
        return self._tables("max")[1]

    @property
    def argmax_heads(self):
        """Viterbi head array ``[B, N]`` (1-based heads, 0 = root)."""
        ind = self.argmax.sum(-1)  # [B, N1, N1]
        return torch.argmax(ind[:, :, 1:], dim=1)

    # -- the generic fill ------------------------------------------------
    def _inside(self, semiring, attach=None, dec=None):
        return _dmv.dmv_inside(self.dec if dec is None else dec,
                               self.attach if attach is None else attach,
                               self.lengths, semiring)[0]

    @property
    def entropy(self):
        """Tree entropy ``[B]`` (the Entropy semiring)."""
        return EntropySemiring.unconvert(self._inside(EntropySemiring))

    def cross_entropy(self, other: "DMV1o"):
        """H[self, other] ``[B]``."""
        return CrossEntropySemiring.unconvert(self._inside(
            CrossEntropySemiring, [self.attach, other.attach], [self.dec, other.dec]))

    def kl(self, other: "DMV1o"):
        """KL[self || other] ``[B]``."""
        return KLDivergenceSemiring.unconvert(self._inside(
            KLDivergenceSemiring, [self.attach, other.attach], [self.dec, other.dec]))

    @property
    def count(self):
        """Number of trees ``[B]`` over the potentials above the semiring
        zero (f32: not finite where the count overflows)."""
        ones_d = torch.where(self.dec <= NEGINF / 2, 0.0, 1.0)
        ones_a = torch.where(self.attach <= NEGINF / 2, 0.0, 1.0)
        return StdSemiring.unconvert(self._inside(StdSemiring, ones_a, ones_d))

    def kmax(self, k: int):
        """Scores of the k best trees, ``[k, B]``."""
        return self._inside(KMaxSemiring(k))

    def topk(self, k: int):
        """Attach indicators of the k best trees, ``[k, B, N1, N1, 2]``: the
        gradient of the i-th k-max channel routes through that tree."""
        S = KMaxSemiring(k)
        with torch.enable_grad():
            a = self.attach.detach().float().requires_grad_(True)
            value = self._inside(S, a, self.dec.detach())
            grads = [torch.autograd.grad(value[i].sum(), a, retain_graph=i + 1 < k)[0]
                     for i in range(k)]
        return torch.stack(grads)

    def sample(self, generator, num_samples: int = 1):
        """Exact forward-filter backward-sample trees: attach indicators
        ``[num_samples, B, N1, N1, 2]``, one inside pass and one bit-packed
        backward per 16 samples, drawn from ``generator`` (a
        ``torch.Generator`` on the potentials' device)."""
        from .sample import multi_sample_grads

        dec = self.dec.detach()

        def total(a, S):
            return S.unconvert(self._inside(S, a, dec))

        return multi_sample_grads(total, self.attach, generator, num_samples)

    def gumbel_crf(self, generator, temperature: float = 1.0):
        """A straight-through Gumbel relaxed sample of attach indicators
        ``[B, N1, N1, 2]``, noise drawn from ``generator``."""
        from .sample import GumbelCRFSemiring

        S = GumbelCRFSemiring(generator, temperature)
        with torch.enable_grad():
            a = self.attach.detach().float().requires_grad_(True)
            total = S.unconvert(self._inside(S, a, self.dec.detach())).sum()
            (g,) = torch.autograd.grad(total, a)
        return g


def eisner_as_dmv(arc):
    """DMV potentials ``(dec [B,N1,2,2,2], attach [B,N1,N1,2])`` whose
    trees score as the Eisner CRF over ``arc [B, N1, N1]``: free decisions,
    the arc score in both valences, and no second root child (the root row's
    HASCHILD channel is the semiring zero, as :func:`dmv_merge` builds it).
    Differentiable in ``arc``."""
    arc = arc.float()
    B, N1 = arc.shape[:2]
    attach = torch.stack([arc, arc], -1)
    attach[:, 0, :, HASCHILD] = NEGINF
    return arc.new_zeros(B, N1, 2, 2, 2), attach


def deptree_total_fast(arc, lengths, kind: str = "log", multiroot: bool = False):
    """Per-sentence Eisner CRF total ``[B]`` (log Z or the best tree's
    score) of ``arc [B,N1,N1]`` or labeled ``[B,N1,N1,L]`` (labels reduced
    first). Single root: the DMV totals of :func:`eisner_as_dmv` by what the
    caller needs (:func:`_total`: the chart-saving pair when a gradient can
    flow to ``arc``, the value-only inside pass otherwise). ``multiroot``:
    the plain fill, differentiable by autograd."""
    if multiroot:
        return _deptree.deptree_partition(arc, lengths, kind, multiroot=True)
    if arc.dim() == 4:
        arc = reduce_labels(arc, kind)
    dec, attach = eisner_as_dmv(arc)
    return _total(dec, attach, lengths, kind)


def deptree_grads_fast(arc, lengths, kind: str = "log", multiroot: bool = False):
    """``d sum(total) / d arc`` in the shape of ``arc``: arc marginals (log)
    or the best tree's indicators (max). Single root: one fused DP pass on
    :func:`eisner_as_dmv` (:func:`dmv_value_and_grads`: K1 on the card), its
    attach table summed over the two valences, the root row's HASCHILD
    channel and the dec table dropped; a labeled arc's gradient then reaches
    its labels through :func:`~.deptree.reduce_labels` by autograd.
    ``multiroot``: autograd of the plain fill. No graph is kept."""
    if multiroot:
        return _deptree.deptree_marginals(arc, lengths, kind, multiroot=True)
    labeled = arc.detach().float()
    flat = reduce_labels(labeled, kind) if arc.dim() == 4 else labeled
    dec, attach = eisner_as_dmv(flat)
    ga = dmv_value_and_grads(dec, attach, lengths, kind)[2]
    g = ga.sum(-1)
    g[:, 0] = ga[:, 0, :, NOCHILD]
    if arc.dim() == 3:
        return g
    with torch.enable_grad():
        a = labeled.requires_grad_(True)
        (gl,) = torch.autograd.grad(reduce_labels(a, kind), a, grad_outputs=g)
    return gl


class DependencyCRF:
    """Projective dependency CRF over ``arc [B, N1, N1]`` (head x child,
    root at row 0; or labeled ``[B, N1, N1, L]``) and ``lengths [B]``.

    ``multiroot=False`` allows exactly one child of the root; ``True`` is
    the standard Eisner recursion where position 0 may head any number of
    words. The totals differentiate when ``arc`` requires a gradient; the
    tables carry no graph."""

    def __init__(self, log_potentials, lengths, multiroot: bool = False):
        self.arc = log_potentials
        self.lengths = lengths
        self.multiroot = bool(multiroot)

    @property
    def partition(self):
        return deptree_total_fast(self.arc, self.lengths, "log", self.multiroot)

    @property
    def max(self):
        return deptree_total_fast(self.arc, self.lengths, "max", self.multiroot)

    @property
    def marginals(self):
        return deptree_grads_fast(self.arc, self.lengths, "log", self.multiroot)

    @property
    def argmax(self):
        return deptree_grads_fast(self.arc, self.lengths, "max", self.multiroot)

    @property
    def argmax_heads(self):
        """Viterbi head array ``[B, N]`` (head of word j at column j+1)."""
        return torch.argmax(self.argmax[:, :, 1:], dim=1)

    def log_prob(self, heads):
        """Log-probability ``[B]`` of head sequences ``[B, N]`` (1-based,
        0 = root); positions past a sentence's length are ignored."""
        N1 = self.arc.shape[1]
        cols = torch.arange(1, N1, device=self.arc.device)
        pos_ok = cols[None, :] <= self.lengths.to(self.arc.device)[:, None]
        score = torch.gather(self.arc[:, :, 1:], 1, heads[:, None, :].long())[:, 0]
        score = torch.where(pos_ok, score, 0.0).sum(-1)
        return score - self.partition

    # -- the generic fill ------------------------------------------------
    def _inside(self, semiring, arc=None):
        return _deptree.deptree_inside(self.arc if arc is None else arc,
                                       self.lengths, semiring,
                                       multiroot=self.multiroot)[0]

    @property
    def entropy(self):
        return EntropySemiring.unconvert(self._inside(EntropySemiring))

    def cross_entropy(self, other: "DependencyCRF"):
        return CrossEntropySemiring.unconvert(
            self._inside(CrossEntropySemiring, [self.arc, other.arc]))

    def kl(self, other: "DependencyCRF"):
        return KLDivergenceSemiring.unconvert(
            self._inside(KLDivergenceSemiring, [self.arc, other.arc]))

    def risk(self, cost):
        """Expected ``cost`` (a table shaped as the arcs) under the CRF."""
        return RiskSemiring.unconvert(self._inside(RiskSemiring, [self.arc, cost]))

    @property
    def count(self):
        ones = torch.where(self.arc <= NEGINF / 2, 0.0, 1.0)
        return StdSemiring.unconvert(self._inside(StdSemiring, ones))

    def kmax(self, k: int):
        """Scores of the k best trees, ``[k, B]``."""
        return self._inside(KMaxSemiring(k))

    def topk(self, k: int):
        """Arc indicators of the k best trees, ``[k, *arc.shape]``."""
        S = KMaxSemiring(k)
        with torch.enable_grad():
            a = self.arc.detach().float().requires_grad_(True)
            value = self._inside(S, a)
            grads = [torch.autograd.grad(value[i].sum(), a, retain_graph=i + 1 < k)[0]
                     for i in range(k)]
        return torch.stack(grads)

    def sample(self, generator, num_samples: int = 1):
        """Exact tree samples: arc indicators ``[num_samples, *arc.shape]``,
        one inside pass and one bit-packed backward per 16 samples."""
        from .sample import multi_sample_grads

        def total(a, S):
            return S.unconvert(self._inside(S, a))

        return multi_sample_grads(total, self.arc, generator, num_samples)

    def gumbel_crf(self, generator, temperature: float = 1.0):
        """A straight-through Gumbel relaxed sample of arc indicators."""
        from .sample import GumbelCRFSemiring

        S = GumbelCRFSemiring(generator, temperature)
        with torch.enable_grad():
            a = self.arc.detach().float().requires_grad_(True)
            (g,) = torch.autograd.grad(S.unconvert(self._inside(S, a)).sum(), a)
        return g
