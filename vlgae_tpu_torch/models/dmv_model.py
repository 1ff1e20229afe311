"""Classic tabular (generative) DMV trained by EM (counterpart of
vlgae_tpu/models/dmv_model.py).

The parameters are three log-probability tables over token types, plain
tensors under the keys of vlgae_tpu's params (``root_param [n]``,
``trans_param [n, n, 2, 2]``, ``dec_param [n, 2, 2, 2]``). The E-step's
expected counts are the gradient of the log-partition (or of the Viterbi
score) with respect to the tables: on the card the chart-saving inside
kernel (K3a) runs forward and the outside kernel (K3b) backward through
:class:`~vlgae_tpu_torch.struct.DMVTotalFn`. The M-step normalises the
accumulated counts (:class:`EMAccumulator`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..struct import DependencyCRF, DMV1o, dmv_merge
from . import dmv_init

KEYS = ("root_param", "trans_param", "dec_param")


@dataclasses.dataclass(frozen=True)
class DMVConfig:
    """The tables' shape, start and M-step smoothing. Viterbi training and
    MBR decoding are chosen per call (``expected_counts(viterbi=)``,
    ``decode(mbr=)``)."""

    init_method: str = "km"  # km | good | random
    smooth: float = 0.1
    n_token: int = 0


def init_params(cfg: DMVConfig, token_seqs=None, head_seqs=None, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The (root, trans, dec) f32 log tables on ``device`` (the card unless
    the caller asks for the CPU; raises when no card is present): harmonic
    (``km``), recovered from head sequences (``good``), or standard normal
    from ``seed`` (``random``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available")
    n = cfg.n_token
    if cfg.init_method == "km":
        d, t, r = dmv_init.km_init(token_seqs, n, cfg.smooth)
    elif cfg.init_method == "good":
        d, t, r = dmv_init.good_init(token_seqs, head_seqs, n, cfg.smooth)
    elif cfg.init_method == "random":
        rng = np.random.default_rng(seed)
        d = rng.standard_normal((n, 2, 2, 2))
        r = rng.standard_normal((n,))
        t = rng.standard_normal((n, n, 2, 2))
    else:
        raise ValueError(f"init_method must be km, good or random, got {cfg.init_method!r}")
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in zip(KEYS, (r, t, d))}


def forward(params: Dict[str, torch.Tensor], token: torch.Tensor):
    """Merged per-sentence potentials ``(dec [B,L+1,2,2,2], attach
    [B,L+1,L+1,2])`` gathered from the tables for ``token [B, L]``: the
    RIGHT table where the head precedes the child or is the child (the upper
    triangle, diagonal included), the LEFT table below it."""
    token = token.long()
    t = params["trans_param"][token[:, :, None], token[:, None, :]]  # [B,L,L,dir,val]
    L = token.shape[1]
    right = torch.triu(torch.ones(L, L, dtype=torch.bool, device=token.device))
    t = torch.where(right[None, :, :, None], t[:, :, :, 1], t[:, :, :, 0])
    return dmv_merge(params["dec_param"][token], t, params["root_param"][token])


def loss(params, token, lengths, viterbi: bool):
    """``(-sum of per-sentence log-likelihoods, {"ll": their sum})``."""
    dist = DMV1o(forward(params, token), lengths)
    ll = dist.max if viterbi else dist.partition
    return -ll.sum(), {"ll": ll.sum()}


def expected_counts(params, token, lengths, viterbi: bool = False):
    """E-step counts: the gradient of the summed log Z (or Viterbi score)
    with respect to each table. The gather's backward accumulates with
    float atomics on the card, so counts vary there at the ulp level from
    run to run."""
    with torch.enable_grad():
        p = {k: params[k].detach().requires_grad_(True) for k in KEYS}
        dist = DMV1o(forward(p, token), lengths)
        total = (dist.max if viterbi else dist.partition).sum()
        grads = torch.autograd.grad(total, [p[k] for k in KEYS])
    return dict(zip(KEYS, grads))


@torch.no_grad()
def decode(params, token, lengths, mbr: bool):
    """Heads ``[B, L]``: the projective tree of the largest summed arc
    marginal (``mbr``: K1 log, then K1 max on the Eisner potentials), or
    the Viterbi tree (K1 max)."""
    dist = DMV1o(forward(params, token), lengths)
    if mbr:
        return DependencyCRF(dist.marginals.sum(-1), lengths).argmax_heads
    return dist.argmax_heads


class EMAccumulator:
    """M-step: ``accumulate`` adds E-step counts; ``apply`` returns the
    normalised log counts (``log_softmax(log(counts + smooth))`` over the
    root types, the decision and the child type) and resets."""

    def __init__(self, smooth: float):
        self.smooth = smooth
        self.counts: Optional[Dict[str, torch.Tensor]] = None

    def accumulate(self, counts: Dict[str, torch.Tensor]):
        if self.counts is None:
            self.counts = {k: v.detach().clone() for k, v in counts.items()}
        else:
            self.counts = {k: self.counts[k] + counts[k] for k in self.counts}

    def apply(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.counts is None:
            return params
        new = {k: torch.log_softmax(torch.log(self.counts[k] + self.smooth), dim)
               for k, dim in (("root_param", 0), ("dec_param", 3), ("trans_param", 1))}
        self.counts = None
        return new
