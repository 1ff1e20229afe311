"""What each kernel launch of a traced stretch was given, recorded by
wrapping the program's kernel entry points from outside (the program is not
changed): K1 (``ops.dmv_cuda.dmv_fused``), K5 (``ops.match.match_maxes``)
and K6 (``ops.match.match_maxes_bwd``). The tensors are kept and read after
the stretch, so the stretch itself makes no host sync."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def launches():
    """Yield ``{"k1": [(n1, lengths)], "k5": [(vis_bias, txt_bias, D)],
    "k6": [(logit_idx, logit_v_idx, D)]}`` filled while the block runs."""
    from vlgae_tpu_torch.ops import dmv_cuda, match

    rec = {"k1": [], "k5": [], "k6": []}
    orig = (dmv_cuda.dmv_fused, match.match_maxes, match.match_maxes_bwd)

    def k1(dec, attach, lengths, kind="log"):
        rec["k1"].append((dec.shape[1], lengths.detach()))
        return orig[0](dec, attach, lengths, kind)

    def k5(vis, txt, vis_bias, txt_bias):
        rec["k5"].append((vis_bias.detach(), txt_bias.detach(), vis.shape[2]))
        return orig[1](vis, txt, vis_bias, txt_bias)

    def k6(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
        rec["k6"].append((logit_idx.detach(), logit_v_idx.detach(), vis.shape[2]))
        return orig[2](vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)

    dmv_cuda.dmv_fused, match.match_maxes, match.match_maxes_bwd = k1, k5, k6
    try:
        yield rec
    finally:
        dmv_cuda.dmv_fused, match.match_maxes, match.match_maxes_bwd = orig


def bounds(rec) -> dict:
    """Per kernel family, the summed bound seconds of the recorded launches,
    and the live rows and winning cells the model count reads."""
    from ..flops import bounds as b

    out = {"k1_s": 0.0, "k5_s": 0.0, "k6_s": 0.0, "k5_live": [], "k6_cells": []}
    for n1, lengths in rec["k1"]:
        out["k1_s"] += b.dmv_bound(lengths.cpu().tolist(), int(n1), "fused")
    for vb, tb, D in rec["k5"]:
        A, V = vb.shape
        B, Q = tb.shape
        n_v, n_q = int((vb == 0).sum()), int((tb == 0).sum())
        out["k5_s"] += b.k5_bound(A, V, B, Q, D, n_v, n_q)
        out["k5_live"].append((n_v, n_q, int(D)))
    for li, lvi, D in rec["k6"]:
        B, A, Q = li.shape
        V = lvi.shape[2]
        cells = b.k6_cells(li, lvi)
        out["k6_s"] += b.k6_bound(A, V, B, Q, D, cells)
        out["k6_cells"].append(cells)
    return out
