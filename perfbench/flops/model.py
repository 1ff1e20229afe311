"""Operations a step of the joint model needs, counted on the real
(unpadded) rows of its batch, by precision.

A matrix product of ``m x k`` by ``k x n`` counts ``2 m n k``; elementwise
work, softmaxes and norms are not counted. Counted:

- the frozen BERT's forward over each caption's real subwords (f32);
- the trainable modules' products (the visual factor heads in bf16, the
  rest f32): forward, and in training twice that again for the backward;
- the matching: K5's product on the live rows of its masks and, in
  training, K6's two multiply-adds per feature of each distinct winning cell
  (both bf16);
- the DP charts: ``dmv_inside_ops`` x 3 a fused pass (inside and outside),
  two passes (log and max) a step.

Recomputed work (the own-image block of the loss, the second projection of
the visual factors) is counted once.
"""

from __future__ import annotations

from .bounds import PEAK_FLOPS, dmv_inside_ops


def transformer_ops(S: int, H: int, L: int, inter: int) -> int:
    """Forward products of ``L`` encoder layers over ``S`` positions."""
    return L * (2 * S * (4 * H * H + 2 * H * inter) + 4 * S * S * H)


def step_ops(w: dict, rec: dict, train: bool) -> dict:
    """``{"f32": ops, "bf16": ops}`` of one step. ``w``: the config's
    widths; ``rec``: the step's real sizes (``seq_len``, ``subword_len``,
    ``boxes`` per real caption, ``k5_live`` [(n_v, n_q, D)], ``k6_cells``
    [cells], ``D``)."""
    f32 = bf16 = 0
    bert = w["bert"]
    H, h, m = bert["hidden_size"], w["hidden"], w["match_hidden"]
    for S in rec["subword_len"]:
        f32 += transformer_ops(int(S), H, bert["num_hidden_layers"],
                               bert["intermediate_size"])
    F = w["feat_dim"]
    emb = H + w["tag_dim"]
    r, mid = w["rank"], w["mid_bottleneck"]
    fwd32 = fwd16 = 0
    for L, P in zip(rec["seq_len"], rec["boxes"]):
        L, P = int(L), int(P)
        N = L + 1
        V = P + (P * (P + 1) // 2 if train else P * P) + P + 1
        fwd16 += 3 * 2 * P * (2 * F) * h  # rel, box and attr heads
        fwd32 += 2 * 2 * V * h * m  # the factors' projection (fusion, matching)
        fwd32 += 2 * L * emb * h  # text encoder
        fwd32 += 2 * L * V * m + 2 * L * V * h  # fusion: logits, matched features
        fwd32 += 2 * 2 * N * h * m  # word encoder (fusion, factors)
        fwd32 += 2 * 2 * N * h * m  # child and parent encoders
        fwd32 += 2 * N * m * m * m + 2 * 2 * N * m * m  # arc bilinear and its linear part
        fwd32 += 2 * L * (emb + h) * h  # head MLP
        # skip-connect encoder per word: valence (2 bottlenecks, dense),
        # direction (2 x 2 bottlenecks, dense), mid pair on 4 rows
        fwd32 += L * (2 * 2 * 2 * h * mid + 2 * 2 * h * h
                      + 4 * 2 * 2 * h * mid + 4 * 2 * h * h + 4 * 2 * 2 * h * h)
        fwd32 += L * 3 * (4 * 2 * h * r)  # scorers' first projections
        fwd32 += L * 4 * r * 2 * (w["n_token"] + 2)  # attach and dec bilinears
        Q = 2 * N
        fwd32 += 2 * Q * V * m  # own-image block
    f32 += fwd32 * (3 if train else 1)
    bf16 += fwd16 * (3 if train else 1)
    for n_v, n_q, D in rec["k5_live"]:
        bf16 += 2 * n_v * n_q * D
    for cells in rec.get("k6_cells", ()):
        bf16 += 4 * cells * rec["D"]
    f32 += 2 * 3 * dmv_inside_ops(rec["seq_len"])
    return {"f32": f32, "bf16": bf16}


def ideal_s(ops: dict) -> float:
    """Seconds at the peak of each precision."""
    return sum(n / PEAK_FLOPS[k] for k, n in ops.items())
