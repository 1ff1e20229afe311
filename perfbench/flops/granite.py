"""Operations of the granite-4.0-h encoder and the bound of K7, counted on
the real subwords and on the pairs K7 was given.

A matrix product of ``m x k`` by ``k x n`` counts ``2 m n k``; elementwise
work, norms, the conv's taps and softmaxes are not counted. The encoder is
frozen, so a training step counts its forward alone. Per caption of ``S``
real subwords (causal work on the ``S (S + 1) / 2`` pairs it needs):

- each Mamba2 layer: ``in_proj`` and ``out_proj`` (bf16); the SSD form's
  ``C·B`` and its weighting of ``x`` (f32);
- each attention layer: the four projections (bf16), the scores and the
  weighted values (bf16);
- every layer: the router (f32 operands), the shared expert (bf16); the
  routed experts from K7's launches: ``2·3·H·I`` a (position, held expert)
  pair it was given (bf16; the rows of a batch's filler captions, when it
  has them, included).
"""

from __future__ import annotations

from .bounds import bound_s


def _dims(g: dict) -> dict:
    H = g["hidden_size"]
    inner = g.get("mamba_expand", 2) * H
    return {"H": H, "inner": inner, "nh": g["mamba_n_heads"],
            "N": g["mamba_d_state"] * g.get("mamba_n_groups", 1),
            "hd": H // g["num_attention_heads"],
            "kv": g["num_key_value_heads"] * (H // g["num_attention_heads"]),
            "E": g["num_local_experts"], "I": g["intermediate_size"],
            "Is": g["shared_intermediate_size"]}


def caption_ops(g: dict, S: int) -> dict:
    """``{"bf16", "f32"}`` of the encoder's forward over one caption of
    ``S`` real subwords, the routed experts left out."""
    d = _dims(g)
    H, inner, N = d["H"], d["inner"], d["N"]
    pairs = S * (S + 1) // 2
    types = (g.get("layer_types") or ["mamba"] * g["num_hidden_layers"])
    types = types[:g["num_hidden_layers"]]
    n_m = sum(1 for t in types if t == "mamba")
    n_a = len(types) - n_m
    bf16 = n_m * (2 * S * H * (2 * inner + 2 * N + d["nh"]) + 2 * S * inner * H)
    f32 = n_m * (2 * pairs * N + 2 * pairs * inner)
    bf16 += n_a * (2 * S * H * (2 * H + 2 * d["kv"]) + 2 * 2 * pairs * H)
    L = len(types)
    f32 += L * 2 * S * H * d["E"]
    bf16 += L * (2 * S * H * 2 * d["Is"] + 2 * S * d["Is"] * H)
    return {"bf16": bf16, "f32": f32}


def expert_ops(g: dict, pairs: int) -> int:
    """bf16 operations of ``pairs`` (position, held expert) pairs."""
    return 2 * 3 * g["hidden_size"] * g["intermediate_size"] * int(pairs)


def encoder_ops(g: dict, subword_len, k7_pairs) -> dict:
    """A step's encoder operations: its captions' real subwords and the
    pairs of its K7 launches."""
    out = {"bf16": 0, "f32": 0}
    for S in subword_len:
        for k, v in caption_ops(g, int(S)).items():
            out[k] += v
    out["bf16"] += sum(expert_ops(g, p) for p in k7_pairs)
    return out


def k7_bound(H: int, inter: int, pairs: int, experts: int, rows: int, live: int,
             k: int) -> float:
    """Seconds: K7 for what its inputs need. Bytes: the weights of each held
    expert that got a pair (``3·H·I`` bf16), the bf16 rows of the positions
    with a pair, the f32 output rows of the live positions, and their
    choices and gates (int64 and f32, ``k`` a position). Operations:
    ``2·3·H·I`` a pair."""
    n_bytes = experts * 3 * H * inter * 2 + rows * H * 2 + live * H * 4 + live * k * 12
    return bound_s(n_bytes, 2 * 3 * H * inter * pairs, "bf16")
