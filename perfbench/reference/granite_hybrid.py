"""granite-4.0-h (``model_type: granitemoehybrid``) as a caption encoder, in
plain PyTorch from the published equations (transformers'
``modeling_granitemoehybrid.py``), on a dictionary of weights by name. It
imports nothing of the port, no JAX and no ``transformers``.

    h = 12 · embed(ids);   per layer:  h += 0.22 · mixer(rms(h))
                                       h += 0.22 · (moe(rms(h)) + shared(rms(h)))
    out = rms(h)           (RMSNorm: x · rsqrt(mean(x²) + eps) · weight, f32)

- Mamba2: ``in_proj`` to z, xBC, dt; a causal depthwise conv of width
  ``mamba_d_conv`` (its taps summed one by one) with bias, SiLU; ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the selective scan as its
  recurrence, one position at a time (``state = exp(dt A) state + dt x ⊗ B``,
  ``y = state · C``), not the chunked SSD form the port computes; the ``D``
  skip; the gated RMSNorm ``rms(y · silu(z))``; ``out_proj``. Padded
  positions are zeroed before ``in_proj`` and after the conv, as published.
- Attention: GQA, no positional encoding, causal with the padding mask
  (masked keys ``finfo(f32).min``), scores times ``attention_multiplier``.
- MoE: router logits over all ``num_local_experts`` experts, the top
  ``num_experts_per_tok``, softmax over those; only the held experts
  ``[first_expert, first_expert + experts_held)`` are computed, each on the
  positions that chose it, summed in expert order; then the shared SwiGLU
  expert. ``route``, when given, may replace a layer's choice (the
  benchmark's tie rule).

Precision (``Prec``): with ``bf16`` (the configuration's) every weight is
read rounded to bf16 (the published dtype) and every product's operands
are rounded to bf16 with f32 sums and f32 outputs, as the configuration
states; the residual stream, the norms, the router (f32 operands), dt, the
decays, the scan state and the gated norm stay f32. Without ``bf16``
everything is f32 (the CPU tests against transformers). ``low`` is the
control below the configuration: bf16 product outputs, a bf16 residual
stream and the router on bf16 operands. Departures from the published
code: none in the function; its bf16 runs round the residual stream and
every product's output to bf16 (``low`` does that), and sum the experts in
another order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


class Prec(NamedTuple):
    bf16: bool = True
    low: bool = False


def weight(W, name, p: Prec):
    """A weight as the program holds it: rounded to bf16 under ``bf16``."""
    w = W[name].float()
    return w.to(BF16).float() if p.bf16 else w


def op(x, p: Prec):
    """A product's operand: rounded to bf16 under ``bf16``."""
    return x.to(BF16).float() if p.bf16 else x


def out(y, p: Prec):
    """A product's output: f32, or bf16 under ``low``."""
    return y.to(BF16).float() if p.low else y


def linear(W, name, x, p: Prec):
    return out(op(x, p) @ weight(W, name, p).T, p)


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def stream(h, p: Prec):
    """The residual stream: f32, or bf16 under ``low``."""
    return h.to(BF16).float() if p.low else h


def dims(c: dict) -> dict:
    H = c["hidden_size"]
    nh = c["mamba_n_heads"]
    inner = c.get("mamba_expand", 2) * H
    d_head = c.get("mamba_d_head", "auto")
    e0 = c.get("first_expert", 0)
    held = c.get("experts_held") or c["num_local_experts"]
    return {"H": H, "nh": nh, "P": inner // nh if d_head == "auto" else d_head, "inner": inner,
            "N": c["mamba_d_state"], "G": c.get("mamba_n_groups", 1),
            "conv": c.get("mamba_d_conv", 4), "e0": e0, "e1": e0 + held}


def mamba(W, pre, c, x, keep, p: Prec):
    d = dims(c)
    B, S, _ = x.shape
    inner, N, G, nh, P, k = d["inner"], d["N"], d["G"], d["nh"], d["P"], d["conv"]
    conv_dim = inner + 2 * G * N
    zxbcdt = linear(W, pre + "in_proj.weight", x * keep, p)
    z, xbc, dt = zxbcdt.split([inner, conv_dim, nh], -1)
    cw = weight(W, pre + "conv1d.weight", p)[:, 0]  # [C, k]
    conv = weight(W, pre + "conv1d.bias", p).expand_as(xbc).clone()
    for j in range(k):  # tap j reads position t - (k - 1) + j
        shift = k - 1 - j
        if shift < S:
            conv[:, shift:] += cw[:, j] * xbc[:, :S - shift]
    xbc = F.silu(conv) * keep
    xs, Bm, Cm = xbc.split([inner, G * N, G * N], -1)
    dt = F.softplus(dt + weight(W, pre + "dt_bias", p))
    A = -torch.exp(weight(W, pre + "A_log", p))
    xs = xs.view(B, S, nh, P)
    Bh = Bm.view(B, S, G, N).repeat_interleave(nh // G, 2)
    Ch = Cm.view(B, S, G, N).repeat_interleave(nh // G, 2)
    state = torch.zeros(B, nh, P, N, device=x.device)
    ys = []
    for t in range(S):
        state = (state * torch.exp(dt[:, t] * A)[..., None, None]
                 + (dt[:, t, :, None] * xs[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, 1) + weight(W, pre + "D", p)[:, None] * xs
    y = rms(y.reshape(B, S, inner) * F.silu(z), weight(W, pre + "norm.weight", p),
            c["rms_norm_eps"])
    return linear(W, pre + "out_proj.weight", y, p)


def attention(W, pre, c, x, mask, p: Prec):
    B, S, H = x.shape
    nq, nkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = H // nq
    q = linear(W, pre + "q_proj.weight", x, p).view(B, S, nq, hd).transpose(1, 2)
    k = linear(W, pre + "k_proj.weight", x, p).view(B, S, nkv, hd).transpose(1, 2)
    v = linear(W, pre + "v_proj.weight", x, p).view(B, S, nkv, hd).transpose(1, 2)
    k = k.repeat_interleave(nq // nkv, 1)
    v = v.repeat_interleave(nq // nkv, 1)
    ok = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()[None] & mask[:, None, :]
    bias = torch.where(ok, 0.0, torch.finfo(torch.float32).min)[:, None]
    s = out(op(q, p) @ op(k, p).transpose(-1, -2), p) * c["attention_multiplier"] + bias
    o = out(op(torch.softmax(s, -1), p) @ op(v, p), p)
    return linear(W, pre + "o_proj.weight", o.transpose(1, 2).reshape(B, S, H), p)


def router_logits(W, pre, x, p: Prec):
    """f32 logits on f32 operands (bf16 operands under ``low``)."""
    w = weight(W, pre + "router.layer.weight", p)
    if p.low:
        return (x.to(BF16).float() @ w.T)
    return x @ w.T


def swiglu(W, name_in, name_out, x, p: Prec):
    h = linear(W, name_in, x, p)
    g, u = h.chunk(2, -1)
    return linear(W, name_out, F.silu(g) * u, p)


def moe(W, pre, c, x, live, p: Prec, choose: Optional[Callable] = None):
    """The held experts' part for ``x [T, H]`` (the positions ``live``),
    on the top-k of the logits or on ``choose(logits, top-k)``. Returns
    ``(out, logits, sel)``."""
    d = dims(c)
    logits = router_logits(W, pre, x, p)
    sel = logits.topk(c["num_experts_per_tok"], -1).indices
    if choose is not None:
        sel = choose(logits, sel)
    gates = torch.softmax(logits.gather(1, sel), -1)
    y = torch.zeros_like(x)
    w_in = W[pre + "input_linear.weight"]
    w_out = W[pre + "output_linear.weight"]
    for e in range(d["e0"], d["e1"]):
        hit = (sel == e) & live[:, None]
        rows = hit.any(1).nonzero().flatten()
        if rows.numel() == 0:
            continue
        g = (gates * hit).sum(1)[rows, None]
        tmp = {"i": w_in[e - d["e0"]], "o": w_out[e - d["e0"]]}
        y[rows] += g * swiglu(tmp, "i", "o", x[rows], p)
    return y, logits, sel


def encoder(W, pre: str, c: dict, ids, mask, p: Prec = Prec(),
            route: Optional[Callable] = None):
    """``(last normed state [B, S, H], [(logits [T, E], sel [T, k]) a layer])``
    for subword ids and mask ``[B, S]``. ``route(layer, logits, sel)``, when
    given, returns the choice the layer takes."""
    B, S = ids.shape
    H = c["hidden_size"]
    r = c["residual_multiplier"]
    eps = c["rms_norm_eps"]
    keep = mask[..., None].float()
    live = mask.reshape(-1)
    rows = {"e": W[pre + "embed_tokens.weight"][ids]}  # the rows read, rounded as held
    h = stream(weight(rows, "e", p) * c["embedding_multiplier"], p)
    routes = []
    types = c.get("layer_types") or ["mamba"] * c["num_hidden_layers"]
    for i in range(c["num_hidden_layers"]):
        lp = f"{pre}layers.{i}."
        x = rms(h, weight(W, lp + "input_layernorm.weight", p), eps)
        if types[i] == "mamba":
            y = mamba(W, lp + "mamba.", c, x, keep, p)
        else:
            y = attention(W, lp + "self_attn.", c, x, mask, p)
        h = stream(h + y * r, p)
        x = rms(h, weight(W, lp + "post_attention_layernorm.weight", p), eps).reshape(B * S, H)
        choose = None if route is None else (lambda lg, s, i=i: route(i, lg, s))
        y, logits, sel = moe(W, lp + "block_sparse_moe.", c, x, live, p, choose)
        y = y + swiglu(W, lp + "shared_mlp.input_linear.weight",
                       lp + "shared_mlp.output_linear.weight", x, p)
        h = stream(h + y.view(B, S, H) * r, p)
        routes.append((logits, sel))
    return rms(h, weight(W, pre + "norm.weight", p), eps), routes


def param_shapes(c: dict, pre: str = "") -> dict:
    """``{name: shape}`` of the encoder's weights (transformers' names under
    ``pre``), the held experts only."""
    d = dims(c)
    H, inner, N, G, nh = d["H"], d["inner"], d["N"], d["G"], d["nh"]
    conv_dim = inner + 2 * G * N
    hd = H // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * hd
    held = d["e1"] - d["e0"]
    inter, shared = c["intermediate_size"], c["shared_intermediate_size"]
    types = c.get("layer_types") or ["mamba"] * c["num_hidden_layers"]
    s = {pre + "embed_tokens.weight": (c["vocab_size"], H), pre + "norm.weight": (H,)}
    for i in range(c["num_hidden_layers"]):
        lp = f"{pre}layers.{i}."
        s[lp + "input_layernorm.weight"] = s[lp + "post_attention_layernorm.weight"] = (H,)
        if types[i] == "mamba":
            m = lp + "mamba."
            s[m + "in_proj.weight"] = (inner + conv_dim + nh, H)
            s[m + "conv1d.weight"] = (conv_dim, 1, d["conv"])
            s[m + "conv1d.bias"] = (conv_dim,)
            s[m + "dt_bias"] = s[m + "A_log"] = s[m + "D"] = (nh,)
            s[m + "norm.weight"] = (inner,)
            s[m + "out_proj.weight"] = (H, inner)
        else:
            a = lp + "self_attn."
            s[a + "q_proj.weight"] = s[a + "o_proj.weight"] = (H, H)
            s[a + "k_proj.weight"] = s[a + "v_proj.weight"] = (kv, H)
        e = lp + "block_sparse_moe."
        s[e + "input_linear.weight"] = (held, 2 * inter, H)
        s[e + "output_linear.weight"] = (held, H, inter)
        s[e + "router.layer.weight"] = (c["num_local_experts"], H)
        s[lp + "shared_mlp.input_linear.weight"] = (2 * shared, H)
        s[lp + "shared_mlp.output_linear.weight"] = (H, shared)
    return s
