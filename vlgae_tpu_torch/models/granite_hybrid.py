"""granite-4.0-h (``model_type: granitemoehybrid``) as a frozen caption
encoder: the decoder stack of transformers' ``GraniteMoeHybridModel`` over
the caption's subwords, with its parameter names (``embed_tokens``,
``layers.<i>.{input_layernorm, mamba | self_attn, post_attention_layernorm,
block_sparse_moe, shared_mlp}``, ``norm``), so that a state dict loads into
either.

    h = 12 · embed(ids)                        (embedding_multiplier)
    per layer:  h += 0.22 · mixer(rms(h))      (Mamba2 or attention; residual_multiplier)
                h += 0.22 · (moe(rms(h)) + shared(rms(h)))
    states = [input of each layer ..., rms(h)]  (transformers' hidden_states)

- Mamba2 mixer: ``in_proj`` to z, xBC, dt; a causal depthwise conv1d of
  width ``mamba_d_conv`` with bias, then SiLU; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the SSD form in chunks of
  ``mamba_chunk_size`` (a caption's subwords fit one chunk, which has no
  inter-chunk term); the ``D`` skip; the gated RMSNorm ``norm(y ·
  silu(z))``; ``out_proj``. Padded positions are zeroed before ``in_proj``
  and after the conv, as the published code does.
- Attention: GQA, no positional encoding (NoPE), causal with the padding
  mask (masked keys take ``finfo(f32).min``), scale ``attention_multiplier``.
- MoE: the router's full-width product over all ``num_local_experts``
  experts, top-``num_experts_per_tok`` and the softmax over those; the layer
  holds experts ``[first_expert, first_expert + experts_held)`` (expert
  parallelism's slice: on one chip there is no exchange) and adds their
  gated outputs through K7 (:mod:`..ops.moe`), then the shared SwiGLU
  expert.

Precision (weights in bf16, the published dtype): GEMM operands bf16 with
f32 sums and f32 outputs (:func:`mm16`); the residual stream, the RMSNorms,
the router product (f32 operands) and its softmax, dt and the decays, the
SSD state and the gated norm in f32. With f32 weights everything is f32 (the
CPU tests). The encoder is frozen: it runs under ``no_grad`` as the BERT
item does, and its leaves stay out of the optimizer.

Spans (nested under ``vlgae.forward.text``): ``.mamba``, ``.attention``,
``.moe`` (router, K7, shared expert). Counter: ``text.positions`` (B·S
encoded a call).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import moe as moe_ops
from ..utils.trace import count, span

# transformers' GraniteMoeHybridConfig defaults, for the fields a config.json leaves out
_HF_GRANITE = dict(
    vocab_size=32000, hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=None, attention_multiplier=1.0, attention_bias=False,
    mamba_n_heads=128, mamba_d_head="auto", mamba_d_state=256, mamba_n_groups=1,
    mamba_d_conv=4, mamba_expand=2, mamba_chunk_size=256, mamba_conv_bias=True,
    mamba_proj_bias=False, num_local_experts=8, num_experts_per_tok=2,
    intermediate_size=11008, shared_intermediate_size=1024, embedding_multiplier=1.0,
    residual_multiplier=1.0, rms_norm_eps=1e-6, max_position_embeddings=2048)
_CAST = {"int": int, "float": float, "bool": bool}
# the values of the fields that change the function, as this module computes it
_GRANITE_FIXED = {"model_type": "granitemoehybrid", "hidden_act": "silu",
                  "normalization_function": "rmsnorm"}


@dataclasses.dataclass(frozen=True)
class GraniteConfig:
    """The encoder's shape, from a ``config.json`` (:meth:`from_dict`; the
    defaults of a key it leaves out are ``_HF_GRANITE``'s). ``experts_held``
    (0: all) and ``first_expert`` are this port's: the slice of each
    layer's experts held here."""

    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    layer_types: Tuple[str, ...]
    num_attention_heads: int
    num_key_value_heads: int
    attention_multiplier: float
    attention_bias: bool
    mamba_n_heads: int
    mamba_d_head: int
    mamba_d_state: int
    mamba_n_groups: int
    mamba_d_conv: int
    mamba_expand: int
    mamba_chunk_size: int
    mamba_conv_bias: bool
    mamba_proj_bias: bool
    num_local_experts: int
    num_experts_per_tok: int
    intermediate_size: int
    shared_intermediate_size: int
    embedding_multiplier: float
    residual_multiplier: float
    rms_norm_eps: float
    max_position_embeddings: int
    experts_held: int = 0
    first_expert: int = 0
    model_type = "granitemoehybrid"

    @property
    def held(self) -> Tuple[int, int]:
        """``[e0, e1)``: the experts a layer holds."""
        n = self.experts_held or self.num_local_experts
        return self.first_expert, self.first_expert + n

    @property
    def mamba_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    def layer_type(self, i: int) -> str:
        return self.layer_types[i] if self.layer_types else "mamba"

    @classmethod
    def from_dict(cls, disk: dict, where: str = "config") -> "GraniteConfig":
        """The shape in a ``config.json``'s dictionary (a field it leaves out
        takes transformers' default). A value this module does not compute
        (another ``model_type``, ``hidden_act`` or normalization, rotary
        positions, ``layer_types`` other than ``mamba`` / ``attention`` or
        fewer than the layers, heads or groups that do not divide, projection
        biases, a held slice outside the experts) raises a ``ValueError``."""
        for key, want in _GRANITE_FIXED.items():
            if disk.get(key, want) != want:
                raise ValueError(f"{where}: {key}={disk[key]!r}; the port's granite encoder "
                                 f"computes {key}={want!r} only")
        if disk.get("position_embedding_type") not in (None, "nope"):
            raise ValueError(f"{where}: position_embedding_type="
                             f"{disk['position_embedding_type']!r}; the port's granite encoder "
                             f"has no positional encoding (nope)")
        v = {k: disk.get(k, d) for k, d in _HF_GRANITE.items()}
        if v["num_key_value_heads"] is None:
            v["num_key_value_heads"] = v["num_attention_heads"]
        if v["mamba_d_head"] == "auto":
            v["mamba_d_head"] = v["mamba_expand"] * v["hidden_size"] // v["mamba_n_heads"]
        layers = int(v["num_hidden_layers"])
        types = tuple(disk.get("layer_types") or ())
        if types and (len(types) < layers or set(types) - {"mamba", "attention"}):
            raise ValueError(f"{where}: layer_types must name mamba or attention for each of "
                             f"the {layers} layers")
        kw = {k: _CAST[cls.__dataclass_fields__[k].type](x) for k, x in v.items()}
        c = cls(**kw, layer_types=types[:layers],
                experts_held=int(disk.get("experts_held", 0) or 0),
                first_expert=int(disk.get("first_expert", 0) or 0))
        H = c.hidden_size
        if (H % c.num_attention_heads or c.num_attention_heads % c.num_key_value_heads
                or c.mamba_n_heads % c.mamba_n_groups
                or c.mamba_n_heads * c.mamba_d_head != c.mamba_inner):
            raise ValueError(f"{where}: heads or groups do not divide the widths")
        if c.attention_bias or c.mamba_proj_bias:
            raise ValueError(f"{where}: the port's granite encoder has no projection biases")
        e0, e1 = c.held
        if not 0 <= e0 < e1 <= c.num_local_experts:
            raise ValueError(f"{where}: held experts [{e0}, {e1}) outside the "
                             f"{c.num_local_experts} experts")
        return c

    @classmethod
    def from_dir(cls, path: str) -> "GraniteConfig":
        """The shape in ``<path>/config.json`` (:meth:`from_dict`)."""
        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            return cls.from_dict(json.load(f), f"{path}/config.json")


def mm16(x, w):
    """``x @ w.T`` on operands of ``w``'s dtype with f32 sums, as f32."""
    if w.dtype == torch.float32:
        return x.float() @ w.T
    a = x.to(w.dtype).reshape(-1, x.shape[-1])
    if a.is_cuda:
        y = torch.mm(a, w.T, out_dtype=torch.float32)
    else:
        y = a.float() @ w.float().T
    return y.view(*x.shape[:-1], w.shape[0])


def rms_norm(x, weight, eps):
    """RMSNorm in f32 with the (upcast) scale."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight.float()


def _param(*shape, dtype):
    return nn.Parameter(torch.empty(*shape, dtype=dtype))


class _Linear(nn.Module):
    """A bias-free matrix ``weight [out, in]`` (transformers' ``nn.Linear``
    names), applied by :func:`mm16`."""

    def __init__(self, n_in, n_out, dtype):
        super().__init__()
        self.weight = _param(n_out, n_in, dtype=dtype)

    def forward(self, x):
        return mm16(x, self.weight)


class _Norm(nn.Module):
    def __init__(self, n, eps, dtype):
        super().__init__()
        self.weight = _param(n, dtype=dtype)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class _Conv(nn.Module):
    """The depthwise conv1d's parameters (``weight [C, 1, k]``, ``bias``)."""

    def __init__(self, channels, k, bias, dtype):
        super().__init__()
        self.weight = _param(channels, 1, k, dtype=dtype)
        self.bias = _param(channels, dtype=dtype) if bias else None


class MambaMixer(nn.Module):
    def __init__(self, c: GraniteConfig, dtype):
        super().__init__()
        self.c = c
        inner, N = c.mamba_inner, c.mamba_d_state
        self.conv_dim = inner + 2 * c.mamba_n_groups * N
        self.in_proj = _Linear(c.hidden_size, inner + self.conv_dim + c.mamba_n_heads, dtype)
        self.conv1d = _Conv(self.conv_dim, c.mamba_d_conv, c.mamba_conv_bias, dtype)
        self.dt_bias = _param(c.mamba_n_heads, dtype=dtype)
        self.A_log = _param(c.mamba_n_heads, dtype=dtype)
        self.D = _param(c.mamba_n_heads, dtype=dtype)
        self.norm = _Norm(inner, c.rms_norm_eps, dtype)
        self.out_proj = _Linear(inner, c.hidden_size, dtype)

    def forward(self, x, keep):
        """``x [B, S, H]`` normed, ``keep [B, S, 1]`` the real positions (f32)."""
        c = self.c
        B, S, _ = x.shape
        inner, N, nh, P, G = (c.mamba_inner, c.mamba_d_state, c.mamba_n_heads,
                              c.mamba_d_head, c.mamba_n_groups)
        zxbcdt = self.in_proj(x * keep)
        z, xbc, dt = zxbcdt.split([inner, self.conv_dim, nh], -1)
        k = c.mamba_d_conv
        w = self.conv1d.weight.float()
        bias = None if self.conv1d.bias is None else self.conv1d.bias.float()
        xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w, bias, groups=self.conv_dim)
        xbc = F.silu(xbc.transpose(1, 2)) * keep
        xs, Bm, Cm = xbc.split([inner, G * N, G * N], -1)
        dt = F.softplus(dt + self.dt_bias.float())  # [B, S, nh]
        A = -torch.exp(self.A_log.float())
        y = ssd(xs.view(B, S, nh, P), dt, A, Bm.view(B, S, G, N), Cm.view(B, S, G, N),
                c.mamba_chunk_size)
        y = y + self.D.float()[:, None] * xs.view(B, S, nh, P)
        y = y.reshape(B, S, inner) * F.silu(z)
        return self.out_proj(rms_norm(y, self.norm.weight, self.norm.eps))


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """The SSD form of the selective scan, f32: ``x [B, S, nh, P]``, ``dt [B,
    S, nh]``, ``A [nh]``, ``Bm``/``Cm [B, S, G, N]``; per chunk of ``chunk``
    positions the diagonal block ``(C_i · B_j) exp(cum_i - cum_j) dt_j x_j``
    (j <= i) plus, past the first chunk, the carried state's
    ``C_i exp(cum_i) state``. Returns ``y [B, S, nh, P]`` without the ``D``
    skip."""
    B, S, nh, P = x.shape
    G, N = Bm.shape[2:]
    rep = nh // G
    n_c = -(-S // chunk)
    L = chunk if n_c > 1 else S
    pad = n_c * L - S
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    x = x.view(B, n_c, L, nh, P)
    a = (dt * A).view(B, n_c, L, nh).permute(0, 1, 3, 2)  # [B, c, nh, L]
    cum = torch.cumsum(a, -1)
    xdt = x * dt.view(B, n_c, L, nh, 1)
    Bm = Bm.view(B, n_c, L, G, N)
    Cm = Cm.view(B, n_c, L, G, N)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, -torch.inf))
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cm, Bm)  # [B, c, G, L, L]
    m = cb.repeat_interleave(rep, 2) * decay  # [B, c, nh, L, L]
    y = torch.einsum("bchls,bcshp->bclhp", m, xdt)
    if n_c > 1:
        # each chunk's end state, carried across chunks with the chunks' decays
        to_end = torch.exp(cum[..., -1:] - cum)  # [B, c, nh, L]
        Bh = Bm.repeat_interleave(rep, 3)
        states = torch.einsum("bcshn,bchs,bcshp->bchpn", Bh, to_end, xdt)
        carried = [torch.zeros_like(states[:, 0])]
        for i in range(n_c - 1):
            carried.append(carried[-1] * torch.exp(cum[:, i, :, -1])[..., None, None]
                           + states[:, i])
        prev = torch.stack(carried, 1)  # the state entering each chunk
        Ch = Cm.repeat_interleave(rep, 3)
        y = y + torch.einsum("bclhn,bchpn,bchl->bclhp", Ch, prev, torch.exp(cum))
    return y.reshape(B, n_c * L, nh, P)[:, :S]


class Attention(nn.Module):
    def __init__(self, c: GraniteConfig, dtype):
        super().__init__()
        self.c = c
        H = c.hidden_size
        self.head_dim = H // c.num_attention_heads
        kv = c.num_key_value_heads * self.head_dim
        self.q_proj = _Linear(H, H, dtype)
        self.k_proj = _Linear(H, kv, dtype)
        self.v_proj = _Linear(H, kv, dtype)
        self.o_proj = _Linear(H, H, dtype)

    def forward(self, x, bias):
        """``bias [B, 1, S, S]``: 0 where a key is causal and real, else
        ``finfo(f32).min``."""
        c = self.c
        B, S, H = x.shape
        nq, nkv, hd = c.num_attention_heads, c.num_key_value_heads, self.head_dim
        dt = self.q_proj.weight.dtype
        q = self.q_proj(x).view(B, S, nq, hd).transpose(1, 2)
        k = self.k_proj(x).view(B, S, nkv, hd).transpose(1, 2)
        v = self.v_proj(x).view(B, S, nkv, hd).transpose(1, 2)
        k = k.repeat_interleave(nq // nkv, 1)
        v = v.repeat_interleave(nq // nkv, 1)
        s = _bmm16(q, k.transpose(-1, -2), dt) * c.attention_multiplier + bias
        p = torch.softmax(s, -1)
        o = _bmm16(p, v, dt).transpose(1, 2).reshape(B, S, H)
        return self.o_proj(o)


def _bmm16(a, b, dtype):
    """``a @ b`` on operands of ``dtype`` with f32 sums, as f32."""
    if dtype == torch.float32:
        return a @ b
    a16, b16 = a.to(dtype), b.to(dtype)
    if a16.is_cuda:
        lead = a.shape[:-2]
        out = torch.bmm(a16.reshape(-1, *a.shape[-2:]), b16.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*lead, a.shape[-2], b.shape[-1])
    return a16.float() @ b16.float()


class _Experts(nn.Module):
    def __init__(self, n, n_out, n_in, dtype):
        super().__init__()
        self.weight = _param(n, n_out, n_in, dtype=dtype)


class _Router(nn.Module):
    def __init__(self, n_in, n_experts, dtype):
        super().__init__()
        self.layer = _Linear(n_in, n_experts, dtype)


class MoE(nn.Module):
    """The routed experts of a layer: the router over all experts, the held
    slice's part through K7."""

    def __init__(self, c: GraniteConfig, dtype):
        super().__init__()
        self.c = c
        e0, e1 = c.held
        H, inter = c.hidden_size, c.intermediate_size
        self.input_linear = _Experts(e1 - e0, 2 * inter, H, dtype)
        self.output_linear = _Experts(e1 - e0, H, inter, dtype)
        self.router = _Router(H, c.num_local_experts, dtype)

    def route(self, x):
        """``(sel [T, k], gates [T, k], logits [T, E])``: the router's f32
        logits (f32 operands), their top-k and its softmax."""
        logits = x.float() @ self.router.layer.weight.float().T
        top, sel = logits.topk(self.c.num_experts_per_tok, -1)
        return sel, torch.softmax(top, -1), logits

    def forward(self, x, live, routes: Optional[list] = None):
        """``x [T, H]`` normed (f32), ``live [T]`` the real positions; the
        held experts' f32 sum. ``routes``, when given, gets this layer's
        ``(sel, logits)``."""
        sel, gates, logits = self.route(x)
        if routes is not None:
            routes.append((sel, logits))
        e0, e1 = self.c.held
        w_in = self.input_linear.weight
        return moe_ops.moe_experts(x.to(w_in.dtype).contiguous(), sel, gates, e0, e1, live,
                                   w_in, self.output_linear.weight)


class SharedMLP(nn.Module):
    def __init__(self, c: GraniteConfig, dtype):
        super().__init__()
        self.inter = c.shared_intermediate_size
        self.input_linear = _Linear(c.hidden_size, 2 * self.inter, dtype)
        self.output_linear = _Linear(self.inter, c.hidden_size, dtype)

    def forward(self, x):
        h = self.input_linear(x)
        return self.output_linear(F.silu(h[..., :self.inter]) * h[..., self.inter:])


class DecoderLayer(nn.Module):
    def __init__(self, c: GraniteConfig, i: int, dtype):
        super().__init__()
        self.c = c
        self.kind = c.layer_type(i)
        self.input_layernorm = _Norm(c.hidden_size, c.rms_norm_eps, dtype)
        self.post_attention_layernorm = _Norm(c.hidden_size, c.rms_norm_eps, dtype)
        if self.kind == "mamba":
            self.mamba = MambaMixer(c, dtype)
        else:
            self.self_attn = Attention(c, dtype)
        self.block_sparse_moe = MoE(c, dtype)
        self.shared_mlp = SharedMLP(c, dtype)

    def forward(self, h, keep, bias, live, routes=None):
        r = self.c.residual_multiplier
        x = self.input_layernorm(h)
        if self.kind == "mamba":
            with span("vlgae.forward.text.mamba"):
                h = h + self.mamba(x, keep) * r
        else:
            with span("vlgae.forward.text.attention"):
                h = h + self.self_attn(x, bias) * r
        with span("vlgae.forward.text.moe"):
            x = self.post_attention_layernorm(h)
            B, S, H = x.shape
            flat = x.reshape(B * S, H)
            y = self.block_sparse_moe(flat, live, routes) + self.shared_mlp(flat)
            h = h + y.view(B, S, H) * r
        return h


class GraniteHybrid(nn.Module):
    """The encoder; ``forward`` returns every layer's input and the final
    normed state, like ``output_hidden_states=True`` (all f32)."""

    def __init__(self, c: GraniteConfig, dtype=torch.bfloat16):
        super().__init__()
        self.config = c
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = _param(c.vocab_size, c.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(c, i, dtype)
                                    for i in range(c.num_hidden_layers))
        self.norm = _Norm(c.hidden_size, c.rms_norm_eps, dtype)

    def forward(self, ids, mask, routes: Optional[list] = None) -> List[torch.Tensor]:
        """``ids [B, S]``, ``mask [B, S]`` (real subwords); ``routes``, when
        given a list, gets each MoE layer's ``(sel, logits)``."""
        c = self.config
        B, S = ids.shape
        count("text.positions", B * S)
        h = F.embedding(ids.long(), self.embed_tokens.weight).float() * c.embedding_multiplier
        keep = mask[..., None].float()
        live = mask.reshape(-1).bool()
        bias = None
        if any(layer.kind == "attention" for layer in self.layers):
            causal = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
            ok = causal[None] & mask.bool()[:, None, :]
            bias = torch.where(ok, 0.0, torch.finfo(torch.float32).min)[:, None]
        states = []
        for layer in self.layers:
            states.append(h)
            h = layer(h, keep, bias, live, routes)
        states.append(self.norm(h))
        return states
