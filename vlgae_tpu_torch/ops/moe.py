"""The held experts of a routed MoE layer: the plain version and the wrapper
of kernel K7 (``csrc/moe_experts.cu``). No TPU kernel is replaced: the JAX
package has no routed encoder (``models/granite_hybrid.py`` brought it).

    out[t] = sum over slots k in order, e0 <= sel[t, k] < e1, mask[t]:
             gates[t, k] * W_out[e] . rnd(silu(g) * u),   (g, u) = W_in[e] . x[t]

with ``e = sel[t, k] - e0``; ``W_in [nh, 2I, H]`` holds the gate rows then the
up rows (transformers' ``input_linear``), ``W_out [nh, H, I]``. Products
take the operands' dtype with f32 sums, ``rnd`` rounds the activation to
``W_out``'s dtype, and the output is f32: 0 where a position has no held
expert.

The wrapper is the ``torch.library.custom_op`` ``vlgae::moe_experts``: the
CUDA implementation launches K7 (bf16 operands only) and counts it under
``moe.k7``, the CPU implementation is the plain version, and a fake
implementation gives the output's shape for ``torch.export``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import Tensor

from ..utils import trace
from . import _build

_lib = None
# K7's limits and tiling (csrc/moe_experts.cu); the library is checked against them
MAX_HELD, MAX_TOP_K, TILE_ROWS, ROUTE_TOKENS = 64, 16, 64, 128
BLOCKS_PER_SM = 2


def moe_experts_plain(x, sel, gates, e0: int, e1: int, mask, w_in, w_out):
    """The plain version: for each slot k in order, each held expert's rows
    gathered, its SwiGLU MLP, the gated output added in f32."""
    T, H = x.shape
    inter = w_out.shape[-1]
    out = torch.zeros(T, H, dtype=torch.float32, device=x.device)
    xf = x.float()
    for k in range(sel.shape[1]):
        for e in range(e0, e1):
            rows = ((sel[:, k] == e) & mask).nonzero().flatten()
            if rows.numel() == 0:
                continue
            h = xf[rows] @ w_in[e - e0].float().T
            act = (F.silu(h[:, :inter]) * h[:, inter:]).to(w_out.dtype).float()
            out[rows] += gates[rows, k:k + 1].float() * (act @ w_out[e - e0].float().T)
    return out


def moe_plan(T: int, K: int, nh: int) -> dict:
    """K7's scratch for ``T`` positions, top-``K``, ``nh`` held experts: the
    most pairs (``pairs``), tiles (``max_tiles``) and int32 entries
    (``ints``: per route block and expert a count and an offset, each pair's
    position, each slot's pair, the tile table, the tile count)."""
    n_rt = -(-T // ROUTE_TOKENS)
    pairs = T * min(K, nh)
    max_tiles = -(-pairs // TILE_ROWS) + nh
    return {"pairs": pairs, "max_tiles": max_tiles,
            "ints": 2 * n_rt * nh + pairs + T * K + 3 * max_tiles + 1}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("moe_experts")
        lib.moe_experts_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.moe_experts_launch.restype = ctypes.c_int
        got = (lib.moe_max_held(), lib.moe_max_top_k(), lib.moe_tile_rows(),
               lib.moe_route_tokens())
        if got != (MAX_HELD, MAX_TOP_K, TILE_ROWS, ROUTE_TOKENS):
            raise RuntimeError(f"moe_experts.cu keeps (held, top-k, tile rows, route "
                               f"positions) {got}, ops/moe.py says "
                               f"{(MAX_HELD, MAX_TOP_K, TILE_ROWS, ROUTE_TOKENS)}")
        _lib = lib
    return _lib


def moe_experts_cuda(x, sel, gates, e0: int, e1: int, mask, w_in, w_out):
    """Launch K7. Same output as :func:`moe_experts_plain`."""
    T, H = x.shape
    nh = e1 - e0
    K = sel.shape[1] if sel.dim() == 2 else 0
    tensors = (x, sel, gates, mask, w_in, w_out)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise RuntimeError("moe_experts_cuda takes CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w_in.dtype != torch.bfloat16 or w_out.dtype != torch.bfloat16:
        raise TypeError(f"K7 takes bf16 states and weights, got {x.dtype}/{w_in.dtype}/"
                        f"{w_out.dtype}")
    if sel.dtype != torch.int64 or gates.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("K7 takes int64 selections, f32 gates and a bool mask")
    inter = w_out.shape[-1] if w_out.dim() == 3 else 0
    if (tuple(gates.shape) != (T, K) or tuple(mask.shape) != (T,)
            or tuple(w_in.shape) != (nh, 2 * inter, H) or tuple(w_out.shape) != (nh, H, inter)
            or not 0 < nh <= MAX_HELD or not 0 < K <= MAX_TOP_K or e0 < 0
            or H % 128 or inter % 64):
        raise ValueError(f"K7 shapes: x {tuple(x.shape)} sel {tuple(sel.shape)} gates "
                         f"{tuple(gates.shape)} mask {tuple(mask.shape)} w_in "
                         f"{tuple(w_in.shape)} w_out {tuple(w_out.shape)} held [{e0}, {e1})")
    if not all(t.is_contiguous() for t in tensors) or x.data_ptr() % 16:
        raise ValueError("moe_experts_cuda takes contiguous tensors, the states 16-byte aligned")
    lib = _library()
    dev = x.device
    plan = moe_plan(T, K, nh)
    out = torch.empty(T, H, dtype=torch.float32, device=dev)
    ints = torch.empty(plan["ints"], dtype=torch.int32, device=dev)
    row_gate = torch.empty(plan["pairs"], dtype=torch.float32, device=dev)
    act = torch.empty(plan["pairs"], inter, dtype=torch.bfloat16, device=dev)
    y = torch.empty(plan["pairs"], H, dtype=torch.float32, device=dev)
    blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        err = lib.moe_experts_launch(
            *(_build.ptr(t) for t in (x, sel, gates, mask, w_in, w_out, out, ints, row_gate,
                                      act, y)),
            T, K, H, inter, e0, nh, plan["max_tiles"], blocks, _build.stream_ptr(dev))
    _build.check(err, "moe_experts_launch")
    trace.count("moe.k7")
    return out


@torch.library.custom_op("vlgae::moe_experts", mutates_args=(), device_types="cuda")
def _moe_experts_op(x: Tensor, sel: Tensor, gates: Tensor, e0: int, e1: int, mask: Tensor,
                    w_in: Tensor, w_out: Tensor) -> Tensor:
    return moe_experts_cuda(x, sel, gates, e0, e1, mask, w_in, w_out)


@_moe_experts_op.register_kernel("cpu")
def _moe_experts_cpu(x, sel, gates, e0, e1, mask, w_in, w_out):
    return moe_experts_plain(x, sel, gates, e0, e1, mask, w_in, w_out)


@_moe_experts_op.register_fake
def _moe_experts_fake(x, sel, gates, e0, e1, mask, w_in, w_out):
    return x.new_empty(x.shape, dtype=torch.float32)


def moe_experts(x, sel, gates, e0: int, e1: int, mask, w_in, w_out):
    """``vlgae::moe_experts``: CUDA tensors launch K7 (or raise), CPU tensors
    take the plain version."""
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"moe_experts: unsupported device {x.device}")
    return _moe_experts_op(x, sel, gates, int(e0), int(e1), mask, w_in, w_out)
