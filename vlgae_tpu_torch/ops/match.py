"""Matching maxes: the plain version and the wrapper of kernel K5
(``csrc/match_fwd.cu``, replacing ``_fwd_kernel`` of
vlgae_tpu/ops/match_pallas.py).

    att[b, a, q, v] = txt[b, q] . vis[a, v] + vis_bias[a, v] + txt_bias[b, q]
    logit[b, a, q]   = max_v att   (int32 index of the first maximal v)
    logit_v[b, a, v] = max_q att   (int32 index of the first maximal q)

Operands are bf16, products and sums f32, biases f32 (the -1e9 visibility
masks). No ``[B, A, Q, V]`` tensor is stored by the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the kernel in this process (chip_smoke resets and reads it)
n_launches = 0

_lib = None
# elements of one plain-version [B, a-chunk, Q, V] f32 block
_PLAIN_BLOCK = 1 << 26


def match_maxes_plain(vis, txt, vis_bias, txt_bias):
    """``(logit [B,A,Q], logit_idx, logit_v [B,A,V], logit_v_idx)`` in plain
    PyTorch: f32 products of the (upcast) operands, chunked over images."""
    A, V, _ = vis.shape
    B, Q, _ = txt.shape
    vis_f, txt_f = vis.float(), txt.float()
    vb, tb = vis_bias.float(), txt_bias.float()
    step = max(1, _PLAIN_BLOCK // max(1, B * Q * V))
    outs = []
    for a0 in range(0, A, step):
        att = torch.einsum("bqd,avd->baqv", txt_f, vis_f[a0:a0 + step])
        att = att + vb[None, a0:a0 + step, None, :] + tb[:, None, :, None]
        outs.append((att.amax(-1), att.argmax(-1).int(),
                     att.amax(-2), att.argmax(-2).int()))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("match_fwd")
        lib.match_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.match_fwd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def match_maxes_cuda(vis, txt, vis_bias, txt_bias):
    """Launch K5. Same outputs as :func:`match_maxes_plain`."""
    global n_launches
    A, V, D = vis.shape
    B, Q, D2 = txt.shape
    tensors = (vis, txt, vis_bias, txt_bias)
    if not all(t.is_cuda and t.device == vis.device for t in tensors):
        raise RuntimeError("match_maxes_cuda takes CUDA tensors on one device")
    if vis.dtype != torch.bfloat16 or txt.dtype != torch.bfloat16:
        raise TypeError(f"match operands must be bf16, got {vis.dtype}/{txt.dtype}")
    if vis_bias.dtype != torch.float32 or txt_bias.dtype != torch.float32:
        raise TypeError("match biases must be f32")
    if D != D2 or tuple(vis_bias.shape) != (A, V) or tuple(txt_bias.shape) != (B, Q):
        raise ValueError(
            f"match shapes: vis {tuple(vis.shape)} txt {tuple(txt.shape)} "
            f"vis_bias {tuple(vis_bias.shape)} txt_bias {tuple(txt_bias.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("match_maxes_cuda takes contiguous tensors")
    lib = _library()
    dev = vis.device
    logit = torch.empty((B, A, Q), device=dev, dtype=torch.float32)
    logit_idx = torch.empty((B, A, Q), device=dev, dtype=torch.int32)
    logit_v = torch.empty((B, A, V), device=dev, dtype=torch.float32)
    logit_v_idx = torch.empty((B, A, V), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        err = lib.match_fwd_launch(
            _build.ptr(vis), _build.ptr(txt), _build.ptr(vis_bias),
            _build.ptr(txt_bias), _build.ptr(logit), _build.ptr(logit_idx),
            _build.ptr(logit_v), _build.ptr(logit_v_idx),
            A, V, D, B, Q, _build.stream_ptr(dev))
    _build.check(err, "match_fwd_launch")
    n_launches += 1
    return logit, logit_idx, logit_v, logit_v_idx


def match_maxes(vis, txt, vis_bias, txt_bias):
    """Dispatch: CUDA tensors launch K5 (or raise), CPU tensors take the
    plain version."""
    if vis.is_cuda:
        return match_maxes_cuda(vis, txt, vis_bias, txt_bias)
    if vis.device.type != "cpu":
        raise RuntimeError(f"match_maxes: unsupported device {vis.device}")
    return match_maxes_plain(vis, txt, vis_bias, txt_bias)
