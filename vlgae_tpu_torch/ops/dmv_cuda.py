"""Wrapper of the fused DMV kernel K1 (``csrc/dmv_fused.cu``).

Replaces the TPU launch of ``_fused_kernel`` (vlgae_tpu/ops/dmv_pallas.py,
reached from ``_make_dmv_total._fwd``): one launch returns the per-sentence
total and both gradient tables (marginals or Viterbi indicators). The
plain version is :func:`vlgae_tpu_torch.struct.dmv.dmv_value_and_grads_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the kernel in this process (chip_smoke resets and reads it)
n_launches = 0

_SMEM_PER_N1SQ = 72  # bytes of charts per sentence / n1^2 (see the .cu)
_lib = None
_smem_optin = None


def _library():
    global _lib, _smem_optin
    if _lib is None:
        lib = _build.load("dmv_fused")
        lib.dmv_fused_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.dmv_fused_launch.restype = ctypes.c_int
        lib.dmv_fused_smem_optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dmv_fused_smem_optin.restype = ctypes.c_int
        got = ctypes.c_int(0)
        _build.check(lib.dmv_fused_smem_optin(ctypes.byref(got)),
                     "dmv_fused_smem_optin")
        _lib, _smem_optin = lib, got.value
    return _lib


def dmv_fused(dec, attach, lengths, kind: str = "log"):
    """``(total [B], g_dec [B,N1,2,2,2], g_attach [B,N1,N1,2])`` on the card.

    ``dec``/``attach`` are f32 CUDA tensors; ``lengths`` (int) is moved to
    the card as int32. Lengths are clamped to ``[0, N1-1]`` in the kernel.
    """
    global n_launches
    if kind not in ("log", "max"):
        raise ValueError(f"kind must be 'log' or 'max', got {kind!r}")
    if not (dec.is_cuda and attach.is_cuda):
        raise RuntimeError("dmv_fused takes CUDA tensors")
    if dec.dtype != torch.float32 or attach.dtype != torch.float32:
        raise TypeError(f"dmv_fused takes f32, got {dec.dtype}/{attach.dtype}")
    B, n1 = dec.shape[:2]
    if tuple(dec.shape) != (B, n1, 2, 2, 2) or tuple(attach.shape) != (
            B, n1, n1, 2) or attach.device != dec.device:
        raise ValueError(
            f"dmv_fused: bad shapes dec {tuple(dec.shape)} attach "
            f"{tuple(attach.shape)}")
    dec = dec.contiguous()
    attach = attach.contiguous()
    lengths = lengths.to(device=dec.device, dtype=torch.int32).contiguous()
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"dmv_fused: lengths shape {tuple(lengths.shape)}")
    lib = _library()
    out = torch.empty(B, device=dec.device, dtype=torch.float32)
    g_dec = torch.empty_like(dec)
    g_attach = torch.empty_like(attach)
    need = _SMEM_PER_N1SQ * n1 * n1
    use_smem = need <= _smem_optin
    scratch = None if use_smem else torch.empty(
        B * need, device=dec.device, dtype=torch.uint8)
    if B == 0:
        return out, g_dec, g_attach
    with torch.cuda.device(dec.device):
        err = lib.dmv_fused_launch(
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lengths),
            _build.ptr(out), _build.ptr(g_dec), _build.ptr(g_attach),
            None if scratch is None else _build.ptr(scratch),
            B, n1, int(kind == "max"), int(use_smem),
            _build.stream_ptr(dec.device))
    _build.check(err, "dmv_fused_launch")
    n_launches += 1
    return out, g_dec, g_attach
