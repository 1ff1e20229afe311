"""Matching maxes: the plain versions and the wrappers of kernels K5
(``csrc/match_fwd.cu``, replacing ``_fwd_kernel`` of
vlgae_tpu/ops/match_pallas.py) and K6 (``csrc/match_bwd.cu``, replacing
``_bwd_kernel``), :class:`MatchMaxesFn`, the autograd function that
joins them, and :func:`match_maxes_sharded`, the data-parallel form
(replacing ``match_maxes_pallas_sharded``): this rank's captions against
every rank's images.

    att[b, a, q, v] = txt[b, q] . vis[a, v] + vis_bias[a, v] + txt_bias[b, q]
    logit[b, a, q]   = max_v att   (int32 index of the first maximal v)
    logit_v[b, a, v] = max_q att   (int32 index of the first maximal q)

Operands are bf16, products and sums f32, biases f32 (the -1e9 visibility
masks). No ``[B, A, Q, V]`` tensor is stored by either kernel. The
backward routes each cotangent to its first winner only (the TPU kernel's
contract); the biases get no gradient.

The two wrappers are ``torch.library.custom_op`` s, ``vlgae::match_maxes``
and ``vlgae::match_maxes_bwd``: the CUDA implementation launches the kernel
(and counts it), the CPU implementation is the plain version, and a fake
implementation gives the outputs' shapes for ``torch.export``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch import Tensor

from ..parallel.mesh import gather_rows
from ..utils import trace
from . import _build

_lib = None
_bwd_lib = None
# elements of one plain-version [B, a-chunk, Q, V] f32 block
_PLAIN_BLOCK = 1 << 26


def reset_launch_counts() -> None:
    """Drop the ``match.*`` launch counters of :mod:`..utils.trace` (back to 0)."""
    trace.reset("match.")


def launch_counts() -> dict:
    """This process's launches, read from the ``match.*`` counters of
    :mod:`..utils.trace`: K5 (``fwd``), K5 by the number of q-chunks it
    took, K6 (``bwd``), and the calls of the sharded wrapper that sent CUDA
    tensors to K5."""
    c = trace.counters()
    prefix = "match.fwd_q_chunks."
    return {"fwd": c.get("match.fwd", 0),
            "fwd_by_q_chunks": {int(k[len(prefix):]): v for k, v in c.items()
                                if k.startswith(prefix)},
            "bwd": c.get("match.bwd", 0), "sharded": c.get("match.sharded", 0)}


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


# K5's tiling (csrc/match_fwd.cu). Both kernels stream image tiles of 64 rows
# (the wgmma's M) by 128 features (8 wgmmas of k = 16) past captions resident
# in shared memory, in q-chunks of 8 * nt words (nt the wgmma's N / 8).
# The TMA kernel: chunks of 120 and 136 words (rows 16-byte aligned, D <=
# 128, V <= 65536: a column's winning row in 16 bits), two consumer
# warpgroups of one caption, a ring of 6 tiles, 4 column candidates a
# warpgroup in its merge buffer. The other kernel (PR 4's design): chunks of
# 40 to 104 words, where it was not beaten, and any chunk of rows the TMA
# kernel does not take (builds up to 120 words), 4 captions a block, a ring
# of 3 tiles.
FWD_V_TILE, FWD_K_CHUNK, FWD_TMA_MAX_V = 64, 128, 65536
FWD_Q_GROUPS, FWD_TMA_Q_GROUPS = (5, 9, 13, 15, 17), (15, 17)
FWD_CAP_TILE, FWD_STAGES, FWD_MERGE_ROWS = 2, 6, 4
FWD_GENERIC_Q_GROUPS, FWD_GENERIC_CAP_TILE, FWD_GENERIC_STAGES = (5, 9, 13, 15), 4, 3
# the C interface's codes of the staging paths
FWD_STAGING = ("scalar", "cp.async", "tma")
H100_SMS = 132


def match_fwd_staging(D: int, vis_ptr: int = 0, txt_ptr: int = 0, V: int = 0,
                      Q: int = 1) -> str:
    """How K5 stages rows: ``"tma"`` (the TMA kernel) when D <= 128, V <=
    65536, both operands' rows are 16-byte aligned and the words go in
    chunks of 120 or 136 (:func:`match_fwd_q_tiling`); otherwise the other
    kernel, by 16-byte ``"cp.async"`` on aligned rows, else ``"scalar"``
    2-byte loads."""
    aligned = D % 8 == 0 and vis_ptr % 16 == 0 and txt_ptr % 16 == 0
    if (aligned and D <= FWD_K_CHUNK and V <= FWD_TMA_MAX_V
            and match_fwd_q_tiling(Q)[1] in FWD_TMA_Q_GROUPS):
        return "tma"
    return "cp.async" if aligned else "scalar"


def match_fwd_builds(staging: str):
    """The q-chunk widths, in 8-word groups, that path's kernel is built for."""
    return FWD_TMA_Q_GROUPS if staging == "tma" else FWD_GENERIC_Q_GROUPS


def match_fwd_cap_tile(nt: int, staging: str = "tma") -> int:
    """Captions one K5 block serves: two (one a consumer warpgroup) on the
    TMA kernel, four on the other."""
    return FWD_CAP_TILE if staging == "tma" else FWD_GENERIC_CAP_TILE


def match_fwd_groups(A: int, B: int, sm_count: int, cap_tile: int) -> int:
    """Image groups of K5's grid. A work item is (a tile of ``cap_tile``
    captions, an image); a block takes one caption tile (its rows stay
    resident) and every ``groups``-th image, so that ``groups * ceil(B /
    cap_tile)`` blocks are as many as fit one a multiprocessor (never more
    than one block per image), and a block's images differ from another's
    by at most one."""
    return max(1, min(A, sm_count // max(1, -(-B // cap_tile))))


def match_fwd_q_tiling(Q: int, builds=FWD_Q_GROUPS):
    """``(q_chunks, nt)``: the words of a caption go through K5 in
    ``q_chunks`` chunks of ``8 * nt`` words, each a pass over the images. The
    fewest chunks of at most the widest build (136 words; 120 on the other
    kernel's builds), of equal width, in the narrowest build that holds
    them. Captions are padded to multiples of 8 words and Q = 2 * (length +
    1): Q = 34 is one chunk of 40, Q = 98 and 102 one of 104, Q = 114 (56
    words, exp=vlgae's longest) one of 120, Q = 130 (64 words,
    exp=vlgae_vit's) one of 136, Q = 202 two of 104."""
    groups8 = max(1, -(-Q // 8))
    per_chunk = -(-groups8 // -(-groups8 // builds[-1]))
    nt = next(n for n in builds if n >= per_chunk)
    return -(-groups8 // nt), nt


def match_fwd_smem_bytes(nt: int, staging: str = "tma") -> int:
    """Dynamic shared memory of a K5 block with q-chunks of ``8 * nt``
    words. TMA kernel: the ring of image tiles and of their image biases,
    the resident captions, their word biases, the merge buffer of the column
    maxes (4 candidates a word and warpgroup), a full and an empty barrier a
    stage, and room to start the swizzled tiles on a 1024-byte boundary. The
    other kernel: the
    captions, its ring, both biases (the tiles' in a ring one deeper), 16
    candidates a word and warpgroup, the same room."""
    row, chunk = 2 * FWD_K_CHUNK, 8 * nt
    if staging == "tma":
        return (FWD_STAGES * FWD_V_TILE * (row + 4) + FWD_CAP_TILE * chunk * (row + 4)
                + FWD_CAP_TILE * FWD_MERGE_ROWS * chunk * 8 + 2 * FWD_STAGES * 8 + 1024)
    return (FWD_GENERIC_CAP_TILE * chunk * row + FWD_GENERIC_STAGES * FWD_V_TILE * row
            + FWD_GENERIC_CAP_TILE * chunk * 4 + (FWD_GENERIC_STAGES + 1) * FWD_V_TILE * 4
            + 2 * 16 * chunk * 8 + 1024)


def match_fwd_plan(A, V, B, Q, D, vis_ptr=0, txt_ptr=0, sm_count=H100_SMS):
    """What one launch of K5 does at these shapes, from the shapes, the
    operands' addresses and the card's multiprocessor count alone: the
    kernel and how it stages rows (:func:`match_fwd_staging`), the grid
    (``groups`` x tiles of ``cap_tile`` captions, whose rows are the
    resident side), the work items (caption tile, image) it walks, the
    q-chunks (how many, of how many words), the streamed image tiles and
    k-chunks a block walks per image, the dynamic shared memory of a block
    and the bytes all blocks copy from L2."""
    staging = match_fwd_staging(D, vis_ptr, txt_ptr, V, Q)
    q_chunks, nt = match_fwd_q_tiling(Q, match_fwd_builds(staging))
    cap_tile = match_fwd_cap_tile(nt, staging)
    cap_tiles = -(-B // cap_tile)
    groups = match_fwd_groups(A, B, sm_count, cap_tile)
    v_tiles = -(-V // FWD_V_TILE)
    k_chunks = -(-D // FWD_K_CHUNK)
    # every block streams its images once per q-chunk and stages its captions
    # once a q-chunk; when D takes k-chunks both are staged again for every
    # (image tile, caption of a warpgroup)
    if k_chunks == 1:
        l2_bytes = 2 * D * cap_tiles * (q_chunks * A * V + groups * cap_tile * Q)
    else:
        l2_bytes = 2 * D * cap_tiles * 2 * A * (q_chunks * V + v_tiles * cap_tile * Q)
    return {"kernel": "tma" if staging == "tma" else "generic", "staging": staging,
            "grid": (groups, cap_tiles), "cap_tile": cap_tile, "resident": "captions",
            "work_items": cap_tiles * A, "q_chunks": q_chunks, "q_chunk_words": 8 * nt,
            "v_tiles": v_tiles, "k_chunks": k_chunks,
            "smem_bytes": match_fwd_smem_bytes(nt, staging), "l2_to_smem_bytes": l2_bytes}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("match_fwd")
        lib.match_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.match_fwd_launch.restype = ctypes.c_int
        for name in ("match_fwd_smem_bytes", "match_fwd_cap_tile"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        for staging in ("tma", "cp.async"):
            code = FWD_STAGING.index(staging)
            for nt in match_fwd_builds(staging):
                got = (lib.match_fwd_smem_bytes(nt, code), lib.match_fwd_cap_tile(nt, code))
                want = (match_fwd_smem_bytes(nt, staging), match_fwd_cap_tile(nt, staging))
                if got != want:
                    raise RuntimeError(
                        f"match_fwd.cu keeps (shared bytes, captions a block) {got} at "
                        f"nt = {nt} ({staging}), ops/match.py says {want}")
        _lib = lib
    return _lib


def match_maxes_cuda(vis, txt, vis_bias, txt_bias):
    """Launch K5. Same outputs as :func:`match_maxes_plain`."""
    A, V, D = vis.shape
    B, Q, D2 = txt.shape
    tensors = (vis, txt, vis_bias, txt_bias)
    if not all(t.is_cuda and t.device == vis.device for t in tensors):
        raise RuntimeError("match_maxes_cuda takes CUDA tensors on one device")
    if vis.dtype != torch.bfloat16 or txt.dtype != torch.bfloat16:
        raise TypeError(f"match operands must be bf16, got {vis.dtype}/{txt.dtype}")
    if vis_bias.dtype != torch.float32 or txt_bias.dtype != torch.float32:
        raise TypeError("match biases must be f32")
    if (D != D2 or D < 1 or tuple(vis_bias.shape) != (A, V)
            or tuple(txt_bias.shape) != (B, Q)):
        raise ValueError(
            f"match shapes: vis {tuple(vis.shape)} txt {tuple(txt.shape)} "
            f"vis_bias {tuple(vis_bias.shape)} txt_bias {tuple(txt_bias.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("match_maxes_cuda takes contiguous tensors")
    lib = _library()
    dev = vis.device
    plan = match_fwd_plan(A, V, B, Q, D, vis.data_ptr(), txt.data_ptr(),
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    logit = torch.empty((B, A, Q), device=dev, dtype=torch.float32)
    logit_idx = torch.empty((B, A, Q), device=dev, dtype=torch.int32)
    logit_v = torch.empty((B, A, V), device=dev, dtype=torch.float32)
    logit_v_idx = torch.empty((B, A, V), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        err = lib.match_fwd_launch(
            _build.ptr(vis), _build.ptr(txt), _build.ptr(vis_bias),
            _build.ptr(txt_bias), _build.ptr(logit), _build.ptr(logit_idx),
            _build.ptr(logit_v), _build.ptr(logit_v_idx),
            A, V, D, B, Q, plan["grid"][0], plan["q_chunk_words"] // 8,
            FWD_STAGING.index(plan["staging"]), _build.stream_ptr(dev))
    _build.check(err, "match_fwd_launch")
    trace.count("match.fwd")
    trace.count(f"match.fwd_q_chunks.{plan['q_chunks']}")
    return logit, logit_idx, logit_v, logit_v_idx


@torch.library.custom_op("vlgae::match_maxes", mutates_args=(), device_types="cuda")
def _match_maxes_op(vis: Tensor, txt: Tensor, vis_bias: Tensor,
                    txt_bias: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    return match_maxes_cuda(vis, txt, vis_bias, txt_bias)


@_match_maxes_op.register_kernel("cpu")
def _match_maxes_cpu(vis, txt, vis_bias, txt_bias):
    return match_maxes_plain(vis, txt, vis_bias, txt_bias)


@_match_maxes_op.register_fake
def _match_maxes_fake(vis, txt, vis_bias, txt_bias):
    A, V = vis.shape[:2]
    B, Q = txt.shape[:2]
    return (vis.new_empty((B, A, Q), dtype=torch.float32),
            vis.new_empty((B, A, Q), dtype=torch.int32),
            vis.new_empty((B, A, V), dtype=torch.float32),
            vis.new_empty((B, A, V), dtype=torch.int32))


def _on_card_or_cpu(t, what):
    if t.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{what}: unsupported device {t.device}")


def match_maxes(vis, txt, vis_bias, txt_bias):
    """``vlgae::match_maxes``: CUDA tensors launch K5 (or raise), CPU tensors
    take the plain version."""
    _on_card_or_cpu(vis, "match_maxes")
    return _match_maxes_op(vis, txt, vis_bias, txt_bias)


def match_maxes_bwd_plain(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    """``(dvis [A,V,D], dtxt [B,Q,D])`` in plain PyTorch, in the dtypes of
    ``vis``/``txt``: the cell weight ``bf16(dlogit·[logit_idx==v] +
    dlogit_v·[logit_v_idx==q])`` (rounded after the sum), f32 products,
    chunked over images."""
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    vis_f, txt_f = vis.float(), txt.float()
    dm, dmv = dlogit.float(), dlogit_v.float()
    li, lvi = logit_idx.long(), logit_v_idx.long()
    step = max(1, _PLAIN_BLOCK // max(1, B * Q * V))
    dvis = []
    dtxt = torch.zeros(B, Q, D, dtype=torch.float32, device=txt.device)
    for a0 in range(0, A, step):
        sl = slice(a0, a0 + step)
        n = min(step, A - a0)
        w = torch.zeros(B, n, Q, V, dtype=torch.float32, device=vis.device)
        w.scatter_(3, li[:, sl, :, None], dm[:, sl, :, None])
        wq = torch.zeros_like(w)
        wq.scatter_(2, lvi[:, sl, None, :], dmv[:, sl, None, :])
        w = (w + wq).to(torch.bfloat16).float()
        dvis.append(torch.einsum("baqv,bqd->avd", w, txt_f))
        dtxt += torch.einsum("baqv,avd->bqd", w, vis_f[sl])
    return torch.cat(dvis).to(vis.dtype), dtxt.to(txt.dtype)


# K6 (csrc/match_bwd.cu): positions per segment of a warp of the rows pass;
# the largest feature width; warps of a build block (a block per group) and
# the shared memory they may take (a [warps, N+1] table of int counts and a
# row of N+1)
BWD_SEGMENT = 512
BWD_MAX_D = 384
BWD_BUILD_WARPS = 32
BWD_BUILD_SMEM = 96 * 1024


def _bwd_build_warps(n_rows: int) -> int:
    """Warps of a K6 build block whose groups have ``n_rows`` owner rows:
    each warp counts into its own row of ``n_rows + 1`` ints."""
    fit = BWD_BUILD_SMEM // (4 * (n_rows + 1)) - 1
    if fit < 1:
        raise ValueError(f"match_maxes_bwd_cuda takes V, Q <= "
                         f"{BWD_BUILD_SMEM // 8 - 1}, got {n_rows}")
    return min(BWD_BUILD_WARPS, fit)


def match_bwd_plan(A, V, B, Q, D, vis_ptr=0, txt_ptr=0):
    """What one call of K6 allocates and launches, from the shapes and the
    operands' addresses alone. Each direction (dvis: owner rows (a, v),
    partners (b, q); dtxt: owner rows (b, q), partners (a, v)) has
    ``A*B*(V+Q)`` positions: every owner row's O own partners (one a caption
    or image), then its cross partners from the winner lists, cut into
    segments of ``BWD_SEGMENT`` positions (a warp of the rows pass each).
    ``"layout"`` is the one int32 scratch buffer, in order: the lists of
    dvis ``[A, B*Q]`` and of dtxt ``[B, A*V]``, their row starts
    (``A*(V+1)+1`` and ``B*(Q+1)+1``) and one mark a segment; the f32
    workspace holds two partial rows of D a segment. Features go 8 bytes a
    lane (``"vec4"``) when rows are 8-byte aligned, else 2 bytes
    (``"scalar"``)."""
    if D < 1 or D > BWD_MAX_D:
        raise ValueError(f"match_maxes_bwd_cuda takes D <= {BWD_MAX_D}, got {D}")
    segment = BWD_SEGMENT
    positions = A * B * (V + Q)
    if positions >= 2 ** 31 - segment:
        raise ValueError(f"match_maxes_bwd_cuda: {positions} positions overflow int32")
    per = -(-positions // segment)
    warps = (_bwd_build_warps(V), _bwd_build_warps(Q))
    layout = {"list_vis": (A, B * Q), "list_txt": (B, A * V),
              "starts_vis": (A * (V + 1) + 1,), "starts_txt": (B * (Q + 1) + 1,),
              "marks": (2 * per,)}
    ints = sum(math.prod(shape) for shape in layout.values())
    work = 2 * (2 * per) * D
    aligned = D % 4 == 0 and vis_ptr % 8 == 0 and txt_ptr % 8 == 0
    return {"positions": positions, "segment": segment, "segments": 2 * per,
            "layout": layout, "ints": ints,
            "workspace_floats": work, "bytes": 4 * (ints + work),
            "features": "vec4" if aligned else "scalar",
            "build_warps": warps,
            "build_smem": 4 * max((w + 1) * (n + 1) for w, n in zip(warps, (V, Q)))}


def match_bwd_lists_plain(logit_idx, logit_v_idx):
    """K6's winner lists and row starts in plain PyTorch (a stable argsort by
    owner row), named and shaped as in :func:`match_bwd_plan`'s layout
    (``list_vis``, ``starts_vis``, ``list_txt``, ``starts_txt``). A list
    holds, per group (image a for dvis, caption b for dtxt), its partner
    cells o*M + m (dvis: b*Q + q, dtxt: a*V + v) grouped by the owner row
    their winner names (keys outside the rows last), in ascending order
    within a row. The starts are positions: row (g, n) begins after the O
    own positions of every earlier row and the cross entries before it; the
    last entry is A*B*(V+Q)."""
    B, A, Q = logit_idx.shape
    V = logit_v_idx.shape[2]

    def one(keys, N, O):
        G, cells = keys.shape
        keys = keys.long()
        keys = torch.where((keys >= 0) & (keys < N), keys, N)
        order = torch.argsort(keys, dim=1, stable=True).int()
        counts = torch.zeros(G, N + 1, dtype=torch.long, device=keys.device)
        counts.scatter_add_(1, keys, torch.ones_like(keys))
        before = counts.cumsum(1) - counts
        g = torch.arange(G, device=keys.device)[:, None]
        n = torch.arange(N + 1, device=keys.device)
        starts = (g * N + n) * O + g * cells + before
        end = torch.tensor([G * O * (N + cells // O)], device=keys.device)
        return order, torch.cat([starts.flatten(), end]).int()

    lists = {}
    for side, keys, N, O in (("vis", logit_idx.permute(1, 0, 2).reshape(A, B * Q), V, B),
                             ("txt", logit_v_idx.reshape(B, A * V), Q, A)):
        lists["list_" + side], lists["starts_" + side] = one(keys, N, O)
    return lists


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("match_bwd")
        lib.match_bwd_launch.argtypes = [ctypes.c_void_p] * 14 + [
            ctypes.c_int] * 12 + [ctypes.c_void_p]
        lib.match_bwd_launch.restype = ctypes.c_int
        lib.match_bwd_max_d.restype = ctypes.c_int
        if lib.match_bwd_max_d() != BWD_MAX_D:
            raise RuntimeError(f"match_bwd.cu takes D <= {lib.match_bwd_max_d()}, "
                               f"BWD_MAX_D says {BWD_MAX_D}")
        _bwd_lib = lib
    return _bwd_lib


def _check_bwd_args(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    A, V, D = vis.shape
    B, Q, D2 = txt.shape
    tensors = (vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)
    if not all(t.is_cuda and t.device == vis.device for t in tensors):
        raise RuntimeError("match_maxes_bwd_cuda takes CUDA tensors on one device")
    if vis.dtype != torch.bfloat16 or txt.dtype != torch.bfloat16:
        raise TypeError(f"match operands must be bf16, got {vis.dtype}/{txt.dtype}")
    if logit_idx.dtype != torch.int32 or logit_v_idx.dtype != torch.int32:
        raise TypeError("match winner indices must be int32")
    if dlogit.dtype != torch.float32 or dlogit_v.dtype != torch.float32:
        raise TypeError("match cotangents must be f32")
    if (D != D2 or tuple(logit_idx.shape) != (B, A, Q)
            or tuple(dlogit.shape) != (B, A, Q)
            or tuple(logit_v_idx.shape) != (B, A, V)
            or tuple(dlogit_v.shape) != (B, A, V)):
        raise ValueError(
            f"match bwd shapes: vis {tuple(vis.shape)} txt {tuple(txt.shape)} "
            f"idx {tuple(logit_idx.shape)} vidx {tuple(logit_v_idx.shape)} "
            f"dlogit {tuple(dlogit.shape)} dlogit_v {tuple(dlogit_v.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("match_maxes_bwd_cuda takes contiguous tensors")
    return match_bwd_plan(A, V, B, Q, D, vis.data_ptr(), txt.data_ptr())


def match_bwd_launch(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    """Launch K6 (three CUDA kernels, one count): ``(dvis, dtxt, scratch)``,
    ``scratch`` the views of the int32 buffer named in
    :func:`match_bwd_plan`'s layout, as this call left them."""
    plan = _check_bwd_args(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    lib = _bwd_library()
    # every output row is written unless a dimension is 0 (nothing to sum)
    empty = torch.zeros_like if 0 in (A, V, B, Q) else torch.empty_like
    dvis, dtxt = empty(vis), empty(txt)
    ints = torch.empty(plan["ints"], dtype=torch.int32, device=vis.device)
    work = torch.empty(plan["workspace_floats"], dtype=torch.float32, device=vis.device)
    layout = plan["layout"]
    parts = torch.split(ints, [math.prod(shape) for shape in layout.values()])
    scratch = {name: part.view(shape) for (name, shape), part in zip(layout.items(), parts)}
    with torch.cuda.device(vis.device):
        err = lib.match_bwd_launch(
            *(_build.ptr(t) for t in (vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v,
                                      dvis, dtxt, *scratch.values(), work)),
            A, V, D, B, Q, plan["positions"], plan["segment"], plan["segments"] // 2,
            int(plan["features"] == "vec4"), *plan["build_warps"], plan["build_smem"],
            _build.stream_ptr(vis.device))
    _build.check(err, "match_bwd_launch")
    trace.count("match.bwd")
    return dvis, dtxt, scratch


def match_maxes_bwd_cuda(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    """Launch K6. Same outputs as :func:`match_maxes_bwd_plain`."""
    return match_bwd_launch(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)[:2]


@torch.library.custom_op("vlgae::match_maxes_bwd", mutates_args=(), device_types="cuda")
def _match_maxes_bwd_op(vis: Tensor, txt: Tensor, logit_idx: Tensor, logit_v_idx: Tensor,
                        dlogit: Tensor, dlogit_v: Tensor) -> Tuple[Tensor, Tensor]:
    return match_maxes_bwd_cuda(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)


@_match_maxes_bwd_op.register_kernel("cpu")
def _match_maxes_bwd_cpu(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    return match_maxes_bwd_plain(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)


@_match_maxes_bwd_op.register_fake
def _match_maxes_bwd_fake(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    return torch.empty_like(vis), torch.empty_like(txt)


def match_maxes_bwd(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v):
    """``vlgae::match_maxes_bwd``: CUDA tensors launch K6 (or raise), CPU
    tensors take the plain version."""
    _on_card_or_cpu(vis, "match_maxes_bwd")
    return _match_maxes_bwd_op(vis, txt, logit_idx, logit_v_idx, dlogit, dlogit_v)


class MatchMaxesFn(torch.autograd.Function):
    """``(logit, logit_idx, logit_v, logit_v_idx)`` of :func:`match_maxes`
    with the argmax-routed backward of :func:`match_maxes_bwd` (K5 forward,
    K6 backward on the card; the two ops). The indices are not
    differentiable; the biases (visibility masks) get no gradient."""

    @staticmethod
    def forward(ctx, vis, txt, vis_bias, txt_bias):
        logit, logit_idx, logit_v, logit_v_idx = match_maxes(
            vis, txt, vis_bias, txt_bias)
        ctx.save_for_backward(vis, txt, logit_idx, logit_v_idx)
        ctx.mark_non_differentiable(logit_idx, logit_v_idx)
        return logit, logit_idx, logit_v, logit_v_idx

    @staticmethod
    def backward(ctx, dlogit, _didx, dlogit_v, _dvidx):
        vis, txt, logit_idx, logit_v_idx = ctx.saved_tensors
        if dlogit is None:
            dlogit = torch.zeros(logit_idx.shape, dtype=torch.float32,
                                 device=vis.device)
        if dlogit_v is None:
            dlogit_v = torch.zeros(logit_v_idx.shape, dtype=torch.float32,
                                   device=vis.device)
        dvis, dtxt = match_maxes_bwd(
            vis, txt, logit_idx, logit_v_idx,
            dlogit.float().contiguous(), dlogit_v.float().contiguous())
        return dvis, dtxt, None, None


def match_maxes_sharded(vis, txt, vis_bias, txt_bias, dp):
    """:class:`MatchMaxesFn` over a data group: ``vis [A_local, V, D]``
    (bf16) and its bias ``[A_local, V]`` (f32) are this rank's images and
    ``txt [B_local, Q, D]``, ``txt_bias`` its captions; every rank passes
    the same numbers of each (its rows of a batch that split evenly, as
    ``parallel.shard_batch`` gives them). The images are all-gathered (one
    gather a call; its backward reduce-scatters ``dvis`` in bf16, as JAX
    transposes a bf16 all-gather) and K5 / K6 run at (all images, local
    captions): outputs ``[B_local, A, Q]`` and ``[B_local, A, V]``. At world
    1, or without a group (``dp`` None), it is :class:`MatchMaxesFn`
    itself. CPU tensors take the plain versions under the same wrapper."""
    if dp is not None and dp.sharded:
        vis, vis_bias = gather_rows(vis, dp), gather_rows(vis_bias.detach(), dp)
    out = MatchMaxesFn.apply(vis, txt, vis_bias, txt_bias)
    if vis.is_cuda:
        trace.count("match.sharded")
    return out
