"""Wrappers of the DMV chart kernels (``csrc/dmv_fused.cu``,
``csrc/dmv_inside.cu``, ``csrc/dmv_outside.cu``).

They replace the TPU launches of vlgae_tpu/ops/dmv_pallas.py reached from
``_make_dmv_total``:

* :func:`dmv_fused` (K1, ``_fused_kernel``): one launch returns the
  per-sentence total and both gradient tables for a cotangent of one
  (marginals or Viterbi indicators);
* :func:`dmv_inside` (K2/K4, ``_inside_kernel_v3`` and the older fills):
  the total alone, when no gradient is wanted;
* :func:`dmv_inside_save` + :func:`dmv_outside` (K3/K4, the ``*_save``
  inside kernels and ``_outside_kernel``): the two-launch pair of a
  differentiable total, whose cotangent arrives later.

Every kernel runs the one-barrier fills of ``csrc/dmv_common.cuh`` (the
inside kernel's warp mapping on ``__syncwarp()``, K1's inside pass on a
named barrier of its first threads), with the sentence's potentials staged
in shared memory where they fit beside the charts (always, in the warp
mapping and in K1 with its charts in shared memory). K1 keeps all eight of
its charts in shared memory (``smem``), its four inside charts there and
the four adjoint charts in global scratch (``split``), or all in scratch
(``global``): :func:`fused_mapping`.

Each wrapper is a ``torch.library.custom_op`` (``vlgae::dmv_fused``,
``vlgae::dmv_inside``, ``vlgae::dmv_inside_save``, ``vlgae::dmv_outside``):
its CUDA implementation launches the kernel and counts the launch, its CPU
implementation is the plain version of :mod:`vlgae_tpu_torch.struct.dmv`,
and its fake implementation gives the outputs' shapes and dtypes, so that
``torch.export`` traces a forward that reaches them. What a wrapper decides
before a launch (bytes of shared memory per sentence, charts in shared or
in global memory, potentials staged or not, threads per block) is a pure
function of ``n1`` and the card's opt-in shared memory: :func:`chart_pitch`,
:func:`fused_smem_bytes`, :func:`inside_smem_bytes`, :func:`fused_mapping`,
:func:`inside_mapping`, :func:`outside_smem_bytes`, :func:`outside_mapping`,
:func:`potential_smem_bytes`, :func:`warp_smem_bytes`, :func:`fused_plan`,
:func:`inside_plan`, :func:`outside_plan`,
:func:`block_threads`, :func:`inside_threads` (K1),
:func:`inside_block_threads`, :func:`outside_threads` (the pair).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from ..struct import dmv as _plain
from ..utils import trace
from . import _build

MAPPINGS = ("warp", "smem", "global")

# bytes of one chart cell pair times the charts a kernel keeps per sentence
# (see the .cu): eight for K1 and for the outside kernel (the inside charts
# and four adjoint charts), four for the inside alone; K1 keeps in shared
# memory the charts of FUSED_SMEM_CHARTS by mapping and the rest in global
# scratch, the outside kernel the four adjoint charts
_CELL_PAIR_BYTES = 8  # one cell of a chart, both valences (f32)
FUSED_SMEM_CHARTS = {"smem": 8, "split": 4, "global": 0}
INSIDE_BYTES_PER_N1SQ = 32
OUTSIDE_BYTES_PER_CELL = 64
OUTSIDE_SCRATCH_PER_N1SQ = 32
WARP_MAX_N1 = 9  # the warp mapping of dmv_inside.cu serves n1 <= 9
WARP_SENTENCES_PER_BLOCK = 1  # its warps (sentences) a block: see inside_plan
MAX_THREADS = 1024  # csrc kMaxThreads
FUSED_SMEM_MAX_THREADS = 512  # K1 with charts in shared memory: kMaxSmemThreads
_lib = None
_smem_optin = None
_inside_lib = None
_outside_lib = None


def reset_launch_counts() -> None:
    """Drop the ``dmv.*`` launch counters of :mod:`..utils.trace` (back to 0)."""
    trace.reset("dmv.")


def launch_counts() -> dict:
    """This process's launches, read from the ``dmv.*`` counters of
    :mod:`..utils.trace`: K1 (``fused``), those of it with all charts in
    global scratch and those with its adjoint charts alone there; the inside
    pass, value-only and chart-saving, by mapping; the outside pass, and
    those of it with charts in global memory."""
    c = trace.counters()
    return {"fused": c.get("dmv.fused", 0), "fused_global": c.get("dmv.fused_global", 0),
            "fused_split": c.get("dmv.fused_split", 0),
            "inside": {m: c.get(f"dmv.inside.{m}", 0) for m in MAPPINGS},
            "inside_save": {m: c.get(f"dmv.inside_save.{m}", 0) for m in MAPPINGS},
            "outside": c.get("dmv.outside", 0),
            "outside_global": c.get("dmv.outside_global", 0)}


def chart_pitch(n1: int) -> int:
    """Positions per chart row in shared memory (``smem_pitch`` of
    ``csrc/dmv_common.cuh``): odd, so that the lanes of one cell, which read
    cells a row apart, hit different banks. Global charts keep ``n1``."""
    return n1 | 1


def fused_smem_bytes(n1: int, charts: int = 8) -> int:
    """Shared memory per sentence of K1 with ``charts`` of its eight float
    charts of ``[n1][pitch][2]`` in shared memory (8, or 4: the inside
    charts) beside the staged potentials: 231,168 bytes at n1 = 56 with
    eight, 171,080 at n1 = 65 with four."""
    return _CELL_PAIR_BYTES * charts * n1 * chart_pitch(n1) + potential_smem_bytes(n1)


def inside_smem_bytes(n1: int) -> int:
    """Shared memory per sentence of the inside kernel: four charts."""
    return INSIDE_BYTES_PER_N1SQ * n1 * chart_pitch(n1)


def fused_mapping(n1: int, smem_optin: int) -> str:
    """Where K1 keeps its charts, from ``n1`` and the card's opt-in shared
    memory alone: ``smem`` while all eight fit in shared memory beside the
    potentials (n1 <= 56 on an H100), ``split`` while the four inside
    charts do, the four adjoint charts then in global scratch (57 <= n1 <=
    75), else ``global`` (all eight in scratch)."""
    for mapping in ("smem", "split"):
        if fused_smem_bytes(n1, FUSED_SMEM_CHARTS[mapping]) <= smem_optin:
            return mapping
    return "global"


def outside_smem_bytes(n1: int) -> int:
    """Shared memory per sentence of the outside kernel's charts: the four
    saved inside charts and four adjoint charts of ``[n1][pitch][2]``."""
    return OUTSIDE_BYTES_PER_CELL * n1 * chart_pitch(n1)


def potential_smem_bytes(n1: int) -> int:
    """Shared memory of one sentence's potentials, staged beside the charts
    of the inside and the outside kernel: attach ``[n1][n1][2]`` and dec
    ``[n1][8]`` f32."""
    return 8 * n1 * n1 + 32 * n1


def warp_smem_bytes(n1: int) -> int:
    """Shared memory of one sentence in the inside kernel's warp mapping:
    its four charts and its staged potentials (``warp_slice_floats`` of
    ``csrc/dmv_inside.cu``; 3,528 bytes at n1 = 9)."""
    return inside_smem_bytes(n1) + potential_smem_bytes(n1)


def outside_mapping(n1: int, smem_optin: int) -> str:
    """Where the outside kernel keeps its charts: ``smem`` while its eight
    charts fit the card's opt-in shared memory, else ``global`` (the inside
    charts read in place, four adjoint charts in global scratch)."""
    return "smem" if outside_smem_bytes(n1) <= smem_optin else "global"


def _plan(chart_bytes: int, n1: int, smem_optin: int) -> Tuple[bool, int]:
    """``(stage, smem bytes)``: the potentials are staged when they fit
    beside the charts the block keeps in shared memory."""
    stage = chart_bytes + potential_smem_bytes(n1) <= smem_optin
    return stage, chart_bytes + (potential_smem_bytes(n1) if stage else 0)


def inside_plan(n1: int, smem_optin: int) -> dict:
    """What the inside kernel's wrapper launches for charts of ``n1``
    positions: ``mapping`` (:func:`inside_mapping`), ``stage`` (the block
    mappings copy the potentials into shared memory where they fit beside
    the charts: n1 <= 75 with charts in shared memory on an H100; the warp
    mapping always does), the dynamic shared memory of a block, and its
    threads.

    The warp mapping runs ``WARP_SENTENCES_PER_BLOCK`` sentences (warps) a
    block, each on its own slice of :func:`warp_smem_bytes`; no block needs
    more than the 48 KB every card gives without an opt-in (14,112 bytes
    at four sentences and n1 = 9). One, two and four sentences a block ran
    within 1% of each other on an H100 at n1 = 5 and 9, B = 16 to 512
    (scripts/tune_torch_dmv_threads.py): each warp runs its own chain of
    width steps and no block-wide barrier ties warps together. One a block
    is the rule: the fewest resources a block, so blocks spread over the
    most SMs."""
    mapping = inside_mapping(n1, smem_optin)
    if mapping == "warp":
        return {"mapping": mapping, "stage": True,
                "smem_bytes": WARP_SENTENCES_PER_BLOCK * warp_smem_bytes(n1),
                "threads": 32 * WARP_SENTENCES_PER_BLOCK}
    charts = inside_smem_bytes(n1) if mapping == "smem" else 0
    stage, smem = _plan(charts, n1, smem_optin)
    return {"mapping": mapping, "stage": stage, "smem_bytes": smem,
            "threads": inside_block_threads(n1, smem_optin)}


def fused_plan(n1: int, smem_optin: int) -> dict:
    """What K1's wrapper launches for charts of ``n1`` positions:
    ``mapping`` (:func:`fused_mapping`), ``stage`` (the potentials in shared
    memory: always with ``smem`` and ``split``, and with ``global`` while
    they fit), the dynamic shared memory of a block, the global scratch of
    a sentence (the charts not in shared memory), its threads
    (:func:`block_threads`) and those of them that run the inside pass
    (:func:`inside_threads`)."""
    mapping = fused_mapping(n1, smem_optin)
    charts = FUSED_SMEM_CHARTS[mapping]
    if charts:
        stage, smem = True, fused_smem_bytes(n1, charts)
    else:
        stage, smem = _plan(0, n1, smem_optin)
    return {"mapping": mapping, "stage": stage, "smem_bytes": smem,
            "scratch_bytes": _CELL_PAIR_BYTES * (8 - charts) * n1 * n1,
            "threads": block_threads(n1, smem_optin),
            "inside_threads": inside_threads(n1, smem_optin)}


def outside_plan(n1: int, smem_optin: int) -> dict:
    """What the outside kernel's wrapper launches: ``mapping``
    (:func:`outside_mapping`), ``stage`` (the potentials, and the gradient
    of ``attach`` in their place, in shared memory: n1 <= 56 with charts in
    shared memory on an H100, and with charts in global memory while the
    potentials fit), the dynamic shared memory of a block, and its
    threads."""
    mapping = outside_mapping(n1, smem_optin)
    charts = outside_smem_bytes(n1) if mapping == "smem" else 0
    stage, smem = _plan(charts, n1, smem_optin)
    return {"mapping": mapping, "stage": stage, "smem_bytes": smem,
            "threads": outside_threads(n1, smem_optin)}


def block_threads(n1: int, smem_optin: int) -> int:
    """Threads per block of K1, all of which run its outside pass (the
    one-barrier fill: a task a start position, up to ``n1`` tasks a width):
    the power of two at least ``4 * n1`` with all charts in shared memory
    and ``6 * n1`` with the adjoint charts (``split``) or all charts
    (``global``) in global scratch, between one warp and ``MAX_THREADS``
    (``FUSED_SMEM_MAX_THREADS`` with charts in shared memory). On an H100 at
    B = 64 (scripts/tune_torch_dmv_threads.py) that was the best block, or
    within 2% of it, at n1 = 17, 51, 65 and 101 in both semirings while the
    fills reduced one tree after another. With their trees level by level
    other counts run faster in one semiring (512 threads, 256 inside: max
    12% faster at n1 = 51; 256/128: log 8% faster, max 9% slower at n1 =
    65), but a lane count is part of the log sums' order, so the rule
    stays and keeps K1's bits; in ``split`` its 512 threads are within
    0.6-7.8% of the best block at n1 = 57, 65 and 75."""
    mapping = fused_mapping(n1, smem_optin)
    per = 4 if mapping == "smem" else 6
    cap = MAX_THREADS if mapping == "global" else FUSED_SMEM_MAX_THREADS
    return min(cap, max(32, 1 << (per * n1 - 1).bit_length()))


def inside_threads(n1: int, smem_optin: int) -> int:
    """Threads of K1's block (its first ones) that run the inside pass, on
    a named barrier of their own: a quarter of the block, at least one warp.
    The inside pass has fewer terms a task than the outside pass, and more
    lanes a task cost more in shuffles and barrier than they save: on an
    H100 a quarter was the best count, or within 1.3% of it, at n1 = 17,
    51, 65 and 101 in both semirings, and 4-15% faster than the best count
    that runs both passes on the whole block."""
    return max(32, block_threads(n1, smem_optin) // 4)


def inside_block_threads(n1: int, smem_optin: int) -> int:
    """Threads per block of the inside kernel's block mappings (the
    one-barrier fill: a task a start position, up to ``n1`` tasks a width):
    with charts in shared memory the power of two at least ``2 * n1`` (about
    two lanes a task: more lanes cost more in shuffles and barrier than they
    save), with charts in global memory at least ``4 * n1`` (more lanes hide
    more of each read), between one warp and ``MAX_THREADS``."""
    per = 2 if inside_mapping(n1, smem_optin) != "global" else 4
    return min(MAX_THREADS, max(32, 1 << (per * n1 - 1).bit_length()))


def outside_threads(n1: int, smem_optin: int) -> int:
    """Threads per block of the outside kernel (the one-barrier fill: a task
    a start position, each walking the consumers of its two complete spans
    and the wider terms of its two incomplete spans): with charts in shared
    memory the power of two at least ``4 * n1``, in global memory at least
    ``8 * n1``, between one warp and ``MAX_THREADS``."""
    per = 4 if outside_mapping(n1, smem_optin) == "smem" else 8
    return min(MAX_THREADS, max(32, 1 << (per * n1 - 1).bit_length()))


def group_lanes(ntasks: int, nterms: int, threads: int) -> int:
    """Lanes that share one task of a width step (``lanes_per_task`` of
    ``csrc/dmv_common.cuh``, mirrored here for the tests and the notes): the
    largest power of two ``G``, at most a warp, with ``ntasks * G <=
    threads``, and no wider than ``nterms`` needs."""
    G = 1
    while G < 32 and 2 * G * ntasks <= threads and G < nterms:
        G *= 2
    return G


def inside_1b_group_widths(n1: int, threads: int) -> set:
    """Every group width the one-barrier inside fill uses on a sentence of
    ``n1 - 1`` words with ``threads`` threads (a warp in the warp mapping):
    a task per start ``i`` of a width ``w``, ``w`` split points."""
    n = n1
    return {group_lanes(n - w, w, threads) for w in range(1, n)}


def outside_1b_group_widths(n1: int, threads: int) -> set:
    """Every group width the one-barrier outside fill uses on a sentence of
    ``n1 - 1`` words with ``threads`` threads, a task per start ``i`` of a
    width ``w``: log, ``len - w + 1`` terms (the consumers of the complete
    spans, the seed at ``w = len``); max, the larger of ``w`` split points
    and ``len - w + 1`` pulled marks; then the GO sums (a task per head,
    direction and valence over ``n`` arcs)."""
    n, length = n1, n1 - 1
    log = {group_lanes(n - w, length - w + 1, threads) for w in range(0, n)}
    mx = {group_lanes(n - w, max(w, length - w + 1), threads) for w in range(1, n)}
    return log | mx | {group_lanes(4 * n, n, threads)}


def _library():
    global _lib, _smem_optin
    if _lib is None:
        lib = _build.load("dmv_fused")
        lib.dmv_fused_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.dmv_fused_launch.restype = ctypes.c_int
        _lib, _smem_optin = lib, _query_optin(lib.dmv_fused_smem_optin)
    return _lib


def _query_optin(fn) -> int:
    """The most dynamic shared memory a block may opt into, in bytes."""
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    got = ctypes.c_int(0)
    _build.check(fn(ctypes.byref(got)), "smem_optin")
    return got.value


def _checked(what, dec, attach, lengths, kind):
    """Contiguous ``(dec, attach, int32 lengths, B, n1)`` or a raise on what
    the kernels do not take."""
    if kind not in ("log", "max"):
        raise ValueError(f"kind must be 'log' or 'max', got {kind!r}")
    if not (dec.is_cuda and attach.is_cuda):
        raise RuntimeError(f"{what} takes CUDA tensors")
    if dec.dtype != torch.float32 or attach.dtype != torch.float32:
        raise TypeError(f"{what} takes f32, got {dec.dtype}/{attach.dtype}")
    B, n1 = dec.shape[:2]
    if tuple(dec.shape) != (B, n1, 2, 2, 2) or tuple(attach.shape) != (
            B, n1, n1, 2) or attach.device != dec.device:
        raise ValueError(
            f"{what}: bad shapes dec {tuple(dec.shape)} attach "
            f"{tuple(attach.shape)}")
    lengths = lengths.to(device=dec.device, dtype=torch.int32).contiguous()
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{what}: lengths shape {tuple(lengths.shape)}")
    return dec.contiguous(), attach.contiguous(), lengths, B, n1


@torch.library.custom_op("vlgae::dmv_fused", mutates_args=(), device_types="cuda")
def dmv_fused(dec: Tensor, attach: Tensor, lengths: Tensor,
              kind: str = "log") -> Tuple[Tensor, Tensor, Tensor]:
    """``(total [B], g_dec [B,N1,2,2,2], g_attach [B,N1,N1,2])``: K1 on the
    card, :func:`~vlgae_tpu_torch.struct.dmv.dmv_value_and_grads_plain` on
    the CPU.

    ``dec``/``attach`` are f32; ``lengths`` (int) is moved to the card as
    int32. Lengths are clamped to ``[0, N1-1]`` in the kernel.
    """
    dec, attach, lengths, B, n1 = _checked("dmv_fused", dec, attach, lengths, kind)
    lib = _library()
    out = torch.empty(B, device=dec.device, dtype=torch.float32)
    g_dec = torch.empty_like(dec)
    g_attach = torch.empty_like(attach)
    plan = fused_plan(n1, _smem_optin)
    mapping = plan["mapping"]
    scratch = torch.empty(B * plan["scratch_bytes"], device=dec.device,
                          dtype=torch.uint8) if plan["scratch_bytes"] else None
    if B == 0:
        return out, g_dec, g_attach
    with torch.cuda.device(dec.device):
        err = lib.dmv_fused_launch(
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lengths),
            _build.ptr(out), _build.ptr(g_dec), _build.ptr(g_attach),
            None if scratch is None else _build.ptr(scratch),
            B, n1, int(kind == "max"), FUSED_SMEM_CHARTS[mapping], int(plan["stage"]),
            plan["threads"], plan["inside_threads"], _build.stream_ptr(dec.device))
    _build.check(err, f"dmv_fused_launch ({mapping})")
    trace.count("dmv.fused")
    if mapping in ("global", "split"):
        trace.count(f"dmv.fused_{mapping}")
    return out, g_dec, g_attach


def _with_autograd(fn, *args):
    """``fn(*args)`` with autograd dispatch back on: an op's implementation
    runs below it, and the plain versions of K1 and K3b take their tables
    from ``torch.autograd.grad`` of the inside pass."""
    keys = torch._C.DispatchKey
    excluded = torch._C._dispatch_tls_local_exclude_set()
    for key in (keys.AutogradCPU, keys.AutogradCUDA, keys.ADInplaceOrView):
        excluded = excluded.remove(key)
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         excluded):
        return fn(*args)


@dmv_fused.register_kernel("cpu")
def _dmv_fused_cpu(dec, attach, lengths, kind="log"):
    return _with_autograd(_plain.dmv_value_and_grads_plain, dec, attach, lengths, kind)


@dmv_fused.register_fake
def _dmv_fused_fake(dec, attach, lengths, kind="log"):
    return (dec.new_empty(dec.shape[:1], dtype=torch.float32),
            torch.empty_like(dec, dtype=torch.float32),
            torch.empty_like(attach, dtype=torch.float32))


def _inside_library():
    global _inside_lib, _smem_optin
    if _inside_lib is None:
        lib = _build.load("dmv_inside")
        lib.dmv_inside_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.dmv_inside_launch.restype = ctypes.c_int
        _inside_lib, _smem_optin = lib, _query_optin(lib.dmv_inside_smem_optin)
    return _inside_lib


def inside_mapping(n1: int, smem_optin: int) -> str:
    """Which mapping of ``csrc/dmv_inside.cu`` serves charts of ``n1``
    positions, from ``n1`` and the card's opt-in shared memory alone:
    ``warp`` (a warp per sentence) for tiny charts, ``smem`` (a block per
    sentence, charts in shared memory) while they fit, else ``global``."""
    if n1 <= WARP_MAX_N1:
        return "warp"
    if inside_smem_bytes(n1) <= smem_optin:
        return "smem"
    return "global"


def _inside(dec, attach, lengths, kind, save):
    what = "dmv_inside_save" if save else "dmv_inside"
    dec, attach, lengths, B, n1 = _checked(what, dec, attach, lengths, kind)
    lib = _inside_library()
    out = torch.empty(B, device=dec.device, dtype=torch.float32)
    charts = torch.empty((B, 4, n1, n1, 2), device=dec.device,
                         dtype=torch.float32) if save else None
    if B == 0:
        return out, charts
    plan = inside_plan(n1, _smem_optin)
    mapping = plan["mapping"]
    scratch = torch.empty(B * INSIDE_BYTES_PER_N1SQ * n1 * n1, device=dec.device,
                          dtype=torch.uint8) if mapping == "global" and not save else None
    with torch.cuda.device(dec.device):
        err = lib.dmv_inside_launch(
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lengths),
            _build.ptr(out), None if charts is None else _build.ptr(charts),
            None if scratch is None else _build.ptr(scratch),
            B, n1, int(kind == "max"), int(save), MAPPINGS.index(mapping),
            plan["threads"], int(plan["stage"]), _build.stream_ptr(dec.device))
    _build.check(err, f"dmv_inside_launch ({what}, {mapping})")
    trace.count(f"dmv.{'inside_save' if save else 'inside'}.{mapping}")
    return out, charts


@torch.library.custom_op("vlgae::dmv_inside", mutates_args=(), device_types="cuda")
def dmv_inside(dec: Tensor, attach: Tensor, lengths: Tensor, kind: str = "log") -> Tensor:
    """The per-sentence total ``[B]`` alone (K2; K4 for tiny and for long
    charts) on the card, :func:`~vlgae_tpu_torch.struct.dmv.dmv_total` on
    the CPU. No chart leaves the kernel."""
    return _inside(dec, attach, lengths, kind, save=False)[0]


@dmv_inside.register_kernel("cpu")
def _dmv_inside_cpu(dec, attach, lengths, kind="log"):
    with torch.no_grad():
        return _plain.dmv_total(dec, attach, lengths, kind)


@dmv_inside.register_fake
def _dmv_inside_fake(dec, attach, lengths, kind="log"):
    return dec.new_empty(dec.shape[:1], dtype=torch.float32)


@torch.library.custom_op("vlgae::dmv_inside_save", mutates_args=(), device_types="cuda")
def dmv_inside_save(dec: Tensor, attach: Tensor, lengths: Tensor,
                    kind: str = "log") -> Tuple[Tensor, Tensor]:
    """``(total [B], charts [B, 4, N1, N1, 2])``: the inside pass that keeps
    its charts Cr, Cl, Ir, Il for :func:`dmv_outside` (K3a; K4 for tiny and
    for long charts; on the CPU
    :func:`~vlgae_tpu_torch.struct.dmv.dmv_inside_charts_plain`).
    ``charts[b, c, w, i, v]`` is the span ``[i, i+w]`` with valence ``v``;
    cells outside the span triangle hold -1e12."""
    return _inside(dec, attach, lengths, kind, save=True)


@dmv_inside_save.register_kernel("cpu")
def _dmv_inside_save_cpu(dec, attach, lengths, kind="log"):
    with torch.no_grad():
        return _plain.dmv_inside_charts_plain(dec, attach, lengths, kind)


@dmv_inside_save.register_fake
def _dmv_inside_save_fake(dec, attach, lengths, kind="log"):
    B, n1 = dec.shape[:2]
    return (dec.new_empty((B,), dtype=torch.float32),
            dec.new_empty((B, 4, n1, n1, 2), dtype=torch.float32))


@torch.library.custom_op("vlgae::dmv_outside", mutates_args=(), device_types="cuda")
def dmv_outside(dec: Tensor, attach: Tensor, lengths: Tensor, gout: Tensor, logz: Tensor,
                charts: Tensor, kind: str = "log") -> Tuple[Tensor, Tensor]:
    """``(g_dec, g_attach)``: the gradient of ``sum(gout * total)`` from the
    saved charts of :func:`dmv_inside_save` (K3b; on the CPU
    :func:`~vlgae_tpu_torch.struct.dmv.dmv_outside_plain`), already scaled by
    ``gout [B]``; ``logz [B]`` is that pass's total."""
    global _outside_lib
    dec, attach, lengths, B, n1 = _checked("dmv_outside", dec, attach, lengths, kind)
    for name, t, shape in (("gout", gout, (B,)), ("logz", logz, (B,)),
                           ("charts", charts, (B, 4, n1, n1, 2))):
        if not t.is_cuda or t.device != dec.device or t.dtype != torch.float32:
            raise TypeError(f"dmv_outside: {name} must be f32 on {dec.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dmv_outside: {name} shape {tuple(t.shape)} != {shape}")
    gout, logz, charts = gout.contiguous(), logz.contiguous(), charts.contiguous()
    if _outside_lib is None:
        lib = _build.load("dmv_outside")
        lib.dmv_outside_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.dmv_outside_launch.restype = ctypes.c_int
        _outside_lib = lib
    _inside_library()  # the shared-memory limit is queried there
    g_dec = torch.empty_like(dec)
    g_attach = torch.empty_like(attach)
    if B == 0:
        return g_dec, g_attach
    plan = outside_plan(n1, _smem_optin)
    use_smem = plan["mapping"] == "smem"
    scratch = None if use_smem else torch.empty(
        B * OUTSIDE_SCRATCH_PER_N1SQ * n1 * n1, device=dec.device, dtype=torch.uint8)
    with torch.cuda.device(dec.device):
        err = _outside_lib.dmv_outside_launch(
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lengths),
            _build.ptr(gout), _build.ptr(logz), _build.ptr(charts),
            _build.ptr(g_dec), _build.ptr(g_attach),
            None if scratch is None else _build.ptr(scratch),
            B, n1, int(kind == "max"), int(use_smem), int(plan["stage"]),
            plan["threads"], _build.stream_ptr(dec.device))
    _build.check(err, f"dmv_outside_launch ({plan['mapping']})")
    trace.count("dmv.outside")
    if not use_smem:
        trace.count("dmv.outside_global")
    return g_dec, g_attach


@dmv_outside.register_kernel("cpu")
def _dmv_outside_cpu(dec, attach, lengths, gout, logz, charts, kind="log"):
    return _with_autograd(_plain.dmv_outside_plain, dec, attach, lengths, gout, logz,
                          charts, kind)


@dmv_outside.register_fake
def _dmv_outside_fake(dec, attach, lengths, gout, logz, charts, kind="log"):
    return (torch.empty_like(dec, dtype=torch.float32),
            torch.empty_like(attach, dtype=torch.float32))
