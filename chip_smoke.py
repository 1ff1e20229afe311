"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. env       - torch / CUDA / nvcc versions and the card (nvidia-smi)
  2. build     - compile every kernel from csrc/ (one nvcc per source, in
                 parallel)
  3. k1        - the fused DMV kernel against its plain version (log + max),
                 at B=64 with ragged lengths 1..50, a batch with lengths up
                 to 80 and n1 < 10; reruns bit-identical
  4. k5        - the matching-max kernel (bf16 tensor cores) against its
                 plain version at A=B=64, Q=102, D=128 and V=703 (eval) and
                 739 (train); exactly on quarter-integer operands at shapes
                 that hit the edges of its tiles (104 words, 64 image rows,
                 4 captions, blocks that serve unequal numbers of images,
                 D = 8, 130, 384) and on operands full of ties with whole
                 rows and columns masked; its time
                 beside one bf16 ``torch.matmul`` of the same product, which
                 stores the product and takes no maxes
  5. k6        - the matching backward against its plain version at the
                 training shape A=B=64, Q=102, V=739, D=128 (its K5 forward
                 held against the plain version too), exactly at a ragged
                 shape, where the bf16 rounding of the summed cell weight
                 shows, and on a hot word, a hot region and cells that win
                 both ways; its winner lists against their plain version;
                 the lists' lengths; its time beside the two bf16
                 ``torch.matmul`` products over the dense winner weight
  6. reference - the card against the CPU on a small corpus (predictions)
  7. train_reference - one joint train step, the card against the CPU, at
                 small widths and precision=32 (loss and every gradient)
  8. slice     - ``vlgae_tpu_torch.predict`` (exp=vlgae, init_seed=0,
                 device=cuda) on a synthetic corpus at the recipe's widths,
                 then ``eval.py`` on the dev predictions
  9. train     - ``vlgae_tpu_torch.train`` on that corpus at the recipe's
                 widths and bf16: one warm-up and one joint epoch, the
                 checkpoints, ``eval.py`` on the test predictions, K5 and
                 K6 on a joint step's own tensors (K6's time and list
                 lengths there too), and the train-step time
                 at B=64
 10. k2        - the value-only inside kernel against ``dmv_total`` (log +
                 max) at B=64 with ragged lengths, in its three mappings: a
                 warp per sentence (n1 = 2, 3, 5, 9), a block per sentence
                 with charts in shared memory (n1 = 10, 17, 51) and in
                 global memory (n1 = 101); exact in the max semiring on
                 quarter-integer potentials
 11. k3        - the chart-saving inside kernel against the plain charts,
                 the outside kernel against its plain version under a
                 cotangent with zeros (on the kernel's charts and on the
                 plain charts uploaded), the pair against K1 scaled by the
                 cotangent, reruns bit-identical; the same n1 groups
 12. lang_only_reference - ``exp=lang_only`` at small widths and
                 precision=32: the card and the CPU write the same dev
                 predictions and take the same NLL train step
 13. lang_only - ``vlgae_tpu_torch.train`` then ``.predict`` with
                 ``exp=lang_only`` at the recipe's widths on a synthetic
                 corpus (captions of 3-49 words, training ones up to 10):
                 one warm-up and one NLL epoch, which kernels each step
                 launched, the kernels on a training and an eval batch's
                 own tensors, the checkpoint, step times at B=64; then
                 ``predict`` on a small corpus of captions of 86-99 words
                 (charts beyond shared memory)
 14. vit_reference - ``exp=vlgae_vit`` at small widths (32 px images, 16 px
                 patches, ViT 16/1/2/32) and precision=32, the backbone's
                 weights from an .npz through ``vis_encoder.vit_weights``:
                 the card and the CPU write the same dev predictions and
                 take the same joint train step
 15. vit       - ``vlgae_tpu_torch.train`` then ``.predict`` with
                 ``exp=vlgae_vit`` at the recipe's widths (224 px images, 32
                 px patches, ViT 192/4/4/384, captions up to 63 words) and
                 bf16: one warm-up and one joint epoch, K1 in its
                 global-scratch mapping (n1 = 65), K5 in two q-chunks at
                 V = 1,324 and K6 at V = 1,324 on the path (launches counted,
                 each held against its plain version on the path's own
                 tensors), the frozen ViT bit-identical after training,
                 ``eval.py`` on the predictions with the patch grid as
                 proposal boxes, step times and the kernels' times there;
                 one eval step with ``mbr_decoding`` on at n1 = 65 (three
                 K1 launches in global scratch, heads held to the plain
                 Eisner fill)
 16. mbr       - MBR decoding: K1 on Eisner potentials (free decisions, the
                 arc in both valences) against the plain Eisner fill at B=64,
                 n1 = 51, 65 and 101 (log and max, device time beside the
                 plain fill's); ``predict`` of ``exp=vlgae`` at the recipe's
                 widths and precision=32 with MBR, the card against the CPU
                 on the dev set (arcs equal wherever the MBR tree wins by
                 ``MBR_MARGIN``, every head set a projective tree),
                 ``eval.py`` on it; the recipe's bf16 eval step with and
                 without MBR (K1 2 -> 3 launches a step); ``exp=lang_only``
                 ``predict`` with MBR (K1 1 -> 2 a step) on the corpus of
                 phase ``lang_only`` and on 86-99 word captions (K1 in
                 global scratch), its eval step with and without MBR, and
                 the small precision=32 corpus, card against CPU
 17. em        - the classic tabular DMV on the lang_only corpus: km_init,
                 two EM epochs at B=64 on the card (K3a + K3b each E-step)
                 and on the CPU, tables within ``EM_TOL``; MBR and Viterbi
                 decodes of dev (UAS), the card against the CPU on three
                 batches; the E-step's time and K3a/K3b at its shape
Phases ``k1``, ``k5`` and ``k6`` also hold K1 at n1 = 65 and K5 and K6 at
the patch grid's V (1,324 in training, 1,275 in evaluation) and Q = 130.
Then each phase's seconds, the card's name and power limit, the per-kernel
table (launches on the main paths, error, time, the plain version's time,
the bound the card's peaks set for the same work, a library call's time
where one exists) and, as the last line, ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without that line. Needs
one CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("dmv_fused", "dmv_inside", "dmv_outside", "match_fwd", "match_bwd")
KERNELS = {
    "dmv_fused": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_fused.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:878",
    },
    # the inside pass alone: a block per sentence, charts in shared memory
    "dmv_inside": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:546",
    },
    "dmv_inside_save": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:555",
    },
    "dmv_outside": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_outside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:861",
    },
    # the same two inside functions in the warp mapping (n1 <= 9) ...
    "dmv_inside_small": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:569",
    },
    # ... and with charts in global memory (beyond shared memory)
    "dmv_inside_long": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:590",
    },
    "match_fwd": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/match_fwd.cu",
        "replaces": "vlgae_tpu/ops/match_pallas.py:195",
    },
    "match_bwd": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/match_bwd.cu",
        "replaces": "vlgae_tpu/ops/match_pallas.py:267",
    },
}
# tolerances of the kernel/plain comparisons (f32, different sum orders)
K1_TOTAL_ATOL, K1_TOTAL_RTOL = 1e-3, 1e-5
# grads: marginals <= 1 and GO counts up to the sentence length; the
# log-domain sums carry a few ulp of |log Z| (~100 at length 50)
K1_GRAD_ATOL, K1_GRAD_RTOL = 5e-4, 1e-4
K5_ATOL, K5_RTOL = 1e-3, 1e-6
# K6: exact bf16 x bf16 products summed in f32 in different orders, then
# rounded to bf16: one bf16 ulp (2^-8 relative) plus f32 order noise
K6_ATOL, K6_RTOL = 1e-4, 2.0 ** -7
# card vs CPU train step at precision=32 (f32, different summation orders)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
# peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}


def bound(n_bytes, n_ops, dtype):
    """``{"bound_ms", "bound_by"}``: the least time the card could take to
    read each input once, write each output once and do ``n_ops`` operations
    of ``dtype``."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_ops": int(n_ops)}


def dmv_inside_ops(lengths):
    """Operations of the inside pass for these lengths: a span of width w
    has 6 split-point sums (two incomplete, two complete of each valence) of
    w terms, each term one semiring product and one semiring sum."""
    total = 0
    for length in lengths:
        n = int(length) + 1
        total += sum(12 * w * (n - w) for w in range(1, n))
    return total


def dmv_bound(lengths, n1, what):
    """The bound of a DMV kernel at this batch. ``what``: "inside" (the
    total alone), "save" (plus the charts written), "outside" (charts,
    cotangent and total read, both tables written; its operations counted
    as twice the inside pass's, each split term having two adjoint terms)
    or "fused" (inside + outside, the tables written)."""
    B = len(lengths)
    potentials = 4 * B * (n1 * 8 + n1 * n1 * 2) + 4 * B
    charts = 4 * B * 4 * n1 * n1 * 2
    ops = dmv_inside_ops(lengths)
    n_bytes, n_ops = {
        "inside": (potentials + 4 * B, ops),
        "save": (potentials + 4 * B + charts, ops),
        "outside": (2 * potentials - 4 * B + charts + 8 * B, 2 * ops),
        "fused": (2 * potentials, 3 * ops),
    }[what]
    return bound(n_bytes, n_ops, "f32")


def close(got, want, atol, rtol):
    """Elementwise |got - want| <= atol + rtol * |want|."""
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=7, warmup=2):
    """Median device time of ``fn()`` in ms (CUDA events, one call each)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20, reps=5):
    """Median device time of one ``fn()`` in ms when ``n`` calls are queued
    behind a busy device: the card first spins for some milliseconds while
    the host enqueues the calls, so the time between the two events holds
    the kernels back to back and none of the host's enqueueing (a call
    through a wrapper costs the host more than a small kernel runs)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # about 10 ms of spinning
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_env(state):
    import torch

    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1] if nvcc else None,
          "gpu": nvidia_smi_line(),
          "device_count": torch.cuda.device_count()})


def phase_build(state):
    import shutil

    from vlgae_tpu_torch.ops import _build

    from concurrent.futures import ThreadPoolExecutor

    # always from the sources: drop libraries left by an earlier run
    shutil.rmtree(_build.BUILD, ignore_errors=True)

    def one(name):
        t0 = time.perf_counter()
        _build.build(name, verbose=True)
        return round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        out = dict(zip(SOURCES, pool.map(one, SOURCES)))
    emit({"phase": "build", "seconds": out,
          "wall_s": round(time.perf_counter() - t0, 3)})


def _dmv_inputs(rng, lengths, n1, device, quarter=False):
    """Merged potentials of a batch: standard normal (tie-free), or with
    ``quarter`` quarter-integers in [-2, 2] (every sum of the max semiring
    exact, ties common)."""
    import numpy as np
    import torch

    from vlgae_tpu_torch.struct import dmv_merge

    B, n = len(lengths), n1 - 1

    def draw(*shape):
        x = rng.integers(-8, 9, shape) * 0.25 if quarter else rng.standard_normal(shape)
        return torch.tensor(x, dtype=torch.float32)

    mdec, mattach = dmv_merge(draw(B, n, 2, 2, 2), draw(B, n, n, 2), draw(B, n))
    return (mdec.to(device), mattach.to(device),
            torch.tensor(np.asarray(lengths), dtype=torch.int32, device=device))


def phase_k1(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused
    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    recipe = rng.integers(1, 51, 64)
    recipe[:3] = (1, 50, 0)  # length 1, the longest, a zero-length filler
    # exp=vlgae_vit trains on captions of up to 63 words: n1 = 65, past the
    # shared-memory limit, so K1 keeps its charts in global scratch
    vit = rng.integers(1, 65, 64)
    vit[:3] = (64, 1, 0)
    cases = {
        "B64_len1-50": (recipe, 51),
        "B16_len-to-80": (np.r_[80, 0, 1, rng.integers(51, 81, 13)], 81),
        "B16_n1-lt-10": (np.r_[0, 1, 8, rng.integers(0, 9, 13)], 9),
        "B64_len1-64_global": (vit, 65),
    }
    worst = 0.0
    result = {"phase": "k1", "cases": {}}
    for name, (lengths, n1) in cases.items():
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        for kind in ("log", "max"):
            g0 = dmv_cuda.n_fused_global_launches
            kt, kd, ka = dmv_fused(dec, attach, lens, kind)
            again = dmv_fused(dec, attach, lens, kind)
            if name.endswith("_global") and dmv_cuda.n_fused_global_launches != g0 + 2:
                raise AssertionError(f"K1 {name} did not take the global-scratch mapping")
            pt, pd, pa = dmv_value_and_grads_plain(dec, attach, lens, kind)
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip((kt, kd, ka), again)):
                raise AssertionError(f"K1 {name}/{kind} gave different bits on two runs")
            e_tot = (kt - pt).abs()
            ok_tot = close(kt, pt, K1_TOTAL_ATOL, K1_TOTAL_RTOL)
            ok_grads = all(close(k, p, K1_GRAD_ATOL, K1_GRAD_RTOL)
                           for k, p in ((kd, pd), (ka, pa)))
            e_d = float((kd - pd).abs().max())
            e_a = float((ka - pa).abs().max())
            errs = {"total": float(e_tot.max()), "g_dec": e_d, "g_attach": e_a}
            result["cases"][f"{name}/{kind}"] = errs
            worst = max(worst, e_d, e_a)
            if not (ok_tot and ok_grads):
                emit(result)
                raise AssertionError(f"K1 {name}/{kind} disagrees: {errs}")
    dec, attach, lens = _dmv_inputs(rng, recipe, 51, dev)
    timing = {}
    for kind in ("log", "max"):
        timing[kind] = {
            # time_ms: one call per event pair; device_ms: launches queued
            # behind a spinning device (no host time between them)
            "ms": time_ms(lambda: dmv_fused(dec, attach, lens, kind)),
            "device_ms": device_ms(lambda: dmv_fused(dec, attach, lens, kind)),
            "plain_ms": time_ms(
                lambda: dmv_value_and_grads_plain(dec, attach, lens, kind),
                reps=5, warmup=1),
        }
    result["timing_B64_len1-50"] = timing
    dec, attach, lens = _dmv_inputs(rng, vit, 65, dev)
    timing65 = {kind: {
        "ms": time_ms(lambda: dmv_fused(dec, attach, lens, kind)),
        "device_ms": device_ms(lambda: dmv_fused(dec, attach, lens, kind)),
        "plain_ms": time_ms(lambda: dmv_value_and_grads_plain(dec, attach, lens, kind),
                            reps=5, warmup=1)} for kind in ("log", "max")}
    result["timing_B64_n1-65_global"] = timing65
    result["tolerance"] = {"total": [K1_TOTAL_ATOL, K1_TOTAL_RTOL],
                           "grads": [K1_GRAD_ATOL, K1_GRAD_RTOL]}
    emit(result)
    # one launch of each semiring, as the joint model's language factors run
    both = dmv_bound(recipe, 51, "fused")
    state["dmv_fused"] = {
        "max_abs_err": worst,
        "ms": timing["log"]["ms"] + timing["max"]["ms"],
        "plain_ms": timing["log"]["plain_ms"] + timing["max"]["plain_ms"],
        **both, "bound_ms": 2 * both["bound_ms"], "library_ms": None,
        "ms_log": timing["log"]["ms"], "ms_max": timing["max"]["ms"],
        "device_ms_log": timing["log"]["device_ms"],
        "device_ms_max": timing["max"]["device_ms"],
        "dependent_steps": 4 * 50,
    }
    both65 = dmv_bound(vit, 65, "fused")
    state["dmv_fused"]["at_n1_65_global"] = {
        "ms": timing65["log"]["ms"] + timing65["max"]["ms"],
        "plain_ms": timing65["log"]["plain_ms"] + timing65["max"]["plain_ms"],
        **both65, "bound_ms": 2 * both65["bound_ms"],
        **{f"{k}_{kind}": timing65[kind][k] for kind in timing65
           for k in ("ms", "device_ms", "plain_ms")},
        "dependent_steps": 4 * 64}


def _check_k5(args, exact, what):
    """K5 against its plain version on ``args`` = (vis, txt, vis_bias,
    txt_bias): all four outputs equal when ``exact``; otherwise values
    within tolerance, and an index may differ only where the two winners
    tie within tolerance. Returns the kernel's outputs, the max value
    errors and the index mismatch counts."""
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_cuda, match_maxes_plain

    vis, txt, vb, tb = args
    with torch.no_grad():
        k = match_maxes_cuda(*args)
        p = match_maxes_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, kv, pv in (("logit", k[0], p[0]), ("logit_v", k[2], p[2])):
        errs[name] = float((kv - pv).abs().max())
        # a masked cell sits near -1e9, where one f32 ulp is 64
        live = pv > -1e8
        errs[f"{name}_unmasked"] = float((kv - pv)[live].abs().max()) if bool(
            live.any()) else 0.0
        if not (torch.equal(kv, pv) if exact else close(kv, pv, K5_ATOL, K5_RTOL)):
            raise AssertionError(f"K5 {name} disagrees {what}: max err {errs[name]}")

    def att_at(b, a, q, v):
        x = (txt.float()[b, q] * vis.float()[a, v]).sum(-1)
        return x + vb[a, v] + tb[b, q]

    off = {}
    bb, aa, qq = torch.nonzero(k[1] != p[1], as_tuple=True)
    x1, x2 = att_at(bb, aa, qq, k[1][bb, aa, qq]), att_at(bb, aa, qq, p[1][bb, aa, qq])
    ok_q = bool(((x1 - x2).abs() <= K5_ATOL + K5_RTOL * x2.abs()).all())
    off["logit_idx"] = int(bb.numel())
    bb, aa, vv = torch.nonzero(k[3] != p[3], as_tuple=True)
    x1 = att_at(bb, aa, k[3][bb, aa, vv], vv)
    x2 = att_at(bb, aa, p[3][bb, aa, vv], vv)
    ok_v = bool(((x1 - x2).abs() <= K5_ATOL + K5_RTOL * x2.abs()).all())
    off["logit_v_idx"] = int(bb.numel())
    if exact and any(off.values()):
        raise AssertionError(f"K5 indices disagree {what}: {off}")
    if not (ok_q and ok_v):
        raise AssertionError(f"K5 indices disagree beyond ties {what}: {off}")
    return k, errs, off


# (A, V, B, Q, D) that hit the edges of K5's tiles: chunks of 104 words (the
# wgmma's N), stages of 64 image rows (its M), 4 captions a block, k-steps of
# 16 and stages of 128, 50 caption tiles, so that 2 blocks share 5 images,
# and the other builds (one chunk of 40 words, of 72, of 120)
K5_EDGES = ((5, 65, 62, 202, 130), (2, 15, 1, 7, 8), (3, 63, 5, 103, 128),
            (3, 64, 4, 104, 128), (3, 65, 7, 105, 128), (2, 20, 3, 9, 384),
            (5, 70, 200, 9, 16), (3, 65, 6, 34, 128), (3, 65, 6, 66, 128),
            (2, 70, 5, 114, 128), (3, 1324, 5, 130, 128))
# the patch grid of exp=vlgae_vit (49 patches, their pairs, attributes and
# the image): V in training (inclusive pair triangle) and in evaluation
# (strict), beside its longest captions (63 words: Q = 130, two q-chunks)
VIT_V = {"train": 1324, "eval": 1275}
VIT_Q = 130


def _k5_inputs(rng, A, V, B, Q, D, dev, kind):
    """bf16 operands and -1e9 masks. ``kind``: "random" (standard normal),
    "quarter" (quarter-integers in [-2, 2]: every product and sum exact) or
    "ties" (operands in {-1/4, 0, 1/4} and a whole image, caption, region
    and word masked: nearly every maximum is tied)."""
    import numpy as np
    import torch

    def draw(*shape):
        if kind == "random":
            return rng.standard_normal(shape)
        scale = 1 if kind == "ties" else 8
        return rng.integers(-scale, scale + 1, shape) * 0.25

    vis = torch.tensor(draw(A, V, D), dtype=torch.float32, device=dev).bfloat16()
    txt = torch.tensor(draw(B, Q, D), dtype=torch.float32, device=dev).bfloat16()
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.2, -1e9, 0.0),
                      dtype=torch.float32, device=dev)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=dev)
    if kind == "ties":
        vb[0, :] = -1e9
        vb[:, V // 2] = -1e9
        tb[B - 1, :] = -1e9
        tb[:, 0] = -1e9
    return vis, txt, vb, tb


def phase_k5(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import (match_fwd_plan, match_maxes_cuda,
                                           match_maxes_plain)

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    A = B = 64
    Q, D = 102, 128
    # exact agreement, indices included, at the tiles' edges ...
    for shape in K5_EDGES:
        _check_k5(_k5_inputs(rng, *shape, dev, "quarter"), True,
                  "at A={}, V={}, B={}, Q={}, D={}".format(*shape))
    # ... and where nearly every maximum is tied and whole rows and columns
    # are masked (index 0 on those)
    tie_shape = (6, 130, 7, 110, 8)
    (_, li, _, lvi), _, _ = _check_k5(_k5_inputs(rng, *tie_shape, dev, "ties"), True,
                                      "on tied and wholly masked operands")
    if int(li[:, 0].max()) != 0 or int(lvi[tie_shape[2] - 1].max()) != 0:
        raise AssertionError("K5: a wholly masked row or column did not give index 0")
    timing = {}
    for V in (703, 739):  # the eval and the training shape
        args = _k5_inputs(rng, A, V, B, Q, D, dev, "random")
        _, errs, off = _check_k5(args, False, f"at V={V}")
        vis, txt = args[:2]
        x, y = txt.reshape(B * Q, D), vis.reshape(A * V, D)
        timing[V] = {
            "max_abs_err": errs, "index_mismatch_within_tol": off,
            "ms": time_ms(lambda: match_maxes_cuda(*args)),
            "device_ms": device_ms(lambda: match_maxes_cuda(*args), n=10),
            "plain_ms": time_ms(lambda: match_maxes_plain(*args), reps=5, warmup=1),
            # one library call for the product alone: it stores [B*Q, A*V]
            # and takes no maxes; the port never calls it
            "product_only_library_ms": device_ms(lambda: torch.matmul(x, y.T), n=10),
            # inputs read once (bf16 operands, f32 masks), four [B, A, Q|V]
            # outputs written once; one multiply-add per (a, b, q, v, d) at
            # the bf16 peak
            **bound(2 * (A * V + B * Q) * D + 4 * (A * V + B * Q)
                    + 8 * B * A * (Q + V), 2 * A * B * Q * V * D, "bf16")}
    # captions are padded to multiples of 8 words and Q = 2 * (length + 1): a
    # short batch (16 words), a middling one (32) and the longest of the
    # recipe (56 words: one chunk of 120) at the training V, beside the 51
    # positions the kernels are quoted at
    by_q = {}
    for q in (34, 66, 114):
        args = _k5_inputs(rng, A, 739, B, q, D, dev, "random")
        _check_k5(args, False, f"at V=739, Q={q}")
        by_q[q] = {"device_ms": device_ms(lambda: match_maxes_cuda(*args), n=10),
                   "plain_ms": time_ms(lambda: match_maxes_plain(*args), reps=3, warmup=1),
                   **bound(2 * (A * 739 + B * q) * D + 4 * (A * 739 + B * q)
                           + 8 * B * A * (q + 739), 2 * A * B * q * 739 * D, "bf16")}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    at_vit = {}
    for what, V in VIT_V.items():
        args = _k5_inputs(rng, A, V, B, VIT_Q, D, dev, "random")
        two = match.n_launches_by_q_chunks.get(2, 0)
        _, errs, off = _check_k5(args, False, f"at V={V}, Q={VIT_Q}")
        if match.n_launches_by_q_chunks.get(2, 0) != two + 1:
            raise AssertionError(f"K5 at V={V}, Q={VIT_Q} did not take two q-chunks")
        vis, txt = args[:2]
        x, y = txt.reshape(B * VIT_Q, D), vis.reshape(A * V, D)
        at_vit[what] = {
            "V": V, "Q": VIT_Q, "max_abs_err": errs, "index_mismatch_within_tol": off,
            "plan": match_fwd_plan(A, V, B, VIT_Q, D, vis.data_ptr(), txt.data_ptr(),
                                   sm_count),
            "ms": time_ms(lambda: match_maxes_cuda(*args)),
            "device_ms": device_ms(lambda: match_maxes_cuda(*args), n=10),
            "plain_ms": time_ms(lambda: match_maxes_plain(*args), reps=5, warmup=1),
            "product_only_library_ms": device_ms(lambda: torch.matmul(x, y.T), n=10),
            **bound(2 * (A * V + B * VIT_Q) * D + 4 * (A * V + B * VIT_Q)
                    + 8 * B * A * (VIT_Q + V), 2 * A * B * VIT_Q * V * D, "bf16")}
    plan = match_fwd_plan(A, 703, B, Q, D, sm_count=sm_count)
    emit({"phase": "k5", "shape": {"A": A, "B": B, "Q": Q, "V": [703, 739], "D": D},
          "instruction": "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16",
          "plan_V703": plan, "exact_at": [list(sh) for sh in K5_EDGES],
          "exact_on_ties_at": list(tie_shape), "timing": timing,
          "timing_V739_by_Q": by_q, "timing_vit": at_vit,
          "tolerance": [K5_ATOL, K5_RTOL]})
    t = timing[703]
    state["match_fwd"] = {
        "max_abs_err": max(max(timing[V]["max_abs_err"].values()) for V in timing),
        "max_abs_err_unmasked": max(v for V in timing for k, v in
                                    timing[V]["max_abs_err"].items() if "unmasked" in k),
        "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "library_ms": None, "product_only_library_ms": t["product_only_library_ms"],
        "ms_V739": timing[739]["ms"], "device_ms_V739": timing[739]["device_ms"],
        **{k: t[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops")},
        "at_vit_shapes": {what: {k: v for k, v in r.items() if k != "plan"}
                          for what, r in at_vit.items()}}


def _match_bwd_inputs(rng, A, V, B, Q, D, dev, kind):
    """bf16 operands, -1e9 masks, indices from a K5 forward (held against
    its plain version), f32 cotangents. ``kind``: "random" (normal
    operands and cotangents), "quarter" (quarter-integers in [-2, 2]:
    every product and sum exact, every weight bf16-exact) or "dyadic"
    (quarter-integer operands, cotangents k·2^-10 with |k| < 2048: still
    exact at small shapes, but the two directions' sum needs up to 13
    bits, so rounding the weight to bf16 shows)."""
    import numpy as np
    import torch

    def draw(*shape):
        if kind == "random":
            return rng.standard_normal(shape)
        return rng.integers(-8, 9, shape) * 0.25

    def cot(*shape):
        if kind == "dyadic":
            return rng.integers(-2047, 2048, shape) * 2.0 ** -10
        return draw(*shape)

    vis = torch.tensor(draw(A, V, D), dtype=torch.float32, device=dev).bfloat16()
    txt = torch.tensor(draw(B, Q, D), dtype=torch.float32, device=dev).bfloat16()
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.2, -1e9, 0.0),
                      dtype=torch.float32, device=dev)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=dev)
    (_, li, _, lvi), _, _ = _check_k5((vis, txt, vb, tb), kind != "random",
                                      f"at A={A}, V={V}, B={B}, Q={Q}, D={D}")
    dm = torch.tensor(cot(B, A, Q), dtype=torch.float32, device=dev)
    dmv = torch.tensor(cot(B, A, V), dtype=torch.float32, device=dev)
    return vis, txt, li, lvi, dm, dmv


def _check_k6(args, exact, what):
    """K6 against its plain version on ``args``; returns the max error."""
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_bwd_cuda, match_maxes_bwd_plain

    with torch.no_grad():
        got = match_maxes_bwd_cuda(*args)
        want = match_maxes_bwd_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("dvis", "dtxt"), got, want):
        g, w = g.float(), w.float()
        err = max(err, float((g - w).abs().max()))
        ok = bool((g == w).all()) if exact else close(g, w, K6_ATOL, K6_RTOL)
        if not ok:
            raise AssertionError(f"K6 {name} disagrees {what}: max err "
                                 f"{float((g - w).abs().max())}")
    return err


def k6_list_stats(li, lvi):
    """Cross partners per owner row in K6's winner lists (their plain
    version), for each output: rows, own partners a row (one a caption or
    image), max, p99 and mean cross partners, rows with none."""
    import torch

    from vlgae_tpu_torch.ops.match import match_bwd_lists_plain

    B, A, Q = li.shape
    V = lvi.shape[2]
    lists = match_bwd_lists_plain(li, lvi)
    stats = {}
    for out, side, N, O in (("dvis", "vis", V, B), ("dtxt", "txt", Q, A)):
        cross = (lists["starts_" + side].long().diff().view(-1, N + 1)[:, :N] - O).flatten().float()
        stats[out] = {"rows": cross.numel(), "own": O, "cross_max": int(cross.max()),
                      "cross_p99": float(torch.quantile(cross, 0.99)),
                      "cross_mean": float(cross.mean()),
                      "rows_without_cross": int((cross == 0).sum())}
    return stats


def k6_product_library_ms(vis, txt, li, lvi, dm, dmv):
    """K6's yardstick: the two bf16 ``torch.matmul`` products over the dense
    winner weight W (bf16 of the summed cotangents, as K6 weighs a cell),
    prebuilt outside the timed region in the layouts they need, ``[A·V,
    B·Q] @ txt`` and ``[B·Q, A·V] @ vis``. The port never calls them."""
    import torch

    A, V, D = vis.shape
    B, Q, _ = txt.shape
    w = torch.zeros(B, A, Q, V, device=vis.device)
    w.scatter_(3, li.long()[..., None], dm[..., None])
    wq = torch.zeros_like(w)
    wq.scatter_(2, lvi.long()[:, :, None, :], dmv[:, :, None, :])
    w = (w + wq).bfloat16()
    del wq
    w_vis = w.permute(1, 3, 0, 2).reshape(A * V, B * Q).contiguous()
    w_txt = w.permute(0, 2, 1, 3).reshape(B * Q, A * V).contiguous()
    del w
    x, y = txt.reshape(B * Q, D), vis.reshape(A * V, D)
    ms = device_ms(lambda: (torch.matmul(w_vis, x), torch.matmul(w_txt, y)), n=10)
    del w_vis, w_txt
    torch.cuda.empty_cache()
    return ms


def k6_kernels_ms(args, n=10):
    """Device ms a call of each of K6's CUDA kernels (build, rows, finish),
    from ``torch.profiler`` over ``n`` calls."""
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_bwd_cuda

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            match_maxes_bwd_cuda(*args)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for part in ("build", "rows", "finish"):
            if f"match_bwd_{part}_kernel" in ev.key:
                t = getattr(ev, "device_time_total", None) or ev.cuda_time_total
                out[part] = out.get(part, 0.0) + t / n / 1e3
    return out


def phase_k6(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops.match import (match_bwd_launch, match_bwd_lists_plain,
                                           match_maxes_bwd_cuda, match_maxes_bwd_plain)

    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    exact_shape = dict(A=5, V=65, B=62, Q=202, D=130)
    _check_k6(_match_bwd_inputs(rng, *exact_shape.values(), dev, "quarter"), True,
              f"at {exact_shape}")
    # the cell weight is rounded to bf16 AFTER the two directions add: a
    # cell that wins both ways gets bf16(dm + dmv) = 1.109375 here, where
    # bf16(dm) + bf16(dmv) would give 1.1171875
    one = torch.ones(1, 1, 1, dtype=torch.bfloat16, device=dev)
    win = torch.zeros(1, 1, 1, dtype=torch.int32, device=dev)
    dm = torch.full((1, 1, 1), float.fromhex("0x1.1de51cp+0"), device=dev)
    dmv = torch.full((1, 1, 1), float.fromhex("-0x1.e92802p-9"), device=dev)
    pair = [float(g) for g in match_maxes_bwd_cuda(one, one, win, win, dm, dmv)]
    if pair != [1.109375, 1.109375]:
        raise AssertionError(f"K6 rounds the summed weight wrongly: {pair}")
    # the same on cotangents that are not bf16-exact, at a shape small
    # enough for every f32 sum to stay exact (see _match_bwd_inputs)
    round_shape = dict(A=4, V=33, B=6, Q=31, D=16)
    args = _match_bwd_inputs(rng, *round_shape.values(), dev, "dyadic")
    _check_k6(args, True, f"at {round_shape} (12-bit cotangents)")
    vis, txt, li, lvi, dm, dmv = args
    separate = match_maxes_bwd_plain(vis, txt, li, lvi, dm.bfloat16().float(),
                                     dmv.bfloat16().float())
    if all(torch.equal(a, b) for a, b in zip(match_maxes_bwd_plain(*args), separate)):
        raise AssertionError("the 12-bit case does not tell the two roundings apart")
    shape = dict(A=64, V=739, B=64, Q=102, D=128)
    args = _match_bwd_inputs(rng, *shape.values(), dev, "random")
    err = _check_k6(args, False, f"at {shape}")
    first = match_maxes_bwd_cuda(*args)
    again = match_maxes_bwd_cuda(*args)
    identical = all(bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
                    for a, b in zip(first, again))
    if not identical:
        raise AssertionError("K6 gave different bits on two runs")
    # the card's winner lists and row starts are those of the plain version
    scratch = match_bwd_launch(*args)[2]
    plain_lists = match_bwd_lists_plain(*args[2:4])
    if not all(torch.equal(scratch[k], w) for k, w in plain_lists.items()):
        raise AssertionError("K6's winner lists differ from their plain version")
    # exactly on rows that span many segments: word 1 of every caption wins
    # every region (a dtxt row with A·V cross partners), region 2 of every
    # image wins every word (a dvis row with B·Q), every cell (b, a, q, q)
    # wins both ways
    vis, txt, li, lvi, dm, dmv = _match_bwd_inputs(rng, *shape.values(), dev, "quarter")
    q = torch.arange(shape["Q"], device=dev, dtype=torch.int32)
    hot = {"hot_word": (li, torch.ones_like(lvi)), "hot_region": (torch.full_like(li, 2), lvi),
           "own_cross": (q.expand_as(li).contiguous(),
                         lvi.clone().index_copy_(2, q.long(), q.expand(*lvi.shape[:2], -1)))}
    for name, (hli, hlvi) in hot.items():
        hargs = (vis, txt, hli, hlvi, dm, dmv)
        _check_k6(hargs, True, f"on the {name} case at {shape}")
        if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in
                   zip(match_maxes_bwd_cuda(*hargs), match_maxes_bwd_cuda(*hargs))):
            raise AssertionError(f"K6 gave different bits on two runs ({name})")
    timed = k6_timing(args)
    emit({"phase": "k6", "shape": shape, "exact_at": exact_shape,
          "exact_12bit_cotangents_at": round_shape, "rounded_pair": pair,
          "exact_hot_cases": list(hot), "lists_equal_plain": True,
          "max_abs_err": err, "tolerance": [K6_ATOL, K6_RTOL],
          "bit_identical_reruns": identical, **timed})
    # the patch grid of exp=vlgae_vit: V = 1,324 at its longest captions,
    # exactly on quarter-integers and within tolerance on normal operands
    vit_shape = dict(A=64, V=VIT_V["train"], B=64, Q=VIT_Q, D=128)
    _check_k6(_match_bwd_inputs(rng, *vit_shape.values(), dev, "quarter"), True,
              f"at {vit_shape}")
    vargs = _match_bwd_inputs(rng, *vit_shape.values(), dev, "random")
    verr = _check_k6(vargs, False, f"at {vit_shape}")
    scratch = match_bwd_launch(*vargs)[2]
    plain_lists = match_bwd_lists_plain(*vargs[2:4])
    if not all(torch.equal(scratch[k], w) for k, w in plain_lists.items()):
        raise AssertionError(f"K6's winner lists differ from their plain version at {vit_shape}")
    del scratch, plain_lists
    vtimed = k6_timing(vargs)
    emit({"phase": "k6", "shape": vit_shape, "exact_at": vit_shape,
          "lists_equal_plain": True, "max_abs_err": verr,
          "tolerance": [K6_ATOL, K6_RTOL], **vtimed})
    keep = ("ms", "device_ms", "kernels_ms", "plain_ms", "product_only_library_ms",
            "winning_cells", "scratch_bytes", "bound_ms", "bound_by", "bound_bytes",
            "bound_ops")
    state["match_bwd"] = {
        "max_abs_err": max(err, verr), "library_ms": None,
        **{k: timed[k] for k in keep},
        "at_vit_shape": {"shape": vit_shape, "max_abs_err": verr,
                         **{k: vtimed[k] for k in keep}}}


def k6_timing(args):
    """K6's times on ``args`` (one call, queued calls, each CUDA kernel), its
    plain version's, the matmul yardstick, the lists' lengths, the scratch
    plan and the bound of what this run's winners need: one multiply-add
    per feature and output (dvis, dtxt) for each distinct winning cell
    (b, a, q, v)."""
    import torch

    from vlgae_tpu_torch.ops.match import (match_bwd_plan, match_maxes_bwd_cuda,
                                           match_maxes_bwd_plain)

    vis, txt, li, lvi, dm, dmv = args
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    dev = vis.device
    plan = match_bwd_plan(A, V, B, Q, D, vis.data_ptr(), txt.data_ptr())
    out = {"ms": time_ms(lambda: match_maxes_bwd_cuda(*args)),
           "device_ms": device_ms(lambda: match_maxes_bwd_cuda(*args), n=20),
           "kernels_ms": k6_kernels_ms(args),
           "plain_ms": time_ms(lambda: match_maxes_bwd_plain(*args), reps=5, warmup=1),
           "product_only_library_ms": k6_product_library_ms(*args),
           "list_lengths": k6_list_stats(li, lvi), "plan": plan,
           "scratch_bytes": plan["bytes"]}
    ba = torch.arange(B * A, device=dev).view(B, A, 1)
    q_side = (ba * Q + torch.arange(Q, device=dev)) * V + li.long()
    v_side = (ba * Q + lvi.long()) * V + torch.arange(V, device=dev)
    cells = int(torch.unique(torch.cat([q_side.flatten(), v_side.flatten()])).numel())
    return {**out, "winning_cells": cells,
            **bound(2 * 2 * (A * V + B * Q) * D + 8 * B * A * (Q + V),
                    4 * cells * D, "bf16")}


def _check_dmv_on_path(out, lengths):
    """K1's results inside the predict path against the plain version on
    the same potentials. The model's potentials have exact ties (children
    with one tag score alike): there the kernel marks every cell of every
    best tree (1) while the plain version splits the gradient (fractions),
    so in the max semiring the two must have the same totals and the same
    support everywhere, and equal values on sentences without a tie."""
    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain

    dec, attach = out["merged_dec"], out["merged_attach"]
    errs = {}
    for kind in ("log", "max"):
        got = out["dep_reuse"][kind]
        want = dmv_value_and_grads_plain(dec, attach, lengths, kind)
        errs[f"{kind}_total"] = float((got[0] - want[0]).abs().max())
        if not close(got[0], want[0], K1_TOTAL_ATOL, K1_TOTAL_RTOL):
            raise AssertionError(f"K1 {kind} total on the path: {errs}")
        if kind == "log":
            errs["log_grads"] = max(float((g - w).abs().max())
                                    for g, w in zip(got[1:], want[1:]))
            if not all(close(g, w, K1_GRAD_ATOL, K1_GRAD_RTOL)
                       for g, w in zip(got[1:], want[1:])):
                raise AssertionError(f"K1 log grads on the path: {errs}")
            continue
        if not all(bool(((g > 0) == (w > 0)).all())
                   for g, w in zip(got[1:], want[1:])):
            raise AssertionError(f"K1 max indicator support on the path: {errs}")
        tied = ((want[2] % 1) != 0).flatten(1).any(1)
        clean = ~tied
        errs["tied_sentences"] = int(tied.sum())
        errs["max_grads_untied"] = max(
            float((g[clean] - w[clean]).abs().max()) if bool(clean.any()) else 0.0
            for g, w in zip(got[1:], want[1:]))
        if errs["max_grads_untied"] != 0.0:
            raise AssertionError(f"K1 max indicators on the path: {errs}")
    return errs


def _corpus_overrides(root):
    return [
        "exp=vlgae", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
    ]


def _run_predict(workdir, overrides):
    from vlgae_tpu_torch import predict

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return predict.main(overrides)
    finally:
        os.chdir(cwd)


def phase_slice(state):
    """The predict path at the recipe's widths (len <= 50, B = 64, P = 36,
    2048-d box features), random weights from seed 0."""
    import math

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.ops.match import match_maxes_plain
    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain
    from vlgae_tpu_torch.training.pipeline import _to_device, pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # 104 images: 520 train, 260 dev and 260 test captions
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048,
                    n_box=36, len_range=(3, 50), seed=0)
        t_corpus = time.perf_counter() - t0
        overrides = _corpus_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1"
            for s in ("train", "dev", "test")] + ["init_seed=0", "device=cuda"]
        dmv_cuda.n_launches = 0
        match.n_launches = 0
        t0 = time.perf_counter()
        pipe, results = _run_predict(tmp, overrides)
        torch.cuda.synchronize()
        t_predict = time.perf_counter() - t0
        launches = {"dmv_fused": dmv_cuda.n_launches,
                    "match_fwd": match.n_launches}
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        for split, res in results.items():
            bad = [k for k, v in res.items() if not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"{split}: non-finite {bad}")
        dev_file = os.path.join(tmp, "unnamed_dev.conll")
        with open(dev_file) as f:
            n_sent = f.read().count("\n\n")
        if n_sent != len(pipe.dm.datasets["dev"]):
            raise AssertionError(f"dev predictions: {n_sent} sentences")
        ev = subprocess.run(
            [sys.executable, os.path.join(ROOT, "eval.py"), "--file", dev_file,
             "--dataroot", os.path.join(tmp, "vlparse")],
            capture_output=True, text=True)
        if ev.returncode != 0:
            raise AssertionError(f"eval.py rc {ev.returncode}: {ev.stderr[-2000:]}")
        # eval step at B = 64: dev batches with 64 real sentences
        steps = [t for t, n in zip(pipe.step_times, pipe.step_sizes) if n == 64]
        step_s = statistics.median(steps)

        # the kernels on the main path's own tensors (first dev batch)
        x, _ = next(pipe.dm.batches("dev", shuffle=False))
        xp, _ = pad_batch_pow2(x)
        with torch.no_grad():
            inputs = _to_device(xp, pipe.device)
            out = pipe.model(inputs)
            path_err = _check_dmv_on_path(out, inputs["seq_len"])
            keep, inv = pipe.model._rel_tri_maps(out["vis_packed"][2], pipe.device)
            vis_feat = out["vis_packed"][0][:, keep]
            vb = -1e9 * (1.0 - out["vis_packed"][1][:, keep].float())
            tb = -1e9 * (1.0 - out["txt_packed"][1].float())
            want = match_maxes_plain(vis_feat.bfloat16(),
                                     out["txt_packed"][0].bfloat16(), vb, tb)
            got_logit = out["match_reduced"][0]
            path_err["match_logit"] = float((got_logit - want[0]).abs().max())
            if not close(got_logit, want[0], K5_ATOL, K5_RTOL):
                raise AssertionError(f"K5 on the path: {path_err}")
        emit({"phase": "slice", "corpus_s": round(t_corpus, 3),
              "predict_s": round(t_predict, 3), "launches": launches,
              "results": results, "eval_py_tail": ev.stdout.strip().splitlines()[-1],
              "dev_sentences": n_sent, "path_vs_plain": path_err,
              "eval_step_ms_median_B64": step_s * 1e3,
              "eval_step_ms_B64": [round(t * 1e3, 3) for t in steps],
              "sentences_per_s_B64": 64 / step_s,
              "shape": {"len": "3-49", "B": 64, "P": 36, "feat": 2048}})
        for name, n in launches.items():
            state.setdefault(name, {}).setdefault("launches_by_path", {})[
                "vlgae_predict"] = n
        state["eval_step_ms"] = step_s * 1e3


def phase_reference(state):
    """The card against the CPU on a small corpus at precision=32: the
    port's CUDA path (K1 on the card) and its CPU path (plain versions)
    must write the same dev predictions."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    small = ["datamodule.pad_boxes=6", "_hidden_size=32",
             "_match_hidden_size=16", "_rank=4", "vis_encoder.n_in=16",
             "vis_encoder.n_hidden=32", "trainer.precision=32", "init_seed=0"]
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=8, feat_dim=16,
                    n_box=6, len_range=(3, 12), seed=1)
        files, losses = {}, {}
        for dev in ("cpu", "cuda"):
            _, res = _run_predict(tmp, _corpus_overrides(tmp) + small + [
                f"device={dev}", f"name={dev}"])
            with open(os.path.join(tmp, f"{dev}_dev.conll")) as f:
                files[dev] = f.read()
            losses[dev] = res["dev"]["loss"]
        same = files["cpu"] == files["cuda"]
        rows = [(a.split("\t"), b.split("\t")) for a, b in zip(
            files["cpu"].splitlines(), files["cuda"].splitlines())]
        arcs_same = all(a[:4] == b[:4] for a, b in rows)
        align_same = float(np.mean([a == b for a, b in rows]))
        dloss = abs(losses["cpu"] - losses["cuda"])
        emit({"phase": "reference", "identical_dev_file": same,
              "arcs_identical": arcs_same, "align_rows_identical": align_same,
              "dev_loss": losses, "loss_abs_diff": dloss})
        if not (arcs_same and align_same >= 0.98 and dloss <= 1e-4 * (
                1 + abs(losses["cpu"]))):
            raise AssertionError("the card and the CPU disagree on the small corpus")


NO_DROPOUT = ["encoder.dropout=0", "model.word_encoder.dropout=0",
              "model.dep_model_cfg.head_ff.dropout=0",
              "model.dep_model_cfg.mid_ff.dropout=0"]


def _small_overrides(root):
    return _corpus_overrides(root) + [
        "datamodule.pad_boxes=6", "datamodule.sample_boxes=0", "_hidden_size=32",
        "_match_hidden_size=16", "_rank=4", "vis_encoder.n_in=16",
        "vis_encoder.n_hidden=32", "trainer.precision=32"] + NO_DROPOUT


def phase_train_reference(state):
    """One joint train step from the same weights on the card and on the
    CPU (precision=32, every dropout 0): the loss and every gradient. Where
    a sentence's Viterbi tree is tied, the card's K1 marks every best tree
    while the CPU's plain version splits the gradient; the seed here gives
    tie-free batches, and the tie count is printed."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params, pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=8, feat_dim=16,
                    n_box=6, len_range=(3, 12), seed=1)
        cfg = compose(_small_overrides(tmp))
        res = {}
        for dev in ("cpu", "cuda"):
            dm = build_datamodule(cfg)
            model = build_model(cfg, dm)
            init_params(model, 0)
            pipe = Pipeline(model, dm, cfg, device=dev, workdir=tmp)
            pipe.setup_optimizer()
            x, y = next(dm.batches("train", shuffle=False))
            x, y = pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]
            loss, _ = pipe.grad_step(x, y, False, 0.5)
            with torch.no_grad():
                ind = pipe.model.eval()(
                    {k: torch.as_tensor(v).to(pipe.device) for k, v in x.items()}
                )["dep_reuse"]["max"][2]
            res[dev] = (float(loss), {n: p.grad.detach().cpu() for n, p in
                                      pipe.model.named_parameters() if p.grad is not None},
                        int(((ind.cpu() % 1) != 0).flatten(1).any(1).sum()))
        (lc, gc, ties_c), (lg, gg, _) = res["cpu"], res["cuda"]
        if ties_c:
            raise AssertionError(f"{ties_c} tied Viterbi trees in the reference batch")
        worst, worst_name = 0.0, None
        if sorted(gc) != sorted(gg):
            raise AssertionError("the card and the CPU differ in which params get grads")
        for n in gc:
            err = float((gc[n] - gg[n]).abs().max())
            if err > worst:
                worst, worst_name = err, n
            if not close(gg[n], gc[n], TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL):
                raise AssertionError(f"train step gradient {n}: max err {err}")
        emit({"phase": "train_reference", "loss": {"cpu": lc, "cuda": lg},
              "loss_rel_diff": abs(lc - lg) / abs(lc), "n_params": len(gc),
              "max_grad_abs_err": worst, "worst_param": worst_name,
              "tied_sentences_cpu_split": ties_c,
              "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                            "grad": [TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL]}})
        if abs(lc - lg) > TRAIN_LOSS_RTOL * abs(lc):
            raise AssertionError(f"train step loss: cpu {lc} cuda {lg}")


def phase_train(state):
    """``vlgae_tpu_torch.train`` at the recipe's widths and bf16 on the
    corpus of phase ``slice``: one warm-up and one joint epoch."""
    import json as _json
    import math

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import train
    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048,
                    n_box=36, len_range=(3, 50), seed=0)
        run = os.path.join(tmp, "run")
        overrides = _corpus_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1"
            for s in ("train", "dev", "test")] + [
            "trainer.max_epochs=2", "model.init_epoch=1", f"workdir={run}",
            "init_seed=0", "device=cuda"]
        dmv_cuda.n_launches = match.n_launches = match.n_bwd_launches = 0
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            pipe, test = train.main(overrides)
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {"dmv_fused": dmv_cuda.n_launches, "match_fwd": match.n_launches,
                    "match_bwd": match.n_bwd_launches}
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            lines = [_json.loads(line) for line in f]
        losses = {k: v for rec in lines for k, v in rec.items()
                  if "loss" in k or k.endswith(("nll", "enll", "txt2vis", "vis2txt"))}
        bad = [k for rec in lines for k, v in rec.items()
               if ("loss" in k or k.endswith(("nll", "enll")))
               and not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"non-finite losses: {bad}")
        for name in ("best", "last"):
            if not os.path.exists(os.path.join(run, "checkpoint", f"{name}.pt")):
                raise AssertionError(f"checkpoint {name} was not written")
        ckpt = torch.load(os.path.join(run, "checkpoint", "last.pt"),
                          map_location="cpu", weights_only=True)
        pipe.model.load_state_dict(ckpt["model"], strict=True)
        test_file = os.path.join(run, "test.predict.txt")
        ev = subprocess.run(
            [sys.executable, os.path.join(ROOT, "eval.py"), "--file", test_file,
             "--dataroot", os.path.join(tmp, "vlparse")],
            capture_output=True, text=True)
        if ev.returncode != 0:
            raise AssertionError(f"eval.py rc {ev.returncode}: {ev.stderr[-2000:]}")

        # joint train steps at B = 64, timed on the host clock (upload,
        # forward, backward, update, the loss on the host); the first
        # step's K5 and K6 calls are held against their plain versions
        captured = {}
        orig = {"fwd": match.match_maxes, "bwd": match.match_maxes_bwd}

        def capturing(key):
            def call(*args):
                captured.setdefault(key, tuple(a.detach() for a in args))
                return orig[key](*args)
            return call

        match.match_maxes = capturing("fwd")
        match.match_maxes_bwd = capturing("bwd")
        times = []
        try:
            while len(times) < 7:
                full = [b for b in pipe.dm.batches("train") if len(b[0]["seq_len"]) == 64]
                if not full:
                    raise AssertionError("no training batch of 64 captions")
                for x, y in full[:7 - len(times)]:
                    t0 = time.perf_counter()
                    xp, _ = pad_batch_pow2(x)
                    yp, _ = pad_batch_pow2(y)
                    loss, _ = pipe.train_step(xp, yp, False, 0.5)
                    float(loss)
                    times.append(time.perf_counter() - t0)
        finally:
            match.match_maxes, match.match_maxes_bwd = orig["fwd"], orig["bwd"]
        step_s = statistics.median(times[1:])
        _, k5_err, k5_off = _check_k5(captured["fwd"], False,
                                      "on a joint step's tensors")
        path_err = _check_k6(captured["bwd"], False, "on a joint step's tensors")
        vis, txt, li, lvi = captured["bwd"][:4]
        path_ms = device_ms(lambda: match.match_maxes_bwd_cuda(*captured["bwd"]), n=20)
        path_lists = k6_list_stats(li, lvi)
        emit({"phase": "train", "train_s": round(t_train, 3), "launches": launches,
              "test": test, "epochs": len([r for r in lines if "train/loss" in r]),
              "losses": losses, "eval_py_tail": ev.stdout.strip().splitlines()[-1],
              "k5_on_path": {"max_abs_err": k5_err, "index_mismatch_within_tol": k5_off,
                             "vis": list(captured["fwd"][0].shape),
                             "txt": list(captured["fwd"][1].shape)},
              "k6_on_path": {"max_abs_err": path_err, "vis": list(vis.shape),
                             "txt": list(txt.shape), "device_ms": path_ms,
                             "list_lengths": path_lists},
              "train_step_ms_median_B64": step_s * 1e3,
              "train_step_ms_B64": [round(t * 1e3, 3) for t in times],
              "sentences_per_s_B64": 64 / step_s,
              "shape": {"len": "3-50", "B": 64, "P": 36, "feat": 2048,
                        "precision": "bf16"}})
        for name, n in launches.items():
            state.setdefault(name, {}).setdefault("launches_by_path", {})[
                "vlgae_train"] = n
        state["train_step_ms"] = step_s * 1e3


# n1 of the batches that hold the separate inside/outside kernels against
# their plain versions, by the mapping of dmv_inside.cu they take
INSIDE_GROUPS = {"warp": (2, 3, 5, 9), "smem": (10, 17, 51), "global": (101,)}
TIMED_N1 = (9, 17, 51, 101)


def _ragged(rng, n1, B=64):
    """B lengths in [1, n1-1] with the longest, a one-word sentence and a
    zero-length filler among them (what fits)."""
    import numpy as np

    lengths = rng.integers(1, n1, B) if n1 > 2 else np.ones(B, np.int64)
    lengths[:3] = (n1 - 1, 1, 0)
    if n1 > 86:  # every sentence beyond the shared-memory limit's length
        lengths[3:] = rng.integers(86, n1, B - 3)
    return lengths


def _gout(B, device):
    """A cotangent that is not all ones and has zeros in it; multiples of
    1/8, so that a sum of equal terms is exact in either order."""
    import torch

    g = (torch.arange(B, device=device) % 13 + 1) * 0.125
    g[2::7] = 0.0
    return g


def phase_k2(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused, dmv_inside
    from vlgae_tpu_torch.struct import dmv_total

    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    result = {"phase": "k2", "cases": {}, "timing_B64": {}}
    worst = dict.fromkeys(INSIDE_GROUPS, 0.0)
    for mapping, sizes in INSIDE_GROUPS.items():
        for n1 in sizes:
            lengths = _ragged(rng, n1)
            for kind in ("log", "max"):
                dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
                before = dmv_cuda.n_inside_launches[mapping]
                got = dmv_inside(dec, attach, lens, kind)
                if dmv_cuda.n_inside_launches[mapping] != before + 1:
                    raise AssertionError(f"K2 n1={n1} did not take the {mapping} mapping")
                want = dmv_total(dec, attach, lens, kind)
                fused = dmv_fused(dec, attach, lens, kind)[0]
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                result["cases"][f"n1={n1}/{kind}"] = {
                    "mapping": mapping, "total": err,
                    "vs_fused": float((got - fused).abs().max())}
                worst[mapping] = max(worst[mapping], err)
                ok = (torch.equal(got, want) and torch.equal(got, fused)
                      if kind == "max" else
                      close(got, want, K1_TOTAL_ATOL, K1_TOTAL_RTOL))
                if not ok:
                    emit(result)
                    raise AssertionError(f"K2 n1={n1}/{kind} disagrees: {err}")
            # exact on quarter-integer potentials (ties included)
            dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev, quarter=True)
            if not torch.equal(dmv_inside(dec, attach, lens, "max"),
                               dmv_total(dec, attach, lens, "max")):
                raise AssertionError(f"K2 n1={n1}: max total not exact on quarter-integers")
    for n1 in TIMED_N1:
        lengths = _ragged(rng, n1)
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        timing = {}
        for kind in ("log", "max"):
            timing[kind] = {
                "ms": device_ms(lambda: dmv_inside(dec, attach, lens, kind)),
                "call_ms": time_ms(lambda: dmv_inside(dec, attach, lens, kind)),
                "plain_ms": time_ms(lambda: dmv_total(dec, attach, lens, kind),
                                    reps=3, warmup=1),
                "fused_ms": device_ms(lambda: dmv_fused(dec, attach, lens, kind))}
        result["timing_B64"][f"n1={n1}"] = {
            **timing, **dmv_bound(lengths, n1, "inside"),
            "dependent_steps": 2 * (n1 - 1)}
    result["tolerance"] = {"total": [K1_TOTAL_ATOL, K1_TOTAL_RTOL], "max": "exact"}
    emit(result)
    for name, mapping, n1 in (("dmv_inside", "smem", 51), ("dmv_inside_small", "warp", 9),
                              ("dmv_inside_long", "global", 101)):
        t = result["timing_B64"][f"n1={n1}"]
        # the recipe trains and evaluates in the max semiring (Viterbi)
        state[name] = {
            "max_abs_err": worst[mapping], "ms": t["max"]["ms"],
            "plain_ms": t["max"]["plain_ms"], "library_ms": None,
            "ms_log": t["log"]["ms"], "call_ms": t["max"]["call_ms"], "timed_at": {"B": 64, "n1": n1, "kind": "max"},
            **{k: t[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops",
                                 "dependent_steps")}}


def phase_k3(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused, dmv_inside_save, dmv_outside
    from vlgae_tpu_torch.struct import dmv_inside_charts_plain, dmv_outside_plain

    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    result = {"phase": "k3", "cases": {}, "timing_B64": {}}
    worst = {"charts": 0.0, "outside": 0.0}
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for mapping, sizes in INSIDE_GROUPS.items():
        for n1 in sizes:
            lengths = _ragged(rng, n1)
            gout = _gout(len(lengths), dev)
            for kind in ("log", "max"):
                dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
                before = dmv_cuda.n_inside_save_launches[mapping]
                total, charts = dmv_inside_save(dec, attach, lens, kind)
                if dmv_cuda.n_inside_save_launches[mapping] != before + 1:
                    raise AssertionError(f"K3a n1={n1} did not take the {mapping} mapping")
                p_total, p_charts = dmv_inside_charts_plain(dec, attach, lens, kind)
                off = p_charts == -1e12
                got = dmv_outside(dec, attach, lens, gout, total, charts, kind)
                again = dmv_outside(dec, attach, lens, gout, total, charts, kind)
                on_plain = dmv_outside(dec, attach, lens, gout, p_total,
                                       p_charts.contiguous(), kind)
                want = dmv_outside_plain(dec, attach, lens, gout, total, charts, kind)
                _, fd, fa = dmv_fused(dec, attach, lens, kind)
                fused = (gout.view(-1, 1, 1, 1, 1) * fd, gout.view(-1, 1, 1, 1) * fa)
                torch.cuda.synchronize()
                errs = {
                    "mapping": mapping,
                    "total": float((total - p_total).abs().max()),
                    "charts": float((charts[~off] - p_charts[~off]).abs().max()),
                    "outside": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                    "outside_on_plain_charts": max(
                        float((g - w).abs().max()) for g, w in zip(on_plain, want)),
                    "pair_vs_fused": max(
                        float((g - f).abs().max()) for g, f in zip(got, fused))}
                result["cases"][f"n1={n1}/{kind}"] = errs
                worst["charts"] = max(worst["charts"], errs["charts"])
                worst["outside"] = max(worst["outside"], errs["outside"])
                exact = kind == "max"
                same = (lambda a, b, at, rt: torch.equal(a, b) if exact  # noqa: E731
                        else close(a, b, at, rt))
                ok = (bool((charts[off] == -1e12).all())
                      and same(total, p_total, K1_TOTAL_ATOL, K1_TOTAL_RTOL)
                      and same(charts[~off], p_charts[~off], K1_TOTAL_ATOL, K1_TOTAL_RTOL)
                      and all(same(g, w, K1_GRAD_ATOL, K1_GRAD_RTOL)
                              and same(p, w, K1_GRAD_ATOL, K1_GRAD_RTOL)
                              and same(g, f, K1_GRAD_ATOL, K1_GRAD_RTOL)
                              and torch.equal(bits(g), bits(a))
                              for g, a, p, w, f in zip(got, again, on_plain, want, fused))
                      and all(bool((g[gout == 0] == 0).all()) for g in got))
                if not ok:
                    emit(result)
                    raise AssertionError(f"K3 n1={n1}/{kind} disagrees: {errs}")
            # quarter-integers tie often: the pair must mark every best tree
            # as K1 does (the plain version splits ties, so it is no judge)
            dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev, quarter=True)
            total, charts = dmv_inside_save(dec, attach, lens, "max")
            got = dmv_outside(dec, attach, lens, gout, total, charts, "max")
            ft, fd, fa = dmv_fused(dec, attach, lens, "max")
            if not (torch.equal(total, ft)
                    and torch.equal(got[0], gout.view(-1, 1, 1, 1, 1) * fd)
                    and torch.equal(got[1], gout.view(-1, 1, 1, 1) * fa)):
                raise AssertionError(f"K3 n1={n1}: the pair and K1 differ on tied trees")
    for n1 in TIMED_N1:
        lengths = _ragged(rng, n1)
        gout = _gout(len(lengths), dev)
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        timing = {}
        for kind in ("log", "max"):
            total, charts = dmv_inside_save(dec, attach, lens, kind)
            timing[kind] = {
                "save_ms": device_ms(lambda: dmv_inside_save(dec, attach, lens, kind)),
                "outside_ms": device_ms(
                    lambda: dmv_outside(dec, attach, lens, gout, total, charts, kind)),
                "fused_ms": device_ms(lambda: dmv_fused(dec, attach, lens, kind)),
                "save_call_ms": time_ms(
                    lambda: dmv_inside_save(dec, attach, lens, kind)),
                "outside_call_ms": time_ms(
                    lambda: dmv_outside(dec, attach, lens, gout, total, charts, kind)),
                "fused_call_ms": time_ms(lambda: dmv_fused(dec, attach, lens, kind)),
                "save_plain_ms": time_ms(
                    lambda: dmv_inside_charts_plain(dec, attach, lens, kind),
                    reps=3, warmup=1),
                "outside_plain_ms": time_ms(
                    lambda: dmv_outside_plain(dec, attach, lens, gout, total, charts, kind),
                    reps=3, warmup=1)}
            timing[kind]["pair_ms"] = timing[kind]["save_ms"] + timing[kind]["outside_ms"]
        result["timing_B64"][f"n1={n1}"] = {
            **timing, "save_bound": dmv_bound(lengths, n1, "save"),
            "outside_bound": dmv_bound(lengths, n1, "outside"),
            "fused_bound": dmv_bound(lengths, n1, "fused"),
            "dependent_steps": {"save": 2 * (n1 - 1), "outside": 2 * (n1 - 1)}}
    result["tolerance"] = {"total_and_charts": [K1_TOTAL_ATOL, K1_TOTAL_RTOL],
                           "grads": [K1_GRAD_ATOL, K1_GRAD_RTOL], "max": "exact"}
    emit(result)
    t = result["timing_B64"]["n1=51"]
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_ops")
    state["dmv_inside_save"] = {
        "max_abs_err": worst["charts"], "ms": t["max"]["save_ms"],
        "plain_ms": t["max"]["save_plain_ms"], "library_ms": None,
        "ms_log": t["log"]["save_ms"], "timed_at": {"B": 64, "n1": 51, "kind": "max"},
        **{k: t["save_bound"][k] for k in keys}, "dependent_steps": 100}
    state["dmv_outside"] = {
        "max_abs_err": worst["outside"], "ms": t["max"]["outside_ms"],
        "plain_ms": t["max"]["outside_plain_ms"], "library_ms": None,
        "ms_log": t["log"]["outside_ms"], "timed_at": {"B": 64, "n1": 51, "kind": "max"},
        **{k: t["outside_bound"][k] for k in keys}, "dependent_steps": 100}
    # the warp and the global mapping serve both inside functions: their
    # rows keep the value-only time and add the chart-saving one
    for name, n1 in (("dmv_inside_small", 9), ("dmv_inside_long", 101)):
        state[name]["save_ms"] = result["timing_B64"][f"n1={n1}"]["max"]["save_ms"]


def _lang_overrides(root, small):
    ov = _corpus_overrides(root)
    ov[0] = "exp=lang_only"
    if small:
        ov += ["_hidden_size=32", "_rank=4", "encoder.hidden_size=16",
               "model.root_emb_dim=8", "model.dec_emb_dim=8", "trainer.precision=32",
               "datamodule.max_len.train=12",
               "datamodule.train_dataloader.num_bucket=1"]
    return ov


# images of the lang_only corpus: ``max_len.train: 10`` keeps about one
# training caption in seven, and full batches of 64 are wanted at both
# padded lengths
LANG_N_IMGS = 1000
LANG_NO_DROPOUT = ["_dropout=0", "encoder.lstm_dropout=0", "encoder.pre_dropout=0",
                   "encoder.pre_shared_dropout=0", "encoder.post_dropout=0",
                   "encoder.post_shared_dropout=0"]


def phase_lang_only_reference(state):
    """``exp=lang_only`` at small widths and precision=32, the card (K2/K4,
    K1-max, the K3 pair) against the CPU (plain versions): the same dev
    predictions, and the same NLL train step from the same weights with
    every dropout 0 (loss and every gradient). Where a sentence's Viterbi
    tree is tied the card marks every best tree and the CPU splits; the seed
    gives a tie-free training batch, and the tie count is checked."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params, pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=8, feat_dim=4, n_box=3,
                    len_range=(3, 12), seed=1)
        files, losses = {}, {}
        for dev in ("cpu", "cuda"):
            _, res = _run_predict(tmp, _lang_overrides(tmp, True) + [
                "init_seed=0", f"device={dev}", f"name={dev}"])
            with open(os.path.join(tmp, f"{dev}_dev.conll")) as f:
                files[dev] = f.read()
            losses[dev] = res["dev"]["loss"]
        dloss = abs(losses["cpu"] - losses["cuda"])
        cfg = compose(_lang_overrides(tmp, True) + LANG_NO_DROPOUT)
        res = {}
        for dev in ("cpu", "cuda"):
            dm = build_datamodule(cfg)
            model = build_model(cfg, dm)
            init_params(model, 0)
            pipe = Pipeline(model, dm, cfg, device=dev, workdir=tmp)
            pipe.setup_optimizer()
            x, y = next(dm.batches("train", shuffle=False))
            x, y = pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]
            loss, _ = pipe.grad_step(x, y, False, 0.5)
            grads = {n: p.grad.detach().cpu() for n, p in pipe.model.named_parameters()
                     if p.grad is not None}
            ties = 0
            if dev == "cpu":
                with torch.no_grad():
                    inputs = {k: torch.as_tensor(v) for k, v in x.items()}
                    out = pipe.model.eval()(inputs)
                    ind = dmv_value_and_grads_plain(
                        out["merged_dec"], out["merged_attach"], inputs["seq_len"], "max")[2]
                ties = int(((ind % 1) != 0).flatten(1).any(1).sum())
            res[dev] = (float(loss), grads, ties)
        (lc, gc, ties), (lg, gg, _) = res["cpu"], res["cuda"]
        worst, worst_name = 0.0, None
        for n in gc:
            err = float((gc[n] - gg[n]).abs().max())
            if err > worst:
                worst, worst_name = err, n
        emit({"phase": "lang_only_reference",
              "identical_dev_file": files["cpu"] == files["cuda"],
              "dev_loss": losses, "loss_abs_diff": dloss,
              "train_loss": {"cpu": lc, "cuda": lg},
              "train_loss_rel_diff": abs(lc - lg) / abs(lc), "n_params": len(gc),
              "max_grad_abs_err": worst, "worst_param": worst_name,
              "tied_sentences_cpu_split": ties,
              "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                            "grad": [TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL]}})
        if files["cpu"] != files["cuda"] or dloss > 1e-4 * (1 + abs(losses["cpu"])):
            raise AssertionError("lang_only: the card and the CPU predict differently")
        if ties:
            raise AssertionError(f"{ties} tied Viterbi trees in the reference batch")
        if sorted(gc) != sorted(gg):
            raise AssertionError("the card and the CPU differ in which params get grads")
        for n in gc:
            if not close(gg[n], gc[n], TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL):
                raise AssertionError(f"lang_only train step gradient {n}")
        if abs(lc - lg) > TRAIN_LOSS_RTOL * abs(lc):
            raise AssertionError(f"lang_only train step loss: cpu {lc} cuda {lg}")


def _check_lang_batch(pipe, x, train):
    """The DMV kernels on one batch's own potentials (max semiring, as the
    recipe trains and decodes) against their plain versions. The potentials
    of a real batch tie, so the indicator tables are held to the plain
    version's on the untied sentences and to its support on all, and the
    pair to K1 exactly."""
    import torch

    from vlgae_tpu_torch.ops.dmv_cuda import (dmv_fused, dmv_inside, dmv_inside_save,
                                              dmv_outside)
    from vlgae_tpu_torch.struct import (dmv_inside_charts_plain, dmv_total,
                                        dmv_value_and_grads_plain)
    from vlgae_tpu_torch.training.pipeline import _to_device

    with torch.no_grad():
        inputs = _to_device(x, pipe.device)
        out = pipe.model.eval()(inputs)
    dec, attach, lens = out["merged_dec"], out["merged_attach"], inputs["seq_len"]
    want_total, want_gd, want_ga = dmv_value_and_grads_plain(dec, attach, lens, "max")
    tied = ((want_ga % 1) != 0).flatten(1).any(1)
    errs = {"n1": int(dec.shape[1]), "B": int(dec.shape[0]),
            "tied_sentences": int(tied.sum())}

    def same_tables(got_d, got_a, scale):
        for g, w in ((got_d, want_gd), (got_a, want_ga)):
            sc = scale.view(-1, *([1] * (g.dim() - 1)))
            if not bool(((g != 0) == ((w * sc) != 0)).all()):
                return False
            if not torch.equal(g[~tied], (w * sc)[~tied]):
                return False
        return True

    if train:
        gout = torch.where(lens > 0, -torch.ones_like(want_total), 0.0)
        total, charts = dmv_inside_save(dec, attach, lens, "max")
        p_total, p_charts = dmv_inside_charts_plain(dec, attach, lens, "max")
        off = p_charts == -1e12
        gd, ga = dmv_outside(dec, attach, lens, gout, total, charts, "max")
        _, fd, fa = dmv_fused(dec, attach, lens, "max")
        ok = (torch.equal(total, p_total) and torch.equal(charts[~off], p_charts[~off])
              and bool((charts[off] == -1e12).all()) and same_tables(gd, ga, gout)
              and torch.equal(gd, gout.view(-1, 1, 1, 1, 1) * fd)
              and torch.equal(ga, gout.view(-1, 1, 1, 1) * fa))
    else:
        total = dmv_inside(dec, attach, lens, "max")
        _, fd, fa = dmv_fused(dec, attach, lens, "max")
        ok = (torch.equal(total, dmv_total(dec, attach, lens, "max"))
              and torch.equal(total, want_total)
              and same_tables(fd, fa, torch.ones_like(total)))
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"lang_only: a DMV kernel disagrees on a batch's tensors: {errs}")
    return errs


def phase_lang_only(state):
    """``exp=lang_only`` at the recipe's widths (BiLSTM 2 x 200, scorer
    hidden 500, rank 32, word + tag 100-d, 200 lexicalised words, batch 64,
    training captions up to 10 words, Viterbi training) through the port's
    ``train`` and ``predict`` entry points. The corpus has many more images
    than phase ``slice``'s because ``max_len.train: 10`` keeps about one
    training caption in seven; its region features are tiny, as the recipe
    reads none."""
    import json as _json
    import math

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import train
    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    def counts():
        c = dmv_cuda.launch_counts()
        return {"dmv_fused": c["fused"], "dmv_inside": c["inside"]["smem"],
                "dmv_inside_save": c["inside_save"]["smem"],
                "dmv_outside": c["outside"],
                "dmv_inside_small": c["inside"]["warp"] + c["inside_save"]["warp"],
                "dmv_inside_long": c["inside"]["global"] + c["inside_save"]["global"],
                "match_fwd": match.n_launches, "match_bwd": match.n_bwd_launches}

    def reset():
        dmv_cuda.reset_launch_counts()
        match.n_launches = match.n_bwd_launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=LANG_N_IMGS, feat_dim=4,
                    n_box=3, len_range=(3, 50), seed=0)
        t_corpus = time.perf_counter() - t0
        run = os.path.join(tmp, "run")
        overrides = _lang_overrides(tmp, False) + [
            "trainer.max_epochs=2", "model.init_epoch=1", f"workdir={run}",
            "init_seed=0", "device=cuda"]
        reset()
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            pipe, test = train.main(overrides)
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        raw = dmv_cuda.launch_counts()
        launches = counts()
        n_save, n_value = sum(raw["inside_save"].values()), sum(raw["inside"].values())
        # training: the chart-saving inside and the outside, once per NLL
        # step, tiny charts (L = 8) through the warp mapping and L = 16
        # through the block mapping; evaluation: the value-only inside for
        # the loss and K1 (max) for the decode, once per step; no matching
        if not (n_save == raw["outside"] > 0 and raw["inside_save"]["warp"] > 0
                and raw["inside_save"]["smem"] > 0 and raw["inside_save"]["global"] == 0
                and n_value == raw["fused"] > 0 and raw["inside"]["warp"] > 0
                and raw["inside"]["smem"] > 0
                and launches["match_fwd"] == launches["match_bwd"] == 0):
            raise AssertionError(f"lang_only train: unexpected launches {raw}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            lines = [_json.loads(line) for line in f]
        losses = {k: v for rec in lines for k, v in rec.items()
                  if "loss" in k or k.endswith(("nll", "enll"))}
        bad = [k for rec in lines for k, v in rec.items()
               if ("loss" in k or k.endswith(("nll", "enll")))
               and not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"lang_only: non-finite losses: {bad}")
        if not any(r.get("mid_epoch") for r in lines):
            raise AssertionError("lang_only: no mid-epoch validation ran")
        ckpt = torch.load(os.path.join(run, "checkpoint", "last.pt"),
                          map_location="cpu", weights_only=True)
        pipe.model.load_state_dict(ckpt["model"], strict=True)

        # NLL train steps at B = 64 on the host clock (upload, forward,
        # backward, update, the loss on the host), by padded length. The
        # recipe's sampler cuts a length bucket into equal batches of at most
        # 64, so a batch of exactly 64 is collated here from the training set
        ds = pipe.dm.datasets["train"]
        sizes = sorted({len(x["seq_len"]) for x, _ in pipe.dm.batches("train")})
        by_len = {}
        for L, keep in ((8, lambda n: n <= 8), (16, lambda n: n > 8)):
            insts = [i for i in ds if keep(i["seq_len"])]
            if len(insts) < 128:
                raise AssertionError(f"lang_only: {len(insts)} training captions at L={L}")
            by_len[L] = [pipe.dm.collate("train", insts[k:k + 64], L) for k in (0, 64)]
        train_ms, path_checks = {}, {}
        for L, full in by_len.items():
            reset()
            times = []
            for k in range(7):
                x, y = full[k % len(full)]
                t0 = time.perf_counter()
                xp, _ = pad_batch_pow2(x)
                yp, _ = pad_batch_pow2(y)
                loss, _ = pipe.train_step(xp, yp, False, 0.5)
                float(loss)
                times.append(time.perf_counter() - t0)
            c = dmv_cuda.launch_counts()
            mapping = "warp" if L + 1 <= 9 else "smem"
            if not (c["fused"] == 0 and c["inside_save"][mapping] == 7 == c["outside"]
                    and sum(c["inside_save"].values()) == 7
                    and sum(c["inside"].values()) == 0):
                raise AssertionError(f"lang_only train step at L={L}: launches {c}")
            train_ms[f"L={L}"] = {"median": statistics.median(times[1:]) * 1e3,
                                  "all": [round(t * 1e3, 3) for t in times]}
            path_checks[f"train_L={L}"] = _check_lang_batch(
                pipe, pad_batch_pow2(full[0][0])[0], train=True)

        # eval steps at B = 64 over the dev batches, and the launches of one
        reset()
        pipe.evaluate("dev")
        c = dmv_cuda.launch_counts()
        n_steps = len(pipe.step_times)
        if not (c["fused"] == n_steps == sum(c["inside"].values())
                and sum(c["inside_save"].values()) == 0 == c["outside"]):
            raise AssertionError(f"lang_only eval: launches {c} over {n_steps} steps")
        # dev batches that pad to 64 rows (the sampler's equal cuts hold 33-64)
        full = [(t, n) for t, n in zip(pipe.step_times, pipe.step_sizes) if n > 32]
        steps = [t for t, _ in full]
        eval_s = statistics.median(steps)
        eval_sent_s = statistics.median(n / t for t, n in full)
        x, _ = next(pipe.dm.batches("dev", shuffle=False))
        path_checks["eval"] = _check_lang_batch(pipe, pad_batch_pow2(x)[0], train=False)

        # predict from the checkpoint: dev and test files
        reset()
        t0 = time.perf_counter()
        ppipe, results = _run_predict(tmp, [
            f"checkpoint={os.path.join(run, 'checkpoint', 'last.pt')}", "device=cuda"])
        torch.cuda.synchronize()
        t_predict = time.perf_counter() - t0
        predict_launches = counts()
        for split in ("dev", "test"):
            with open(os.path.join(tmp, f"unnamed_{split}.conll")) as f:
                n_sent = f.read().count("\n\n")
            if n_sent != len(ppipe.dm.datasets[split]) or not math.isfinite(
                    float(results[split]["loss"])):
                raise AssertionError(f"lang_only predict {split}: {n_sent} sentences")

    # captions beyond the shared-memory limit (n1 > 85): the same entry
    # point on a small corpus of 86-99 word captions, weights from a seed
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=16, feat_dim=4, n_box=3,
                    len_range=(86, 100), seed=2)
        reset()
        _, long_results = _run_predict(tmp, _lang_overrides(tmp, False) + [
            "datamodule.max_len.train=100", "init_seed=0", "device=cuda"])
        torch.cuda.synchronize()
        long_launches = counts()
        if not (long_launches["dmv_inside_long"] > 0
                and all(math.isfinite(float(r["loss"])) for r in long_results.values())):
            raise AssertionError(f"lang_only long captions: {long_launches}")

    emit({"phase": "lang_only", "corpus_s": round(t_corpus, 3),
          "train_s": round(t_train, 3), "predict_s": round(t_predict, 3),
          "launches_train": launches, "launches_by_mapping_train": raw,
          "launches_predict": predict_launches,
          "launches_long_predict": long_launches,
          "test": test, "predict": {k: results[k] for k in ("dev", "test")},
          "uas": {"test_after_training": test["uas"],
                  "long_captions_random_weights": long_results["dev"]["uas"]},
          "epochs": len([r for r in lines if "train/loss" in r]), "losses": losses,
          "kernels_on_batches": path_checks,
          "train_step_ms_B64": train_ms,
          "train_captions": len(ds), "train_batch_sizes_of_the_sampler": sizes,
          "eval_step_ms_median_B64": eval_s * 1e3,
          "eval_step_ms_B64": [round(t * 1e3, 3) for t in steps],
          "eval_real_sentences_B64": [n for _, n in full],
          "sentences_per_s_B64": {"train_L=8": 64e3 / train_ms["L=8"]["median"],
                                  "train_L=16": 64e3 / train_ms["L=16"]["median"],
                                  "eval": eval_sent_s},
          "shape": {"len": "3-49 (training captions up to 10)", "B": 64,
                    "lstm": "2 x 200", "hidden": 500, "rank": 32}})
    for name in KERNELS:
        by_path = {"lang_only_train": launches[name],
                   "lang_only_predict": predict_launches[name],
                   "lang_only_long_predict": long_launches[name]}
        state.setdefault(name, {}).setdefault("launches_by_path", {}).update(by_path)


def _vit_overrides(root):
    """``exp=vlgae_vit`` on the corpus under ``root``, at bf16 as
    ``exp=vlgae``: the recipe's file sets no precision and so composes the
    trainer's default 32, where the matching is an f32 stream in plain
    PyTorch and neither K5 nor K6 runs."""
    ov = _corpus_overrides(root)
    ov[0] = "exp=vlgae_vit"
    return ov + ["trainer.precision=bf16"]


# the narrow ViT of tests/test_e2e.py::test_vlgae_vit_swap_e2e, and the
# recipe's (configs/exp/vlgae_vit.yaml)
VIT_NARROW = {"hidden_size": 16, "num_hidden_layers": 1, "num_attention_heads": 2,
              "intermediate_size": 32, "image_size": 32, "patch_size": 16}
VIT_RECIPE = {"hidden_size": 192, "num_hidden_layers": 4, "num_attention_heads": 4,
              "intermediate_size": 384, "image_size": 224, "patch_size": 32}


def vit_width_overrides(dims):
    return [f"datamodule.vit_image_size={dims['image_size']}",
            f"datamodule.vit_patch_size={dims['patch_size']}",
            f"vis_encoder.vit_hidden_size={dims['hidden_size']}",
            f"vis_encoder.vit_num_layers={dims['num_hidden_layers']}",
            f"vis_encoder.vit_num_heads={dims['num_attention_heads']}",
            f"vis_encoder.vit_intermediate_size={dims['intermediate_size']}"]


def write_vit_npz(path, dims, seed):
    """Random ViT backbone weights as the ``.npz`` of ``/``-joined flax
    paths that ``vis_encoder.vit_weights`` reads: every tensor N(0, 0.02),
    LayerNorm scales about 1. Returns the flat arrays."""
    import numpy as np

    from vlgae_tpu_torch import convert
    from vlgae_tpu_torch.models.vis_encoder import ViTConfig, ViTModel

    rng = np.random.default_rng(seed)
    shapes = convert.torch_to_flax(ViTModel(ViTConfig(**dims)).state_dict())
    flat = {k: (rng.standard_normal(v.shape) * 0.02 + k.endswith("scale")).astype(np.float32)
            for k, v in sorted(shapes.items())}
    np.savez(path, **flat)
    return flat


def vit_unchanged(model, flat):
    """Whether ``model``'s ViT backbone holds exactly the arrays ``flat``."""
    import numpy as np

    from vlgae_tpu_torch import convert

    got = convert.torch_to_flax(model.vis_encoder.vit.state_dict())
    return sorted(got) == sorted(flat) and all(np.array_equal(got[k], v)
                                               for k, v in flat.items())


def phase_vit_reference(state):
    """``exp=vlgae_vit`` at small widths and precision=32, the backbone's
    weights from an .npz on both sides: the card and the CPU write the same
    dev predictions, and take the same joint train step from the same
    weights with every dropout 0 (loss and every gradient; the frozen ViT
    gets none). The seed gives a tie-free training batch."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params, pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=8, feat_dim=16, n_box=6,
                    len_range=(3, 12), seed=1, image_size=VIT_NARROW["image_size"])
        npz = os.path.join(tmp, "vit.npz")
        flat = write_vit_npz(npz, VIT_NARROW, seed=1)
        ov = (_vit_overrides(tmp) + vit_width_overrides(VIT_NARROW) + [
            "_hidden_size=32", "_match_hidden_size=16", "_rank=4",
            "trainer.precision=32", f"vis_encoder.vit_weights={npz}"])
        files, losses = {}, {}
        for dev in ("cpu", "cuda"):
            pipe, res = _run_predict(tmp, ov + ["init_seed=0", f"device={dev}",
                                                f"name={dev}"])
            if not vit_unchanged(pipe.model, flat):
                raise AssertionError(f"vit_reference: the .npz did not reach the {dev} model")
            with open(os.path.join(tmp, f"{dev}_dev.conll")) as f:
                files[dev] = f.read()
            losses[dev] = res["dev"]["loss"]
        dloss = abs(losses["cpu"] - losses["cuda"])
        cfg = compose(ov + ["datamodule.train_dataloader.num_bucket=1"] + NO_DROPOUT)
        res = {}
        for dev in ("cpu", "cuda"):
            dm = build_datamodule(cfg)
            model = build_model(cfg, dm)
            init_params(model, 0)
            pipe = Pipeline(model, dm, cfg, device=dev, workdir=tmp)
            pipe.setup_optimizer()
            x, y = next(dm.batches("train", shuffle=False))
            x, y = pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]
            loss, _ = pipe.grad_step(x, y, False, 0.5)
            with torch.no_grad():
                ind = pipe.model.eval()(
                    {k: torch.as_tensor(v).to(pipe.device) for k, v in x.items()}
                )["dep_reuse"]["max"][2]
            grads = {n: p.grad.detach().cpu() for n, p in pipe.model.named_parameters()
                     if p.grad is not None}
            res[dev] = (float(loss), grads, int(((ind.cpu() % 1) != 0).flatten(1).any(1).sum()))
        (lc, gc, ties), (lg, gg, _) = res["cpu"], res["cuda"]
        worst, worst_name = 0.0, None
        for n in gc.keys() & gg.keys():
            err = float((gc[n] - gg[n]).abs().max())
            if err > worst:
                worst, worst_name = err, n
        emit({"phase": "vit_reference", "identical_dev_file": files["cpu"] == files["cuda"],
              "dev_loss": losses, "loss_abs_diff": dloss,
              "train_loss": {"cpu": lc, "cuda": lg},
              "train_loss_rel_diff": abs(lc - lg) / abs(lc), "n_params": len(gc),
              "max_grad_abs_err": worst, "worst_param": worst_name,
              "tied_sentences_cpu_split": ties,
              "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                            "grad": [TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL]}})
        if files["cpu"] != files["cuda"] or dloss > 1e-4 * (1 + abs(losses["cpu"])):
            raise AssertionError("vit: the card and the CPU predict differently")
        if ties:
            raise AssertionError(f"{ties} tied Viterbi trees in the reference batch")
        if sorted(gc) != sorted(gg) or any(".vit." in f".{n}" for n in gc):
            raise AssertionError("vit: the params that get grads differ or include the ViT")
        for n in gc:
            if not close(gg[n], gc[n], TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL):
                raise AssertionError(f"vit train step gradient {n}")
        if abs(lc - lg) > TRAIN_LOSS_RTOL * abs(lc):
            raise AssertionError(f"vit train step loss: cpu {lc} cuda {lg}")


def phase_vit(state):
    """``exp=vlgae_vit`` at the recipe's widths through ``train`` and
    ``predict``: 104 images of 224 x 224 pixels (520/260/260 captions of
    3-63 words), the ViT's weights from an .npz drawn from a seed (random,
    as the recipe's ``vit_weights: null``), bf16, batch 64."""
    import json as _json
    import math

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import patch_roi_boxes, train
    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused
    from vlgae_tpu_torch.training.pipeline import _to_device, pad_batch_pow2

    def reset():
        dmv_cuda.reset_launch_counts()
        match.n_launches = match.n_bwd_launches = 0
        match.n_launches_by_q_chunks.clear()

    def counts():
        return {"dmv_fused": dmv_cuda.n_launches,
                "dmv_fused_global": dmv_cuda.n_fused_global_launches,
                "match_fwd": match.n_launches,
                "match_fwd_two_q_chunks": match.n_launches_by_q_chunks.get(2, 0),
                "match_bwd": match.n_bwd_launches}

    # the (V, Q) of every K5 call, to show which shapes the path reached
    shapes = set()
    orig = {"fwd": match.match_maxes, "bwd": match.match_maxes_bwd}

    def recording(vis, txt, vb, tb):
        shapes.add((int(vis.shape[1]), int(txt.shape[1])))
        return orig["fwd"](vis, txt, vb, tb)

    def check_eval(root, pred_file):
        ev = subprocess.run(
            [sys.executable, os.path.join(ROOT, "eval.py"), "--file", pred_file,
             "--dataroot", root], capture_output=True, text=True)
        if ev.returncode != 0:
            raise AssertionError(f"eval.py rc {ev.returncode}: {ev.stderr[-2000:]}")
        return ev.stdout.strip().splitlines()[-1]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=104, feat_dim=2048, n_box=36, len_range=(3, 64),
                    image_size=VIT_RECIPE["image_size"], seed=0)
        npz = os.path.join(tmp, "vit.npz")
        vit_flat = write_vit_npz(npz, VIT_RECIPE, seed=0)
        t_corpus = time.perf_counter() - t0
        run = os.path.join(tmp, "run")
        overrides = _vit_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1"
            for s in ("train", "dev", "test")] + [
            "trainer.max_epochs=2", "model.init_epoch=1", f"workdir={run}",
            f"vis_encoder.vit_weights={npz}", "init_seed=0", "device=cuda"]
        reset()
        match.match_maxes = recording
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            pipe, test = train.main(overrides)
        finally:
            os.chdir(cwd)
            match.match_maxes = orig["fwd"]
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = counts()
        train_shapes = sorted(shapes)
        if not all(launches.values()):
            raise AssertionError(f"vit train: a kernel or mapping never launched: {launches}")
        if (VIT_V["train"], VIT_Q) not in shapes:
            raise AssertionError(f"vit train: K5 never ran at V={VIT_V['train']}, "
                                 f"Q={VIT_Q}: {train_shapes}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            lines = [_json.loads(line) for line in f]
        losses = {k: v for rec in lines for k, v in rec.items()
                  if "loss" in k or k.endswith(("nll", "enll", "txt2vis", "vis2txt"))}
        bad = [k for rec in lines for k, v in rec.items()
               if ("loss" in k or k.endswith(("nll", "enll")))
               and not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"vit: non-finite losses: {bad}")
        last = os.path.join(run, "checkpoint", "last.pt")
        ckpt = torch.load(last, map_location="cpu", weights_only=True)
        pipe.model.load_state_dict(ckpt["model"], strict=True)
        # the frozen backbone: the .npz's arrays, bit for bit, after training
        if not vit_unchanged(pipe.model, vit_flat):
            raise AssertionError("vit: the frozen ViT changed in training")
        patch_roi_boxes.main(["--dataroot", root, "--split", "val",
                              "--image-size", str(VIT_RECIPE["image_size"]),
                              "--patch-size", str(VIT_RECIPE["patch_size"])])
        eval_dev = check_eval(root, os.path.join(run, "dev.predict.txt"))

        # joint train steps at B = 64 on the host clock; the first step's K5
        # and K6 calls are held against their plain versions
        captured = {}

        def capturing(key):
            def call(*args):
                captured.setdefault(key, tuple(a.detach() for a in args))
                return orig[key](*args)
            return call

        full = [b for b in pipe.dm.batches("train") if len(b[0]["seq_len"]) == 64][:7]
        if len(full) < 2:
            raise AssertionError("vit: fewer than two training batches of 64 captions")
        full = [(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]) for x, y in full]
        match.match_maxes, match.match_maxes_bwd = capturing("fwd"), capturing("bwd")
        reset()
        times = []
        try:
            for k in range(7):
                x, y = full[k % len(full)]
                t0 = time.perf_counter()
                loss, _ = pipe.train_step(x, y, False, 0.5)
                float(loss)
                times.append(time.perf_counter() - t0)
        finally:
            match.match_maxes, match.match_maxes_bwd = orig["fwd"], orig["bwd"]
        per_step = {k: v / 7 for k, v in counts().items()}
        step_s = statistics.median(times[1:])
        k5_args, k6_args = captured["fwd"], captured["bwd"]
        on_path = {"padded_len": [int(x["word"].shape[1]) for x, _ in full],
                   "vis": list(k5_args[0].shape), "txt": list(k5_args[1].shape)}
        _, on_path["k5_max_abs_err"], on_path["k5_index_mismatch_within_tol"] = _check_k5(
            k5_args, False, "on a vlgae_vit joint step's tensors")
        on_path["k6_max_abs_err"] = _check_k6(k6_args, False,
                                              "on a vlgae_vit joint step's tensors")
        on_path["k5_device_ms"] = device_ms(lambda: match.match_maxes_cuda(*k5_args), n=10)
        on_path["k6_device_ms"] = device_ms(lambda: match.match_maxes_bwd_cuda(*k6_args),
                                            n=20)
        on_path["k6_list_lengths"] = k6_list_stats(*k6_args[2:4])
        # K1 on the potentials of a training batch (eval forward): n1 = 65
        x = next(b for b, _ in full if b["word"].shape[1] + 1 == 65)
        with torch.no_grad():
            inputs = _to_device(x, pipe.device)
            g0 = dmv_cuda.n_fused_global_launches
            out = pipe.model.eval()(inputs)
            on_path["k1"] = _check_dmv_on_path(out, inputs["seq_len"])
            if dmv_cuda.n_fused_global_launches != g0 + 2:
                raise AssertionError("vit: K1 at n1 = 65 did not take global scratch")
            dec, attach, lens = out["merged_dec"], out["merged_attach"], inputs["seq_len"]
            on_path["k1_device_ms"] = {kind: device_ms(lambda: dmv_fused(dec, attach, lens, kind))
                                       for kind in ("log", "max")}
            # the frozen ViT's forward and the pageable upload of the pixels
            px = inputs["vis_pixels"]
            vit_ms = device_ms(lambda: pipe.model.vis_encoder.vit(px), n=10)
            upload_ms = time_ms(lambda: torch.as_tensor(x["vis_pixels"]).to(pipe.device))
        if (VIT_V["train"], VIT_Q) != (k5_args[0].shape[1], k5_args[1].shape[1]):
            raise AssertionError(f"vit: the timed step's K5 shapes {on_path}")

        # eval steps at B = 64 over the dev batches
        reset()
        pipe.evaluate("dev")
        eval_counts = counts()
        steps = [t for t, n in zip(pipe.step_times, pipe.step_sizes) if n == 64]
        eval_s = statistics.median(steps)
        per_eval_step = {k: v / len(pipe.step_times) for k, v in eval_counts.items()}

        # one MBR eval step on the n1 = 65 batch: K1 log and max reused, plus
        # K1 max on the Eisner potentials, all three in global scratch
        pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=True)
        reset()
        try:
            mbr_arc = pipe.eval_step(x)["arc"]
        finally:
            pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=False)
        mbr_counts = counts()
        if not (mbr_counts["dmv_fused"] == mbr_counts["dmv_fused_global"] == 3):
            raise AssertionError(f"vit MBR eval step: launches {mbr_counts}")
        with torch.no_grad():
            inputs = _to_device(x, pipe.device)
            arc = pipe.model.eval()(inputs)["dep_reuse"]["log"][2].sum(-1)
            mbr_check = check_mbr_heads(arc, inputs["seq_len"],
                                        torch.as_tensor(mbr_arc).to(arc.device),
                                        "vlgae_vit eval batch at n1 = 65")
        mbr_check["launches"] = mbr_counts

        # predict from the checkpoint: train, dev and test files
        shapes.clear()
        reset()
        match.match_maxes = recording
        t0 = time.perf_counter()
        try:
            ppipe, results = _run_predict(tmp, [f"checkpoint={last}", "device=cuda"])
        finally:
            match.match_maxes = orig["fwd"]
        torch.cuda.synchronize()
        t_predict = time.perf_counter() - t0
        predict_launches = counts()
        predict_shapes = sorted(shapes)
        if not (predict_launches["dmv_fused_global"] and predict_launches["match_fwd"]
                and (VIT_V["eval"], VIT_Q) in shapes):
            raise AssertionError(f"vit predict: launches {predict_launches}, "
                                 f"K5 shapes {predict_shapes}")
        for split in ("dev", "test"):
            with open(os.path.join(tmp, f"unnamed_{split}.conll")) as f:
                n_sent = f.read().count("\n\n")
            if n_sent != len(ppipe.dm.datasets[split]) or not math.isfinite(
                    float(results[split]["loss"])):
                raise AssertionError(f"vit predict {split}: {n_sent} sentences")
        eval_predict = check_eval(root, os.path.join(tmp, "unnamed_dev.conll"))

    emit({"phase": "vit", "corpus_s": round(t_corpus, 3), "train_s": round(t_train, 3),
          "predict_s": round(t_predict, 3), "launches_train": launches,
          "launches_per_train_step": per_step, "launches_per_eval_step": per_eval_step,
          "launches_predict": predict_launches, "k5_shapes_train": train_shapes,
          "k5_shapes_predict": predict_shapes, "test": test,
          "epochs": len([r for r in lines if "train/loss" in r]), "losses": losses,
          "eval_py_tail": {"train_dev": eval_dev, "predict_dev": eval_predict},
          "vit_frozen_bit_identical": True, "kernels_on_path": on_path,
          "mbr_eval_step_n1_65": mbr_check,
          "vit_forward_device_ms_B64": vit_ms, "pixel_upload_ms_B64": upload_ms,
          "pixel_bytes_B64": int(x["vis_pixels"].nbytes),
          "train_step_ms_median_B64": step_s * 1e3,
          "train_step_ms_B64": [round(t * 1e3, 3) for t in times],
          "train_sentences_per_s_B64": 64 / step_s,
          "eval_step_ms_median_B64": eval_s * 1e3,
          "eval_step_ms_B64": [round(t * 1e3, 3) for t in steps],
          "eval_sentences_per_s_B64": 64 / eval_s,
          "shape": {"len": "3-63", "B": 64, "patches": 49, "image": 224,
                    "vit": "192/4/4/384", "V": VIT_V, "precision": "bf16"}})
    for name in ("dmv_fused", "match_fwd", "match_bwd"):
        by_path = {"vlgae_vit_train": launches[name]}
        if name != "match_bwd":
            by_path["vlgae_vit_predict"] = predict_launches[name]
            by_path["vlgae_vit_mbr_eval_step"] = mbr_counts[name]
        state.setdefault(name, {}).setdefault("launches_by_path", {}).update(by_path)


# MBR and the Eisner CRF on the card (phase mbr): a head set is compared
# with another computation's where its tree wins by at least this much (the
# gap to the best tree that differs in one arc or more); the card's and the
# CPU's marginals differ by a few ulp, so near-ties may go either way
MBR_MARGIN = 1e-3
EISNER_N1 = {"B64_len1-50": 51, "B64_len1-64_global": 65, "B64_len86-100_global": 101}


def eisner_lengths(rng, n1, B=64):
    """B lengths in [1, n1 - 1] (in [86, 100] at n1 = 101, every sentence
    beyond K1's shared memory) with the longest and a one-word sentence."""
    lo = 86 if n1 > 86 else 1
    lengths = rng.integers(lo, n1, B)
    lengths[:2] = (n1 - 1, lo)
    return lengths


def eisner_bound(lengths, n1):
    """The bound of the Eisner CRF's tables (K1 on Eisner potentials): the
    arc scores read, the attach table written, and the operations of the
    Eisner inside pass (3 split-point sums of w terms a span of width w,
    each term one product and one sum) three times, inside and outside."""
    B = len(lengths)
    ops = sum(6 * w * (int(n) + 1 - w) for n in lengths for w in range(1, int(n) + 1))
    return bound(4 * B * n1 * n1 + 4 * B * n1 * n1 * 2 + 4 * B, 3 * ops, "f32")


def tree_margins(heads, lengths, best, total_without):
    """Per sentence, the best tree's score minus the best score of a tree
    that differs from it in one arc or more: the largest total with one of
    the tree's arcs removed (``total_without(h, k)``: totals [B] with arc
    ``h[b] -> k`` removed in every sentence). ``inf`` for a sentence with a
    single tree. Torch tensors on one device."""
    import torch

    rows = torch.arange(heads.shape[0], device=heads.device)
    second = torch.full_like(best, float("-inf"))
    for k in range(1, int(lengths.max()) + 1):
        t = total_without(rows, heads[:, k - 1], k)
        second = torch.where(k <= lengths, torch.maximum(second, t), second)
    return torch.where(second > -1e11, best - second, float("inf"))


def eisner_margins(arc, lengths, heads):
    """:func:`tree_margins` of the single-root Eisner CRF on ``arc`` (value
    only inside passes, K2/K4 on the card)."""
    from vlgae_tpu_torch.struct import NEGINF, DependencyCRF

    def without(rows, h, k):
        a = arc.clone()
        a[rows, h.long(), k] = NEGINF
        return DependencyCRF(a, lengths).max

    return tree_margins(heads, lengths, DependencyCRF(arc, lengths).max, without)


def dmv_margins(dec, attach, lengths, heads):
    """:func:`tree_margins` of the DMV on merged potentials (both valences
    of an arc removed)."""
    from vlgae_tpu_torch.struct import NEGINF, dmv_total_fast

    def without(rows, h, k):
        a = attach.clone()
        a[rows, h.long(), k] = NEGINF
        return dmv_total_fast(dec, a, lengths, "max")

    return tree_margins(heads, lengths, dmv_total_fast(dec, attach, lengths, "max"), without)


def _is_tree(heads):
    from vlgae_tpu_torch.struct.alg import istree

    return istree(list(heads), proj=True)


def non_trees(heads, lengths):
    """Sentences whose heads are not a single-root projective tree."""
    return sum(1 for h, n in zip(heads.tolist(), lengths.tolist())
               if n and not _is_tree(h[:n]))


def check_mbr_heads(arc, lengths, got, what):
    """Heads ``got`` of an MBR decode on the card against the plain Eisner
    fill's argmax on the same summed marginals ``arc``: equal where the tree
    wins by ``MBR_MARGIN``, and a projective tree in every sentence."""
    import torch

    from vlgae_tpu_torch.struct import deptree_marginals

    want = torch.argmax(deptree_marginals(arc, lengths, "max")[:, :, 1:], dim=1)
    margin = eisner_margins(arc, lengths, want)
    real = lengths > 0
    won = real & (margin >= MBR_MARGIN)
    stats = {"sentences": int(real.sum()), "margin_won": int(won.sum()),
             "equal_where_won": bool(torch.equal(got[won], want[won])),
             "equal_all": bool(torch.equal(got[real], want[real])),
             "min_margin": float(margin[real].min()) if bool(real.any()) else None,
             "non_trees": non_trees(got, lengths)}
    if not stats["equal_where_won"] or stats["non_trees"]:
        raise AssertionError(f"MBR heads {what}: {stats}")
    return stats


def _k1_eisner(state, rng, dev):
    """K1 on Eisner potentials (``eisner_as_dmv``) against the plain Eisner
    fill on the card, at B = 64 and the n1 of the three recipes' eval paths;
    its time beside the plain fill's."""
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused
    from vlgae_tpu_torch.struct import (deptree_grads_fast, deptree_marginals,
                                        deptree_partition, eisner_as_dmv)

    cases, rows = {}, {}
    for name, n1 in EISNER_N1.items():
        lengths = eisner_lengths(rng, n1)
        arc = torch.tensor(rng.standard_normal((64, n1, n1)), dtype=torch.float32,
                           device=dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        dec, attach = eisner_as_dmv(arc)
        case = {}
        for kind in ("log", "max"):
            g0 = dmv_cuda.n_fused_global_launches
            total = dmv_fused(dec, attach, lens, kind)[0]
            table = deptree_grads_fast(arc, lens, kind)
            if name.endswith("_global") and dmv_cuda.n_fused_global_launches != g0 + 2:
                raise AssertionError(f"K1 Eisner {name} did not take global scratch")
            want_t = deptree_partition(arc, lens, kind)
            want_g = deptree_marginals(arc, lens, kind)
            errs = {"total": float((total - want_t).abs().max()),
                    "table": float((table - want_g).abs().max())}
            ok = close(total, want_t, K1_TOTAL_ATOL, K1_TOTAL_RTOL) and (
                errs["table"] == 0.0 if kind == "max"
                else close(table, want_g, K1_GRAD_ATOL, K1_GRAD_RTOL))
            if not ok:
                raise AssertionError(f"K1 on Eisner potentials {name}/{kind}: {errs}")
            case[kind] = {
                **errs,
                "device_ms": device_ms(lambda: dmv_fused(dec, attach, lens, kind)),
                "ms": time_ms(lambda: deptree_grads_fast(arc, lens, kind)),
                "plain_ms": time_ms(lambda: deptree_marginals(arc, lens, kind),
                                    reps=3, warmup=1)}
        cases[name] = case
        b = eisner_bound(lengths, n1)
        rows[f"n1={n1}"] = {
            "ms_log": case["log"]["ms"], "ms_max": case["max"]["ms"],
            "device_ms_log": case["log"]["device_ms"],
            "device_ms_max": case["max"]["device_ms"],
            "plain_ms_log": case["log"]["plain_ms"], "plain_ms_max": case["max"]["plain_ms"],
            "max_abs_err": max(case["log"]["table"], case["max"]["table"]),
            **b, "library_ms": None}
    state.setdefault("dmv_fused", {})["on_eisner_potentials"] = rows
    return cases


def _eval_with_and_without_mbr(pipe, counts, reset, full, rounds=2):
    """``pipe.evaluate('dev')`` with MBR off and on, in turns: the median
    host ms of the eval steps whose batch holds more than ``full`` real
    sentences, sentences/s, and the kernels' launches per step."""
    out = {}
    for _ in range(rounds):
        for mbr in (False, True):
            pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=mbr)
            reset()
            pipe.evaluate("dev")
            c = counts()
            rec = out.setdefault("mbr" if mbr else "viterbi", {"steps": []})
            rec["steps"] += [(t, n) for t, n in zip(pipe.step_times, pipe.step_sizes)
                             if n > full]
            rec["launches"] = c
            rec["per_step"] = {k: v / len(pipe.step_times) for k, v in c.items()}
    pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=False)
    for rec in out.values():
        steps = rec.pop("steps")
        rec["median_ms"] = statistics.median(t for t, _ in steps) * 1e3
        rec["sentences_per_s"] = statistics.median(n / t for t, n in steps)
        rec["ms"] = [round(t * 1e3, 3) for t, _ in steps]
    return out


# a grounding row counts as tied where two of its top-(k + 1) decode logits
# lie within this of each other (card and CPU may order them either way)
ALIGN_TIE = 1e-4


def _tied_align_rows(model, out, inputs, real, topk=5):
    """Per real sentence of a joint eval batch, whether every row of its
    prediction file may differ in its ALIGN column between card and CPU, and
    the rows that may: a row where a word factor or an arc factor holds two
    top-(``topk`` + 1) decode logits within ``ALIGN_TIE`` (relative to 1 +
    |value|); every row of a sentence whose DMV Viterbi tree wins by less
    than ``MBR_MARGIN`` (the arc factors are built from that tree's heads,
    and K1 max marks every best tree on a tie where the CPU splits it), or
    where the best-box heuristic's inputs tie (a row's best box against its
    best non-box factor, or its two best boxes, before the heuristic), since
    either choice reaches all its rows. Mask constants (<= -1e5) tie
    exactly on both devices and are left out."""
    import dataclasses

    import torch

    def near(v):
        gap = v[..., :-1] - v[..., 1:]
        return (gap <= ALIGN_TIE * (1 + v[..., :-1].abs())) & (v[..., :-1] > -1e5)

    logit = model.decode_grounding_logits(out, inputs)
    tied_q = near(torch.topk(logit.float(), topk + 1, dim=-1).values).any(-1)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, decode_use_heuristic=False)
    try:
        raw = model.decode_grounding_logits(out, inputs).float()
    finally:
        model.cfg = cfg
    mask = out["txt_packed"][1]
    P = out["vis_packed"][2][0]
    box = torch.topk(raw[..., :P], 2, dim=-1).values
    rest = raw[..., P:].amax(-1, keepdim=True)
    pair = torch.sort(torch.cat([box[..., :1], rest], -1), -1, descending=True).values
    heur = ((near(box) | near(pair)).any(-1) & mask).any(-1)
    lens = inputs["seq_len"]
    viterbi = torch.argmax(out["dep_reuse"]["max"][2].sum(-1)[:, :, 1:], dim=1)
    heur = heur | (dmv_margins(out["merged_dec"], out["merged_attach"], lens,
                               viterbi) < MBR_MARGIN)
    tied_q, mask, lens, heur = tied_q.cpu(), mask.cpu(), lens.cpu(), heur.cpu()
    rows = []
    for b in range(real):
        t, n = tied_q[b][mask[b]].tolist(), int(lens[b])
        rows.append((bool(heur[b]),
                     {i for i in range(n) if t[i] or (len(t) > n and t[i + n])}))
    return rows


def _dev_heads(path):
    """HEAD columns of a CoNLL file, one list per sentence."""
    with open(path) as f:
        blocks = [b for b in f.read().split("\n\n") if b.strip()]
    return [[int(r.split("\t")[3]) for r in b.splitlines()] for b in blocks]


def phase_mbr(state):
    """MBR decoding (``mbr_decoding: true``) on the card: K1 on Eisner
    potentials; ``exp=vlgae`` predict at its published widths, card against
    CPU at precision=32, and its bf16 eval step with and without MBR;
    ``exp=lang_only`` predict with MBR (long captions too), card against
    CPU at small widths, and its eval step with and without MBR."""
    import math

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.predict import build_pipeline
    from vlgae_tpu_torch.struct import DependencyCRF, DMV1o
    from vlgae_tpu_torch.training.pipeline import _to_device, pad_batch_pow2

    def reset():
        dmv_cuda.reset_launch_counts()
        match.n_launches = match.n_bwd_launches = 0

    def counts():
        c = dmv_cuda.launch_counts()
        return {"dmv_fused": c["fused"], "dmv_fused_global": c["fused_global"],
                "dmv_inside": c["inside"]["smem"], "dmv_inside_small": c["inside"]["warp"],
                "dmv_inside_long": c["inside"]["global"],
                "dmv_inside_save": sum(c["inside_save"].values()),
                "dmv_outside": c["outside"], "match_fwd": match.n_launches}

    def value_only(c):
        return c["dmv_inside"] + c["dmv_inside_small"] + c["dmv_inside_long"]

    def n_steps(pipe):
        return sum(len(list(pipe.dm.batches(s, shuffle=False)))
                   for s in ("train", "dev", "test") if s in pipe.dm.datasets)

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    result = {"phase": "mbr", "k1_on_eisner": _k1_eisner(state, rng, dev)}
    by_path = {}

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=104, feat_dim=2048, n_box=36, len_range=(3, 50), seed=0)
        base = _corpus_overrides(tmp) + [f"datamodule.{s}_dataloader.num_bucket=1"
                                         for s in ("train", "dev", "test")]
        p32 = base + ["trainer.precision=32", "model.dep_model_cfg.mbr_decoding=true"]
        # the card through the predict entry point, precision=32, MBR
        reset()
        t0 = time.perf_counter()
        card, card_res = _run_predict(tmp, p32 + ["init_seed=0", "device=cuda", "name=card"])
        torch.cuda.synchronize()
        t_predict = time.perf_counter() - t0
        c = counts()
        steps = n_steps(card)
        if c["dmv_fused"] != 3 * steps or c["match_fwd"]:
            raise AssertionError(f"vlgae MBR predict: launches {c} over {steps} steps")
        by_path["vlgae_mbr_predict"] = c
        card_file = os.path.join(tmp, "card_dev.conll")
        ev = subprocess.run([sys.executable, os.path.join(ROOT, "eval.py"), "--file",
                             card_file, "--dataroot", root], capture_output=True, text=True)
        if ev.returncode != 0:
            raise AssertionError(f"eval.py rc {ev.returncode}: {ev.stderr[-2000:]}")
        # the CPU: the same weights and dev set, plain versions
        t0 = time.perf_counter()
        cpu = build_pipeline(p32, device="cpu", init_seed=0)
        cpu_res, cpu_out = cpu.evaluate("dev")
        cpu_file = os.path.join(tmp, "cpu_dev.conll")
        cpu.write_predictions(cpu_file, "dev", cpu_out)
        t_cpu = time.perf_counter() - t0
        # the card's MBR marginals, heads and margins on each dev batch
        margins, card_heads, tied = {}, {}, {}
        with torch.no_grad():
            for x, _ in card.dm.batches("dev", shuffle=False):
                xp, real = pad_batch_pow2(x)
                inputs = _to_device(xp, card.device)
                out = card.model.eval()(inputs)
                lens = inputs["seq_len"]
                arc = out["dep_reuse"]["log"][2].sum(-1)
                heads = DependencyCRF(arc, lens).argmax_heads
                m = eisner_margins(arc, lens, heads)
                t = _tied_align_rows(card.model, out, inputs, real)
                for j, sid in enumerate(x["id"][:real]):
                    margins[int(sid)] = float(m[j])
                    card_heads[int(sid)] = heads[j, :int(x["seq_len"][j])].tolist()
                    tied[int(sid)] = t[j]
        ids = [inst["id"] for inst in card.dm.datasets["dev"]]
        got, want = _dev_heads(card_file), _dev_heads(cpu_file)
        with open(card_file) as f, open(cpu_file) as g:
            card_text, cpu_text = f.read(), g.read()
        rows = [(a.split("\t"), b.split("\t")) for a, b in zip(
            card_text.splitlines(), cpu_text.splitlines())]
        blocks = [[b.splitlines() for b in text.split("\n\n") if b.strip()]
                  for text in (card_text, cpu_text)]
        differ = {(sid, i): (ra.split("\t")[4:], rb.split("\t")[4:])
                  for sid, a, b in zip(ids, *blocks)
                  for i, (ra, rb) in enumerate(zip(a, b)) if ra != rb}
        untied = {k: v for k, v in differ.items()
                  if not tied[k[0]][0] and k[1] not in tied[k[0]][1]}
        won = [margins[i] >= MBR_MARGIN for i in ids]
        ref = {"identical_dev_file": card_text == cpu_text,
               "arcs_identical": got == want,
               "arcs_identical_where_won": all(a == b for a, b, w in zip(got, want, won) if w),
               "sentences": len(ids), "margin_won": sum(won),
               "min_margin": min(margins.values()),
               "heads_as_decoded_again": all(card_heads[i] == h for i, h in zip(ids, got)),
               "non_trees": sum(1 for h in got if not _is_tree(h)),
               "align_rows_identical": float(np.mean([a == b for a, b in rows])),
               "rows_differing": len(differ),
               "rows_differing_head": sum(1 for sid, i in differ
                                          if got[ids.index(sid)][i]
                                          != want[ids.index(sid)][i]),
               "align_rows_tied": sum(len(t) for _, t in tied.values()),
               "sentences_tied": sum(h for h, _ in tied.values()),
               "rows_differing_in_tied_sentences": sum(1 for sid, _ in differ
                                                       if tied[sid][0]),
               "rows_differing_untied": len(untied),
               "untied_rows": {f"{sid}:{i}": v for (sid, i), v in list(untied.items())[:8]},
               "dev_loss": {"card": card_res["dev"]["loss"], "cpu": cpu_res["loss"]},
               "predict_s": round(t_predict, 3), "cpu_dev_s": round(t_cpu, 3),
               "eval_py_tail": ev.stdout.strip().splitlines()[-1]}
        result["vlgae_reference"] = ref
        # every arc is the same; a row may differ only in its ALIGN column,
        # and only where its grounding holds a near tie (_tied_align_rows)
        if not (ref["arcs_identical"] and ref["arcs_identical_where_won"]
                and ref["heads_as_decoded_again"]
                and not ref["non_trees"] and len(got) == len(ids)
                and len(blocks[0]) == len(blocks[1]) == len(ids)
                and not ref["rows_differing_untied"]
                and abs(card_res["dev"]["loss"] - cpu_res["loss"])
                <= 1e-4 * (1 + abs(cpu_res["loss"]))):
            raise AssertionError(f"vlgae MBR: card and CPU disagree: {ref}")

        # the recipe (bf16) eval step with and without MBR
        pipe = build_pipeline(base, device=dev, init_seed=0)
        timing = _eval_with_and_without_mbr(pipe, counts, reset, full=63)
        if not (timing["viterbi"]["per_step"]["dmv_fused"] == 2
                and timing["mbr"]["per_step"]["dmv_fused"] == 3):
            raise AssertionError(f"vlgae eval step K1 launches: {timing}")
        result["vlgae_eval_step_B64"] = timing
        by_path["vlgae_mbr_eval"] = timing["mbr"]["launches"]

    # exp=lang_only: the recipe's widths, weights from a seed
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=LANG_N_IMGS, feat_dim=4,
                    n_box=3, len_range=(3, 50), seed=0)
        lang = _lang_overrides(tmp, False)
        reset()
        ppipe, res = _run_predict(tmp, lang + ["model.mbr_decoding=true", "init_seed=0",
                                               "device=cuda"])
        c = counts()
        steps = n_steps(ppipe)
        if not (c["dmv_fused"] == 2 * steps and value_only(c) == steps
                and not any(math.isnan(float(r["loss"])) for r in res.values())):
            raise AssertionError(f"lang_only MBR predict: launches {c} over {steps} steps")
        by_path["lang_only_mbr_predict"] = c
        lang_trees = sum(1 for h in _dev_heads(os.path.join(tmp, "unnamed_dev.conll"))
                         if not _is_tree(h))
        pipe = build_pipeline(lang, device=dev, init_seed=0)
        timing = _eval_with_and_without_mbr(pipe, counts, reset, full=32)
        if not (timing["viterbi"]["per_step"]["dmv_fused"] == 1
                and timing["mbr"]["per_step"]["dmv_fused"] == 2):
            raise AssertionError(f"lang_only eval step K1 launches: {timing}")
        result["lang_only_eval_step_B64"] = timing
        x = pad_batch_pow2(next(pipe.dm.batches("dev", shuffle=False))[0])[0]
        pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=True)
        heads = torch.as_tensor(pipe.eval_step(x)["arc"]).to(dev)
        with torch.no_grad():
            inputs = _to_device(x, pipe.device)
            out = pipe.model.eval()(inputs)
            lens = inputs["seq_len"]
            arc = DMV1o((out["merged_dec"], out["merged_attach"]), lens).marginals.sum(-1)
        result["lang_only_batch"] = check_mbr_heads(arc, lens, heads, "lang_only dev batch")
        result["lang_only_predict"] = {"dev_uas": res["dev"]["uas"], "non_trees": lang_trees}
        if lang_trees:
            raise AssertionError(f"lang_only MBR predict: {lang_trees} non-trees")

    # long captions (n1 = 89-105): K1 in global scratch for both passes
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=16, feat_dim=4, n_box=3,
                    len_range=(86, 100), seed=2)
        reset()
        ppipe, res = _run_predict(tmp, _lang_overrides(tmp, False) + [
            "datamodule.max_len.train=100", "model.mbr_decoding=true", "init_seed=0",
            "device=cuda"])
        c = counts()
        steps = n_steps(ppipe)
        long_trees = sum(1 for h in _dev_heads(os.path.join(tmp, "unnamed_dev.conll"))
                         if not _is_tree(h))
        if not (c["dmv_fused"] == c["dmv_fused_global"] == 2 * steps
                and c["dmv_inside_long"] == steps and not long_trees):
            raise AssertionError(f"lang_only long MBR predict: {c}, {long_trees} non-trees")
        by_path["lang_only_mbr_long_predict"] = c

    # the small lang_only reference at precision=32: card against CPU
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=8, feat_dim=4, n_box=3,
                    len_range=(3, 12), seed=1)
        files = {}
        for d in ("cpu", "cuda"):
            _run_predict(tmp, _lang_overrides(tmp, True) + [
                "model.mbr_decoding=true", "init_seed=0", f"device={d}", f"name={d}"])
            with open(os.path.join(tmp, f"{d}_dev.conll")) as f:
                files[d] = f.read()
        result["lang_only_reference_identical_dev_file"] = files["cpu"] == files["cuda"]
        if files["cpu"] != files["cuda"]:
            raise AssertionError("lang_only MBR: the card and the CPU predict differently")

    result["launches_by_path"] = by_path
    emit(result)
    for path, c in by_path.items():
        for name in ("dmv_fused", "dmv_inside", "dmv_inside_small", "dmv_inside_long",
                     "match_fwd"):
            if c.get(name):
                state.setdefault(name, {}).setdefault("launches_by_path", {})[path] = c[name]


# card against CPU after two EM epochs: log tables (f32 DP sums in other
# orders; the gather's backward adds with float atomics on the card)
EM_TOL = 1e-4


def phase_em(state):
    """The classic tabular DMV (``models/dmv_model.py``) on the lang_only
    corpus with the recipe's data settings (word:tag tokens of the 200 most
    frequent words, training captions up to 10 words): km_init, two EM
    epochs at B = 64 on the card and on the CPU, then MBR and Viterbi
    decodes of dev."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.data import DepDataModule
    from vlgae_tpu_torch.models import dmv_model
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_inside_save, dmv_outside
    from vlgae_tpu_torch.struct import DMV1o, dmv_inside_charts_plain, dmv_outside_plain
    from vlgae_tpu_torch.training.metrics import DependencyParsingMetric
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=LANG_N_IMGS, feat_dim=4, n_box=3, len_range=(3, 50),
                    seed=0)
        loader = {"batch_size": 64, "num_bucket": 1}
        dm = DepDataModule(
            train_path=f"{root}/train.conll", dev_path=f"{root}/val.conll",
            test_path=f"{root}/test.conll", use_tag=True, num_lex=200,
            max_len={"train": 10}, train_dataloader=loader,
            dev_dataloader={"batch_size": 64, "num_bucket": 8}).setup()
        vocab = dm.vocabs["token"]
        seqs = [[vocab[t] for t in inst["token"]] for inst in dm.datasets["train"]]
        cfg = dmv_model.DMVConfig(init_method="km", n_token=len(vocab), smooth=0.1)
        devices = {"card": dev, "cpu": torch.device("cpu")}
        params = {d: dmv_model.init_params(cfg, token_seqs=seqs, device=devices[d])
                  for d in devices}
        batches = [pad_batch_pow2(x)[0] for x, _ in dm.batches("train", shuffle=False)]

        def tensors(x, d):
            return (torch.as_tensor(x["token"]).to(devices[d]),
                    torch.as_tensor(x["seq_len"]).to(devices[d]))

        dmv_cuda.reset_launch_counts()
        times = []
        for _ in range(2):
            for d in devices:
                em = dmv_model.EMAccumulator(cfg.smooth)
                for x in batches:
                    t0 = time.perf_counter()
                    em.accumulate(dmv_model.expected_counts(params[d], *tensors(x, d)))
                    if d == "card":
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                params[d] = em.apply(params[d])
        c = dmv_cuda.launch_counts()
        n_em = 2 * len(batches)
        if not (sum(c["inside_save"].values()) == c["outside"] == n_em
                and c["fused"] == 0 and sum(c["inside"].values()) == 0):
            raise AssertionError(f"classic DMV E-steps: launches {c} over {n_em} steps")
        em_launches = {"dmv_inside_save": c["inside_save"]["smem"],
                       "dmv_inside_small": c["inside_save"]["warp"],
                       "dmv_inside_long": c["inside_save"]["global"],
                       "dmv_outside": c["outside"]}
        table_err = {k: float((params["card"][k].cpu() - params["cpu"][k]).abs().max())
                     for k in dmv_model.KEYS}
        if not all(close(params["card"][k].cpu(), params["cpu"][k], EM_TOL, EM_TOL)
                   for k in dmv_model.KEYS):
            raise AssertionError(f"classic DMV tables, card against CPU: {table_err}")

        # K3a and K3b at the E-step's shape (the last full batch), log semiring
        x = next(b for b in reversed(batches) if int((b["seq_len"] > 0).sum()) > 32)
        tok, lens = tensors(x, "card")
        md, ma = (t.detach() for t in dmv_model.forward(params["card"], tok))
        total, charts = dmv_inside_save(md, ma, lens, "log")
        gout = torch.ones_like(total)
        n1, lengths = int(md.shape[1]), x["seq_len"]
        shape_rows = {
            "dmv_inside_save": {
                "device_ms": device_ms(lambda: dmv_inside_save(md, ma, lens, "log")),
                "plain_ms": time_ms(lambda: dmv_inside_charts_plain(md, ma, lens, "log"),
                                    reps=5, warmup=1),
                **dmv_bound(lengths, n1, "save")},
            "dmv_outside": {
                "device_ms": device_ms(
                    lambda: dmv_outside(md, ma, lens, gout, total, charts, "log")),
                "plain_ms": time_ms(lambda: dmv_outside_plain(
                    md, ma, lens, gout, total, charts, "log"), reps=5, warmup=1),
                **dmv_bound(lengths, n1, "outside")}}
        for name, row in shape_rows.items():
            row.update(n1=n1, B=len(lengths), library_ms=None)
            state.setdefault(name, {})["at_classic_dmv_e_step"] = row

        # dev: MBR and Viterbi decodes on the card (UAS); the card against
        # the CPU on three batches, the longest among them
        dev_batches = list(dm.batches("dev", shuffle=False))
        metrics = {m: DependencyParsingMetric() for m in ("mbr", "viterbi")}
        dmv_cuda.reset_launch_counts()
        heads = {}
        for k, (x, y) in enumerate(dev_batches):
            tok, lens = tensors(x, "card")
            mask = np.arange(x["token"].shape[1])[None, :] < x["seq_len"][:, None]
            for m in metrics:
                h = dmv_model.decode(params["card"], tok, lens, mbr=m == "mbr")
                heads[k, m] = h
                metrics[m].update({"arc": h.cpu().numpy()}, y, mask)
        c = dmv_cuda.launch_counts()
        if c["fused"] != 3 * len(dev_batches):
            raise AssertionError(f"classic DMV decode: launches {c}")
        uas = {m: metric.compute()["uas"] for m, metric in metrics.items()}
        longest = max(range(len(dev_batches)), key=lambda k: dev_batches[k][0]["token"].shape[1])
        compare = {m: {"sentences": 0, "margin_won": 0, "equal_where_won": True,
                       "non_trees": 0} for m in ("mbr", "viterbi")}
        compare["n1"] = []
        for k in sorted({0, 1, longest}):
            x = dev_batches[k][0]
            tok, lens = tensors(x, "card")
            md, ma = dmv_model.forward(params["card"], tok)
            arc = DMV1o((md, ma), lens).marginals.sum(-1)
            for m, rec in ((m, compare[m]) for m in ("mbr", "viterbi")):
                got = heads[k, m]
                want = dmv_model.decode(params["cpu"], *tensors(x, "cpu"), mbr=m == "mbr")
                margin = (eisner_margins(arc, lens, got) if m == "mbr"
                          else dmv_margins(md, ma, lens, got))
                won = (margin >= MBR_MARGIN) & (lens > 0)
                rec["sentences"] += int((lens > 0).sum())
                rec["margin_won"] += int(won.sum())
                rec["equal_where_won"] &= bool(torch.equal(got[won].cpu(), want[won.cpu()]))
                rec["non_trees"] += non_trees(got, lens)
                # a Viterbi tree tied exactly may decode to a non-tree (ROADMAP
                # Queue 3); one that wins by the margin may not
                if m == "viterbi" and non_trees(got[won], lens[won]):
                    raise AssertionError("classic DMV: a margin-won Viterbi non-tree")
            compare["n1"].append(int(md.shape[1]))
        if not (compare["mbr"]["equal_where_won"] and compare["viterbi"]["equal_where_won"]
                and not compare["mbr"]["non_trees"]):
            raise AssertionError(f"classic DMV decode, card against CPU: {compare}")

    emit({"phase": "em", "n_token": len(vocab), "train_captions": len(seqs),
          "e_step_batches": len(batches), "e_step_launches": em_launches,
          "e_step_ms_median_B64": statistics.median(times) * 1e3,
          "e_step_ms_B64": [round(t * 1e3, 3) for t in times],
          "tables_max_abs_err_card_vs_cpu": table_err, "tolerance": EM_TOL,
          "kernels_at_e_step_shape": shape_rows, "dev_batches": len(dev_batches),
          "decode_launches": {"dmv_fused": c["fused"]}, "uas": uas,
          "card_vs_cpu_decode": compare})
    for name, n in em_launches.items():
        if n:
            state.setdefault(name, {}).setdefault("launches_by_path", {})[
                "classic_dmv_em"] = n
    state.setdefault("dmv_fused", {}).setdefault("launches_by_path", {})[
        "classic_dmv_decode"] = c["fused"]


PHASES = {"env": phase_env, "build": phase_build, "k1": phase_k1,
          "k5": phase_k5, "k6": phase_k6, "reference": phase_reference,
          "train_reference": phase_train_reference, "slice": phase_slice,
          "train": phase_train, "k2": phase_k2, "k3": phase_k3,
          "lang_only_reference": phase_lang_only_reference,
          "lang_only": phase_lang_only, "vit_reference": phase_vit_reference,
          "vit": phase_vit, "mbr": phase_mbr, "em": phase_em}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import vlgae_tpu_torch  # noqa: F401  (fails here, before any output, without the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {}
    seconds = {}
    for name, phase in PHASES.items():
        t0 = time.perf_counter()
        phase(state)
        seconds[name] = round(time.perf_counter() - t0, 3)
    emit({"phase_seconds": seconds, "total_s": round(sum(seconds.values()), 3)})
    print(nvidia_smi_line())
    rows = []
    required = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    for name, info in KERNELS.items():
        row = {"name": name, **info, **state.get(name, {})}
        # each main path was driven with the counts at 0 just before it and
        # read just after; a kernel's launches are those of all of them
        row["launches"] = sum(row.get("launches_by_path", {}).values())
        missing = [k for k in required if k not in row]
        if missing:
            raise AssertionError(f"kernel row {name} lacks {missing}")
        if row["launches"] <= 0:
            raise AssertionError(f"kernel {name} was never launched on a main path")
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
