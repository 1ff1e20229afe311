"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. env       - torch / CUDA / nvcc versions and the card (nvidia-smi)
  2. build     - compile every kernel from csrc/ (one nvcc per source, in
                 parallel)
  2a. native_io - the det-feature packer (csrc/vlgae_io.cpp, built here by
                 g++): at sample=0 bit-equal to a NumPy packing of the
                 recipe's 36 boxes of 2048-d features, at sample=35 35
                 distinct sorted rows per image, the same rows for the same
                 seed, the masks, the features in page-locked memory; the
                 pack time of 64 images
  3. k1        - the fused DMV kernel against its plain version (log + max),
                 in each of its placements, each case's launches counted on
                 the one its rule names: charts in shared memory at B=64
                 with ragged lengths 1..50 and at n1 < 10; the inside charts
                 alone there (split) at n1 = 57, 65, 74 and 75; charts in
                 global scratch at lengths up to 80 and at n1 = 101 with
                 lengths 86..100 (in log also against the plain version in
                 f64, its worst error over the tolerance printed); reruns
                 bit-identical; equal to the pair (inside with saved charts,
                 then outside) at a cotangent of one, bit for bit in max;
                 when ``_checkouts/parent_dmv/`` holds its sources, equal to
                 the parent commit's K1 bit for bit on every case; its time
                 at n1 = 17, 51, 57, 65, 75 and 101 beside the pair's and
                 the parent's K1, in turns
  4. k5        - the matching-max kernel (bf16 tensor cores) against its
                 plain version at A=B=64, Q=102, D=128 and V=703 (eval) and
                 739 (train), Q = 34, 66, 114, the patch grid (Q = 130 in
                 one q-chunk) and a rank's shard; exactly on quarter-integer
                 operands at shapes that hit the edges of its tiles (104 and
                 136 words, 64 image rows, 2 and 4 captions, blocks that
                 serve unequal numbers of images, D = 8, 64, 130, 384) and on
                 operands full of ties with whole rows and columns masked;
                 when ``_checkouts/parent_match/`` holds the parent commit's
                 match_fwd.cu, equal to the parent's K5 bit for bit on every
                 case and timed in turns with it; its time beside one bf16
                 ``torch.matmul`` of the same product, which stores the
                 product and takes no maxes
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
                 at B=64; the pageable and the pinned upload of a B=64
                 batch's box features (18.9 MB), host and device ms
  9a. export   - ``training/export.py``: the joint model's deterministic
                 forward at the recipe's widths (bf16), B=64, exported with
                 ``torch.export`` on the card, loaded back and run: its
                 ``merged_dec``/``merged_attach`` against the eager forward
                 (``EXPORT_ATOL``), the artifact's bytes, the loaded
                 program's time beside the eager forward's and the kernel
                 launches it makes (K1 twice and K5, as the custom ops
                 ``vlgae::dmv_fused`` and ``vlgae::match_maxes``)
 10. k2        - the value-only inside kernel against ``dmv_total`` (log +
                 max) at B=64 with ragged lengths, in its three mappings: a
                 warp per sentence (n1 = 1..9, B = 65), a block per sentence
                 with charts in shared memory (n1 = 10, 17, 51, 56, 57, 59,
                 60, 75, 76: the word path's 57 and each side of the pair's
                 staging and shared/global boundaries) and in global memory
                 (n1 = 101); reruns bit-identical; exact in the max semiring
                 on quarter-integer potentials; its time, dependent width
                 steps and ms a step at n1 = 9, 17, 51, 57, 59, 60, 101;
                 the floor under the warp mapping (a one-block PyTorch
                 kernel, and the warp kernel on zero-length rows at n1 = 1)
 11. k3        - the chart-saving inside kernel against the plain charts,
                 the outside kernel against its plain version under a
                 cotangent with zeros (on the kernel's charts and on the
                 plain charts uploaded; each launch on the mapping its rule
                 names), the pair against K1 scaled by the cotangent, reruns
                 bit-identical; the same n1 groups; times as in ``k2``.
                 Phases ``k2`` and ``k3`` also time the parent commit's
                 inside kernel (and ``k1`` its K1) in the same call when
                 copies of its ``dmv_inside.cu``, ``dmv_fused.cu`` and
                 ``dmv_common.cuh`` sit in the gitignored
                 ``_checkouts/parent_dmv/`` (built in phase ``build``, never
                 imported by the port); their lines say whether that ran
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
                 split placement (n1 = 65), K5 in one q-chunk of 136 words
                 at V = 1,324 and K6 at V = 1,324 on the path (launches counted,
                 each held against its plain version on the path's own
                 tensors), the frozen ViT bit-identical after training,
                 ``eval.py`` on the predictions with the patch grid as
                 proposal boxes, step times and the kernels' times there,
                 the pageable and the pinned upload of a B=64 batch's
                 pixels (38.5 MB);
                 one eval step with ``mbr_decoding`` on at n1 = 65 (three
                 K1 launches on the split placement, heads held to the plain
                 Eisner fill)
 16. mbr       - MBR decoding: K1 on Eisner potentials (free decisions, the
                 arc in both valences) against the plain Eisner fill at B=64,
                 n1 = 51, 65 and 101 (log and max, device time beside the
                 plain fill's and the parent commit's K1); ``predict`` of
                 ``exp=vlgae`` at the recipe's widths and precision=32
                 with MBR, the card against the CPU
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
 18. grounding_modes - the joint model's other grounding strategies at
                 ``exp=vlgae``'s widths and bf16: ``word+alldep`` (words and
                 every (head, dep) pair, Q up to 3,306) and the caption-image
                 path (``reduced`` / ``cap_img|ce`` / ``on_img``,
                 ``metric=attachment_cap_img``) through ``train`` (one
                 warm-up and one joint epoch) and ``predict``, ``eval.py`` on
                 each dev file; ``word`` by train and eval steps; each mode's
                 launches per step (K1, K2, the K3 pair, K5, K6) and step
                 times at B=64; K5 (25 q-chunks of 136 words; bit for bit
                 the parent's and timed in turns with it when
                 ``_checkouts/parent_match/`` holds its source) and K6 at
                 word+alldep's widest Q and the K3 pair at n1 = 57 on the
                 path's own tensors against their plain versions, with their
                 times, bounds and matmul yardsticks; each mode at small widths and
                 precision=32, the card against the CPU (dev predictions,
                 one train step's loss and gradients)
 19. struct    - the rest of the structured surface (the generic semiring
                 fills, plain PyTorch on the card): every new method of
                 ``DMV1o`` and ``DependencyCRF`` (entropy, cross-entropy,
                 KL, risk, count, k-max, top-k) at B=64, n1 = 51 and 65,
                 against the same call on the CPU on 16 of the sentences;
                 the Log/Max generic totals against K2; ``kmax(5)[0]``
                 against ``max``; 64 samples and a Gumbel relaxation per
                 sentence are trees; ``count`` not finite exactly where f32
                 overflows; each method's time on the card
 20. variational - the variational bottleneck (``z_dim = 64``) on the
                 kernels' paths: ``exp=lang_only`` under ``all:vae``
                 through ``train`` (one warm-up and one NLL epoch on phase
                 ``lang_only``'s corpus) and ``predict``, the K3 pair per
                 NLL step and K1 (max) with K2/K4 per eval step held to
                 their plain versions on a step's own tensors; three
                 ``exp=vlgae`` bf16 joint steps under ``all:ib`` (K1 twice,
                 K5, K6 a step; K5 and K6 held to their plain versions);
                 card against CPU at small widths and precision=32
                 (identical dev predictions) under ``all:vae``, ``tag:ib``,
                 ``context_mode=max`` and the joint model's ``all:ib``
 21. data_options - the datamodule and embedding options: ``exp=vlgae``
                 (bf16) with a local BERT directory at bert-base-cased's
                 published widths (768 x 12, random weights) and a WordPiece
                 ``vocab.txt`` of the corpus, three train steps at B = 64
                 (K1 twice, K5, K6 each; held to their plain versions on a
                 step's tensors), the steps' device-busy time, the BERT
                 forward's device time and memory, ``predict`` and
                 ``eval.py``; ``exp=lang_only`` through ``DepDataModule``
                 (plain CoNLL) with ``ignore_stop_word`` (which stop-word
                 list ran is printed): one warm-up and one NLL epoch,
                 ``predict``, the K3 pair, K1 (max) and K2/K4 held on a
                 batch's tensors; ``exp=vlgae`` with the gold scene graph and
                 whole-image features: one train step (K1, K5, K6 held),
                 ``predict``, ``eval.py``; each, card against CPU at small
                 widths and precision=32 (dev files identical but for rows
                 that a near tie decides)
 22. parallel  - ``train`` under ``torchrun`` on one card (world 1, plain
                 and FSDP) against the plain run, then ``predict``; with two
                 cards or more also ``trainer.model_parallel=2`` on the
                 (1, 2) grid at bf16 and at precision 32, with four the
                 (2, 2) grid with FSDP, each against a plain run
                 (``TP_BF16_RTOL``, ``TP_F32_RTOL``; on one card it prints
                 why not)
 23. granite   - K7 at the granite cell's layer against its plain version,
                 and ``exp=vlgae`` with a small granite directory through
                 ``train`` and ``predict`` (K7 once a layer per encoder call)
 24. graphs    - the joint phase's step as CUDA graphs
                 (``training/graphs.py``) at the bertbase cell's
                 configuration (``exp=vlgae``, bf16, a bert-base-cased
                 directory, B = 64): 12 steps over two batch shapes (each
                 key's eager step and capture, then replays) against the
                 same 12 steps through the same stretches run eagerly, from
                 the same weights and dropout seed: losses, terms,
                 gradients and parameters bit for bit; every K1, K5 and K6
                 argument of every step still holds its value after the
                 later replays; the graph counters; the two sides' step
                 times on the host clock
Phases ``k1``, ``k5`` and ``k6`` also hold K1 at n1 = 65 and K5 and K6 at
the patch grid's V (1,324 in training, 1,275 in evaluation) and Q = 130.
Then each phase's seconds, the card's name and power limit, the per-kernel
table (launches on the main paths, error, time, the plain version's time,
the bound the card's peaks set for the same work, a library call's time
where one exists) and, as the last line, ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without that line. Needs
one CUDA device. ``--phases a,b,...`` runs only those phases (after ``env``
and ``build``) and prints no kernel table.
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
SOURCES = ("dmv_fused", "dmv_inside", "dmv_outside", "match_fwd", "match_bwd", "moe_experts")
# each kernel's wrapper, and the torch.library custom op it is called through
KERNELS = {
    "dmv_fused": {
        "route": "cuda",
        "op": "vlgae::dmv_fused",
        "source": "vlgae_tpu_torch/csrc/dmv_fused.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:878",
    },
    # the inside pass alone: a block per sentence, charts in shared memory
    "dmv_inside": {
        "route": "cuda",
        "op": "vlgae::dmv_inside",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:546",
    },
    "dmv_inside_save": {
        "route": "cuda",
        "op": "vlgae::dmv_inside_save",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:555",
    },
    "dmv_outside": {
        "route": "cuda",
        "op": "vlgae::dmv_outside",
        "source": "vlgae_tpu_torch/csrc/dmv_outside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:861",
    },
    # the same two inside functions in the warp mapping (n1 <= 9) ...
    "dmv_inside_small": {
        "route": "cuda",
        "op": "vlgae::dmv_inside, vlgae::dmv_inside_save",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:569",
    },
    # ... and with charts in global memory (beyond shared memory)
    "dmv_inside_long": {
        "route": "cuda",
        "op": "vlgae::dmv_inside, vlgae::dmv_inside_save",
        "source": "vlgae_tpu_torch/csrc/dmv_inside.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:590",
    },
    "match_fwd": {
        "route": "cuda",
        "op": "vlgae::match_maxes",
        "source": "vlgae_tpu_torch/csrc/match_fwd.cu",
        "replaces": "vlgae_tpu/ops/match_pallas.py:195",
    },
    "match_bwd": {
        "route": "cuda",
        "op": "vlgae::match_maxes_bwd",
        "source": "vlgae_tpu_torch/csrc/match_bwd.cu",
        "replaces": "vlgae_tpu/ops/match_pallas.py:267",
    },
    # K7: the held experts of a granite MoE layer (no TPU kernel: the JAX
    # package has no routed encoder)
    "moe_experts": {
        "route": "cuda",
        "op": "vlgae::moe_experts",
        "source": "vlgae_tpu_torch/csrc/moe_experts.cu",
        "replaces": None,
    },
    # the data-parallel wrapper of K5/K6: a rank's captions against the
    # all-gathered images
    "match_maxes_sharded": {
        "route": "cuda",
        "op": "vlgae::match_maxes, vlgae::match_maxes_bwd",
        "source": "vlgae_tpu_torch/ops/match.py",
        "replaces": "vlgae_tpu/ops/match_pallas.py:546",
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
# the exported forward against the eager one: the same operations, bit-equal
# expected; f32 round-off of a reordered product allowed
EXPORT_ATOL, EXPORT_RTOL = 1e-5, 1e-6
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


def timed_call(fn):
    """``(fn(), ms)``: one call and its device time between two CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def upload_numbers(arr, device, reps=7):
    """One batch array uploaded two ways, each timed on the host clock (the
    call's return) and between two CUDA events around it (median of
    ``reps`` after one warm-up): from a pageable copy, as the port uploaded
    before its batches were packed into page-locked memory, and from the
    page-locked array itself with ``non_blocking=True``, as
    ``parallel.shard_batch`` uploads it. Both arrive equal to the array."""
    import numpy as np
    import torch

    from vlgae_tpu_torch.utils.pinned import pinned_rows

    src = pinned_rows(arr)
    if src is None:
        raise AssertionError(f"a batch array of {arr.nbytes} bytes is not page-locked")
    pageable = np.array(arr)

    def timed(fn):
        host, dev = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            dev.append(start.elapsed_time(end))
        if not torch.equal(out.cpu(), torch.from_numpy(pageable)):
            raise AssertionError("an upload changed the batch")
        return {"host_ms": statistics.median(host[1:]),
                "device_ms": statistics.median(dev[1:])}

    return {"bytes": int(arr.nbytes), "shape": list(arr.shape),
            "pageable": timed(lambda: torch.as_tensor(pageable).to(device)),
            "pinned": timed(lambda: src.to(device, non_blocking=True))}


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_env(state):
    import importlib.util

    import torch

    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1] if nvcc else None,
          "gpu": nvidia_smi_line(),
          "device_count": torch.cuda.device_count(),
          # the packages the JAX package reads BERT/ViT checkpoints and stop
          # words with; the port reads those formats without them
          "installed": {m: importlib.util.find_spec(m) is not None for m in (
              "transformers", "flax", "msgpack", "safetensors", "nltk")}})


def phase_build(state):
    import shutil

    from vlgae_tpu_torch.ops import _build

    from concurrent.futures import ThreadPoolExecutor

    # always from the sources: drop libraries left by an earlier run
    shutil.rmtree(_build.BUILD, ignore_errors=True)
    parent = os.path.isdir(PARENT_DMV)
    if parent:
        shutil.rmtree(os.path.join(PARENT_DMV, "_build"), ignore_errors=True)
    parent_k5 = os.path.exists(os.path.join(PARENT_MATCH, "match_fwd.cu"))
    if parent_k5:
        shutil.rmtree(os.path.join(PARENT_MATCH, "_build"), ignore_errors=True)

    def one(name):
        t0 = time.perf_counter()
        if name == "parent:match_fwd":
            state["parent_match"].build()
        elif name.startswith("parent:"):
            state["parent_dmv"].build(name[7:])
        else:
            _build.build(name, verbose=True)
        return round(time.perf_counter() - t0, 3)

    names = SOURCES + tuple(f"parent:{k}" for k in PARENT_KERNELS
                            if parent and os.path.exists(os.path.join(PARENT_DMV, f"{k}.cu")))
    names += ("parent:match_fwd",) if parent_k5 else ()
    t0 = time.perf_counter()
    if parent:
        state["parent_dmv"] = ParentDMV()
    if parent_k5:
        state["parent_match"] = ParentMatch()
    with ThreadPoolExecutor(len(names)) as pool:
        out = dict(zip(names, pool.map(one, names)))
    emit({"phase": "build", "seconds": out,
          "wall_s": round(time.perf_counter() - t0, 3),
          "parent_dmv": (f"built from {os.path.relpath(PARENT_DMV, ROOT)}" if parent
                         else f"absent: no {os.path.relpath(PARENT_DMV, ROOT)}"),
          "parent_match": (f"built from {os.path.relpath(PARENT_MATCH, ROOT)}" if parent_k5
                           else f"absent: no {os.path.relpath(PARENT_MATCH, ROOT)}")})


# Timing-only copies of the parent commit's dmv_inside.cu, dmv_fused.cu and
# dmv_common.cuh, placed by hand in this gitignored directory (`git show
# <parent>:vlgae_tpu_torch/csrc/<file>`); phases k1, k2 and k3 time them
# beside this tree's kernels in the same call when it is present. The port
# never imports them.
PARENT_DMV = os.path.join(ROOT, "_checkouts", "parent_dmv")
# each parent kernel's C interface: pointers, then ints, then the stream
PARENT_KERNELS = {"dmv_inside": (6, 7), "dmv_fused": (7, 7)}


class ParentDMV:
    """The parent's inside kernel and K1, built by nvcc from ``PARENT_DMV``
    and launched through their C interfaces by the parent's rules: for the
    inside kernel (whose interface is this tree's) mapping, threads and
    staging of the block mappings are this tree's ``inside_plan``; K1 (the
    one-barrier fills, its reductions one tree after another) keeps its
    eight charts in shared memory beside the staged potentials while they
    fit (``64*n1*(n1|1) + 8*n1*n1 + 32*n1`` bytes, n1 <= 56 on an H100),
    else in global scratch (``64*n1*n1`` bytes a sentence) with the
    potentials staged while they fit; it runs the power of two at least
    ``4*n1`` (shared) or ``6*n1`` (global) threads a block, 32 to 1024, and
    a quarter of them, at least 32, for the inside fill."""

    def __init__(self):
        self.libs = {}

    def build(self, name):
        import ctypes

        from vlgae_tpu_torch.ops import _build

        cmd = [_build.nvcc_path(), "-gencode", _build.ARCH, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
        lib = ctypes.CDLL(_build._compile(
            os.path.join(PARENT_DMV, f"{name}.cu"),
            os.path.join(PARENT_DMV, "_build", f"lib{name}.so"), cmd,
            [os.path.join(PARENT_DMV, "dmv_common.cuh")]))
        fn = getattr(lib, f"{name}_launch")
        ptrs, ints = PARENT_KERNELS[name]
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.libs[name] = fn

    def fused(self, dec, attach, lens, kind):
        import torch

        from vlgae_tpu_torch.ops import _build, dmv_cuda

        B, n1 = dec.shape[:2]
        dmv_cuda._library()  # the card's shared-memory limit
        optin = dmv_cuda._smem_optin
        pot = 8 * n1 * n1 + 32 * n1
        use_smem = 64 * n1 * (n1 | 1) + pot <= optin
        stage = use_smem or pot <= optin
        threads = min(1024, max(32, 1 << ((4 if use_smem else 6) * n1 - 1).bit_length()))
        out = torch.empty(B, device=dec.device)
        g_dec, g_attach = torch.empty_like(dec), torch.empty_like(attach)
        scratch = None if use_smem else torch.empty(B * 64 * n1 * n1, device=dec.device,
                                                    dtype=torch.uint8)
        _build.check(self.libs["dmv_fused"](
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lens), _build.ptr(out),
            _build.ptr(g_dec), _build.ptr(g_attach),
            None if scratch is None else _build.ptr(scratch), B, n1, int(kind == "max"),
            int(use_smem), int(stage), threads, max(32, threads // 4),
            _build.stream_ptr(dec.device)), "parent dmv_fused_launch")
        return out, g_dec, g_attach

    def inside(self, dec, attach, lens, kind, save):
        import torch

        from vlgae_tpu_torch.ops import _build, dmv_cuda

        B, n1 = dec.shape[:2]
        dmv_cuda._inside_library()  # the card's shared-memory limit
        plan = dmv_cuda.inside_plan(n1, dmv_cuda._smem_optin)
        mapping = plan["mapping"]
        out = torch.empty(B, device=dec.device)
        charts = torch.empty((B, 4, n1, n1, 2), device=dec.device) if save else None
        scratch = torch.empty(B * 32 * n1 * n1, device=dec.device, dtype=torch.uint8
                              ) if mapping == "global" and not save else None
        _build.check(self.libs["dmv_inside"](
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lens), _build.ptr(out),
            None if charts is None else _build.ptr(charts),
            None if scratch is None else _build.ptr(scratch), B, n1, int(kind == "max"),
            int(save), dmv_cuda.MAPPINGS.index(mapping), plan["threads"], int(plan["stage"]),
            _build.stream_ptr(dec.device)), "parent dmv_inside_launch")
        return out, charts


# A timing-only copy of the parent commit's match_fwd.cu, placed by hand in
# this gitignored directory (`git show <parent>:vlgae_tpu_torch/csrc/
# match_fwd.cu`); phase k5 (and grounding_modes, at word+alldep's Q) holds
# this tree's K5 to it bit for bit and times the two in turns when it is
# present. The port never imports it.
PARENT_MATCH = os.path.join(ROOT, "_checkouts", "parent_match")
# the parent's K5 rules: captions a block, its q-chunk builds (8-word groups)
PARENT_K5_CAP_TILE, PARENT_K5_Q_GROUPS = 4, (5, 9, 13, 15)


class ParentMatch:
    """The parent commit's K5, built by nvcc from ``PARENT_MATCH`` and launched
    through its C interface by its rules: four captions a block, ``groups =
    min(A, sms // ceil(B / 4))`` image groups, the fewest equal q-chunks of at
    most 120 words in the narrowest of its builds, 16-byte ``cp.async``
    staging when D % 8 == 0 and both operands are 16-byte aligned (else
    2-byte loads)."""

    def __init__(self):
        self.fn = None

    def build(self):
        import ctypes

        from vlgae_tpu_torch.ops import _build

        cmd = [_build.nvcc_path(), "-gencode", _build.ARCH, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
        fn = ctypes.CDLL(_build._compile(
            os.path.join(PARENT_MATCH, "match_fwd.cu"),
            os.path.join(PARENT_MATCH, "_build", "libmatch_fwd.so"), cmd)).match_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fn = fn

    def __call__(self, vis, txt, vb, tb):
        import torch

        from vlgae_tpu_torch.ops import _build
        from vlgae_tpu_torch.ops.match import match_fwd_q_tiling

        A, V, D = vis.shape
        B, Q, _ = txt.shape
        sms = torch.cuda.get_device_properties(vis.device).multi_processor_count
        groups = max(1, min(A, sms // -(-B // PARENT_K5_CAP_TILE)))
        _, nt = match_fwd_q_tiling(Q, PARENT_K5_Q_GROUPS)
        aligned = D % 8 == 0 and vis.data_ptr() % 16 == 0 and txt.data_ptr() % 16 == 0
        out = (torch.empty((B, A, Q), device=vis.device), torch.empty(
            (B, A, Q), device=vis.device, dtype=torch.int32),
               torch.empty((B, A, V), device=vis.device), torch.empty(
            (B, A, V), device=vis.device, dtype=torch.int32))
        _build.check(self.fn(*(_build.ptr(t) for t in (vis, txt, vb, tb, *out)), A, V, D, B,
                             Q, groups, nt, int(aligned), _build.stream_ptr(vis.device)),
                     "parent match_fwd_launch")
        return out


def _k5_vs_parent(state, args, got, what):
    """The parent's K5 on ``args`` against this tree's outputs ``got``:
    "equal" when all four are bit for bit the same, "not run" without its
    sources; raises when they differ."""
    import torch

    parent = state.get("parent_match")
    if parent is None:
        return "not run"
    with torch.no_grad():
        want = parent(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want)):
        raise AssertionError(f"K5's outputs differ from the parent's K5 {what}")
    return "equal"


def _k5_times(state, args):
    """``device_ms`` of this tree's K5 (``"new"``) and, when its sources are
    there, the parent's K5 (``"parent"``) on ``args``, timed in turns."""
    from vlgae_tpu_torch.ops.match import match_maxes_cuda

    fns = {"new": lambda: match_maxes_cuda(*args)}
    parent = state.get("parent_match")
    if parent is not None:
        fns["parent"] = lambda: parent(*args)
    return _in_turns(fns)


def phase_native_io(state):
    """The port's det-feature packer, built from csrc/vlgae_io.cpp on this
    machine, on the recipe's feature files (36 boxes of 2048-d features):
    bit-equal to a NumPy packing at sample=0; at sample=35 35 distinct,
    sorted rows of each image's file, the same for the same seed, others
    for another, the masks; the features land in page-locked memory; the
    pack time of 64 images."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.data import native_io
    from vlgae_tpu_torch.ops import _build
    from vlgae_tpu_torch.utils.pinned import is_pinned

    so = os.path.join(_build.BUILD, "libvlgae_io.so")
    if os.path.exists(so):
        os.remove(so)
    native_io._LIB = None
    t0 = time.perf_counter()
    native_io.load_library()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=64, feat_dim=2048, n_box=36,
                    len_range=(3, 10), seed=0)
        feat_dir = os.path.join(tmp, "vlparse", "det_feats")
        paths = sorted(os.path.join(feat_dir, f) for f in os.listdir(feat_dir))[:64]
        files = [np.load(p) for p in paths]
        P, F = 36, files[0].shape[1] - 4
        feats, boxes, mask = native_io.load_det_feats_batch(paths, P, F, 0, 0)
        want = np.zeros_like(feats), np.zeros_like(boxes), np.zeros_like(mask)
        for i, f in enumerate(files):
            n = min(len(f), P)
            want[0][i, :n], want[1][i, :n], want[2][i, :n] = f[:n, :-4], f[:n, -4:], True
        if not all(np.array_equal(g, w) for g, w in zip((feats, boxes, mask), want)):
            raise AssertionError("native_io: sample=0 differs from the NumPy packing")
        if not is_pinned(feats):
            raise AssertionError("native_io: the features are not in page-locked memory")
        drawn = native_io.load_det_feats_batch(paths, P, F, 35, 12345)
        again = native_io.load_det_feats_batch(paths, P, F, 35, 12345)
        other = native_io.load_det_feats_batch(paths, P, F, 35, 54321)
        if not all(np.array_equal(a, b) for a, b in zip(drawn, again)):
            raise AssertionError("native_io: the same seed drew other rows")
        if np.array_equal(drawn[0], other[0]):
            raise AssertionError("native_io: another seed drew the same rows")
        for i, f in enumerate(files):
            if not (drawn[2][i, :35].all() and not drawn[2][i, 35:].any()):
                raise AssertionError(f"native_io: image {i}'s mask {drawn[2][i]}")
            rows = [int(np.flatnonzero((f[:, :-4] == r).all(1))[0]) for r in drawn[0][i, :35]]
            if rows != sorted(set(rows)) or not np.array_equal(drawn[1][i, :35], f[rows, -4:]):
                raise AssertionError(f"native_io: image {i} drew rows {rows}")

        def pack_ms(pack):
            times = []
            for k in range(6):
                t0 = time.perf_counter()
                pack(k)
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times[1:])

        def numpy_pack(_):
            out = np.zeros((len(paths), P, F), np.float32)
            for i, path in enumerate(paths):
                out[i] = np.load(path)[:P, :-4]

        emit({"phase": "native_io", "build_s": round(build_s, 3), "library": so,
              "sample0_equals_numpy": True, "sample35_rows_distinct_sorted": True,
              "pinned": True, "bytes_B64": int(feats.nbytes),
              "pack_ms_B64": {
                  "sample35": pack_ms(lambda k: native_io.load_det_feats_batch(
                      paths, P, F, 35, k)),
                  "sample0": pack_ms(lambda k: native_io.load_det_feats_batch(
                      paths, P, F, 0, k)),
                  # np.load of the same files into one array, for scale
                  "numpy_first_rows": pack_ms(numpy_pack)},
              "shape": {"B": 64, "P": P, "feat": F}})


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


def fused_steps(n1, kind):
    """Dependent width steps of K1 over a sentence of ``n1 - 1`` words: the
    one-barrier inside pass (one a width) and outside pass (one a width, and
    width 0 too in log)."""
    return 2 * (n1 - 1) + (kind == "log")


def _in_turns(fns):
    """``device_ms`` of each of ``fns`` (a dict), timed in turns A B C ... C B
    A and averaged over its two turns, so that a drift of the card's clock
    during the run weighs on all alike."""
    names = list(fns)
    first = {k: device_ms(fns[k]) for k in names}
    second = {k: device_ms(fns[k]) for k in reversed(names)}
    return {k: (first[k] + second[k]) / 2 for k in names}


def _k1_against_pair(dec, attach, lens, kind, got):
    """K1's outputs ``got`` against the pair (``dmv_inside_save`` +
    ``dmv_outside``) at a cotangent of one: bit-equal in the max semiring,
    within K1's tolerances in log. Returns the largest difference."""
    import torch

    from vlgae_tpu_torch.ops.dmv_cuda import dmv_inside_save, dmv_outside

    total, charts = dmv_inside_save(dec, attach, lens, kind)
    ones = torch.ones_like(total)
    pair = (total, *dmv_outside(dec, attach, lens, ones, total, charts, kind))
    torch.cuda.synchronize()
    if kind == "max":
        ok = all(torch.equal(a, b) for a, b in zip(got, pair))
    else:
        ok = close(got[0], pair[0], K1_TOTAL_ATOL, K1_TOTAL_RTOL) and all(
            close(a, b, K1_GRAD_ATOL, K1_GRAD_RTOL) for a, b in zip(got[1:], pair[1:]))
    err = max(float((a - b).abs().max()) for a, b in zip(got, pair))
    if not ok:
        raise AssertionError(f"K1 and the pair at gout = 1 differ ({kind}): {err}")
    return err


def phase_k1(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused, dmv_inside_save, dmv_outside
    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    recipe = rng.integers(1, 51, 64)
    recipe[:3] = (1, 50, 0)  # length 1, the longest, a zero-length filler
    # exp=vlgae_vit trains on captions of up to 63 words: n1 = 65, past the
    # shared-memory limit of K1's eight charts, so K1 keeps its inside
    # charts in shared memory and its adjoint charts in global scratch
    vit = rng.integers(1, 65, 64)
    vit[:3] = (64, 1, 0)
    # exp=lang_only on captions of 86-100 words: n1 = 101, global scratch
    long = rng.integers(86, 101, 64)
    long[0] = 100
    # the first and the last n1 of the split placement (57 and 75, odd: one
    # pitch), and an even n1 between (pitch 75 in shared memory, 74 in scratch)
    first, last = rng.integers(1, 57, 64), rng.integers(1, 75, 64)
    first[:3], last[:3] = (56, 1, 0), (74, 1, 0)
    cases = {
        "B64_len1-50": (recipe, 51, "smem"),
        "B16_len-to-80": (np.r_[80, 0, 1, rng.integers(51, 81, 13)], 81, "global"),
        "B16_n1-lt-10": (np.r_[0, 1, 8, rng.integers(0, 9, 13)], 9, "smem"),
        "B64_len1-64_split": (vit, 65, "split"),
        "B64_len86-100_global": (long, 101, "global"),
        "B64_len1-56_split": (first, 57, "split"),
        "B16_len-to-73_split": (np.r_[73, 0, 1, rng.integers(1, 74, 13)], 74, "split"),
        "B64_len1-74_split": (last, 75, "split"),
    }
    parent = state.get("parent_dmv")
    parent_fused = parent is not None and "dmv_fused" in parent.libs
    dmv_cuda._library()  # the card's shared-memory limit, for the rule

    def parent_vs_new(new, old):
        """The largest difference of K1's three outputs from the parent's,
        and whether every bit is the same."""
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(new, old))
        return max(float((a - b).abs().max()) for a, b in zip(new, old)), same

    worst = 0.0
    differ = []  # cases whose bits differ from the parent's K1
    result = {"phase": "k1", "cases": {}}
    for name, (lengths, n1, mapping) in cases.items():
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        plan = dmv_cuda.fused_plan(n1, dmv_cuda._smem_optin)
        if plan["mapping"] != mapping:
            raise AssertionError(f"K1 {name}: the rule names {plan}, not {mapping}")
        for kind in ("log", "max"):
            c0 = dmv_cuda.launch_counts()
            kt, kd, ka = dmv_fused(dec, attach, lens, kind)
            again = dmv_fused(dec, attach, lens, kind)
            c1 = dmv_cuda.launch_counts()
            moved = {m: c1[f"fused_{m}"] - c0[f"fused_{m}"] for m in ("global", "split")}
            moved["smem"] = c1["fused"] - c0["fused"] - sum(moved.values())
            if moved != {m: 2 * (m == mapping) for m in moved}:
                raise AssertionError(f"K1 {name}/{kind} did not take the {mapping} "
                                     f"mapping: launches {moved}")
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
            errs = {"mapping": mapping, "total": float(e_tot.max()), "g_dec": e_d,
                    "g_attach": e_a,
                    "vs_pair_at_gout_1": _k1_against_pair(dec, attach, lens, kind,
                                                          (kt, kd, ka))}
            if parent_fused:
                errs["parent_vs_new"], same = parent_vs_new(
                    (kt, kd, ka), parent.fused(dec, attach, lens, kind))
                if not same:
                    differ.append(f"{name}/{kind}")
            if kind == "log" and n1 == 101:
                # the long-caption path against the plain version in f64,
                # whose round-off is far below the tolerance
                want = [x.float() for x in dmv_value_and_grads_plain(
                    dec, attach, lens, kind, torch.float64)]
                excess = max(float(((k - w).abs() / (K1_GRAD_ATOL + K1_GRAD_RTOL * w.abs())).max())
                             for k, w in ((kd, want[1]), (ka, want[2])))
                errs["f64"] = {"total": float((kt - want[0]).abs().max()),
                               "g_dec": float((kd - want[1]).abs().max()),
                               "g_attach": float((ka - want[2]).abs().max()),
                               "worst_err_over_tolerance": excess}
                ok_grads = ok_grads and excess <= 1.0 and close(
                    kt, want[0], K1_TOTAL_ATOL, K1_TOTAL_RTOL)
            result["cases"][f"{name}/{kind}"] = errs
            worst = max(worst, e_d, e_a)
            if not (ok_tot and ok_grads):
                emit(result)
                raise AssertionError(f"K1 {name}/{kind} disagrees: {errs}")
    # the new K1, the parent's K1 and the pair at gout = 1 on the same draws,
    # in one call; the plain version beside them
    timed = {17: _ragged(rng, 17), 51: recipe, 57: first, 65: vit, 75: last, 101: long}
    timing = {}
    for n1, lengths in timed.items():
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        row = {"plan": dmv_cuda.fused_plan(n1, dmv_cuda._smem_optin),
               "dependent_steps": {k: fused_steps(n1, k) for k in ("max", "log")},
               **dmv_bound(lengths, n1, "fused")}
        for kind in ("log", "max"):
            total, charts = dmv_inside_save(dec, attach, lens, kind)
            ones = torch.ones_like(total)
            fns = {"ms": lambda: dmv_fused(dec, attach, lens, kind),
                   "save_ms": lambda: dmv_inside_save(dec, attach, lens, kind),
                   "outside_ms": lambda: dmv_outside(dec, attach, lens, ones, total, charts,
                                                     kind)}
            if parent_fused:
                fns = {"parent_ms": lambda: parent.fused(dec, attach, lens, kind), **fns}
            t = _in_turns(fns)
            t["pair_ms"] = t["save_ms"] + t["outside_ms"]
            t["call_ms"] = time_ms(lambda: dmv_fused(dec, attach, lens, kind))
            t["plain_ms"] = time_ms(lambda: dmv_value_and_grads_plain(dec, attach, lens, kind),
                                    reps=3, warmup=1)
            t["ms_per_step"] = t["ms"] / fused_steps(n1, kind)
            if parent_fused:
                t["parent_vs_new"], same = parent_vs_new(
                    dmv_fused(dec, attach, lens, kind), parent.fused(dec, attach, lens, kind))
                if not same:
                    differ.append(f"timed n1={n1}/{kind}")
            row[kind] = t
        timing[f"n1={n1}"] = row
    result["timing_B64"] = timing
    result["parent"] = ("ran: the parent commit's dmv_fused.cu and dmv_common.cuh from "
                        f"{os.path.relpath(PARENT_DMV, ROOT)}, in this call" if parent_fused
                        else f"not run: no parent dmv_fused.cu in "
                        f"{os.path.relpath(PARENT_DMV, ROOT)}")
    result["tolerance"] = {"total": [K1_TOTAL_ATOL, K1_TOTAL_RTOL],
                           "grads": [K1_GRAD_ATOL, K1_GRAD_RTOL],
                           "vs_pair_at_gout_1": {"max": "bit-equal", "log": "as grads"},
                           "parent_vs_new": "bit-equal"}
    emit(result)
    if differ:
        raise AssertionError(f"K1's bits differ from the parent's K1 on {differ}")

    def summary(n1, lengths):
        t = timing[f"n1={n1}"]
        b = dmv_bound(lengths, n1, "fused")
        return {
            # one launch of each semiring, as the joint model's language
            # factors run; "ms" is one call between two events, "device_ms"
            # launches queued behind a spinning device
            "ms": t["log"]["call_ms"] + t["max"]["call_ms"],
            "plain_ms": t["log"]["plain_ms"] + t["max"]["plain_ms"],
            **b, "bound_ms": 2 * b["bound_ms"],
            **{f"{k}_{kind}": t[kind][src] for kind in ("log", "max")
               for k, src in (("ms", "call_ms"), ("device_ms", "ms"), ("plain_ms", "plain_ms"),
                              ("pair_ms", "pair_ms"), ("parent_ms", "parent_ms"))
               if src in t[kind]},
            "dependent_steps": t["dependent_steps"], "mapping": t["plan"]["mapping"]}

    state["dmv_fused"] = {"max_abs_err": worst, "library_ms": None, **summary(51, recipe),
                          **{f"at_n1_{n1}": summary(n1, timed[n1])
                             for n1 in (17, 57, 65, 75, 101)}}


def _check_k5(args, exact, what):
    """K5 against its plain version on ``args`` = (vis, txt, vis_bias,
    txt_bias): all four outputs equal when ``exact``; otherwise values
    within tolerance, and an index may differ only where the two winners
    tie within tolerance. Returns the kernel's outputs, the max value
    errors and the index mismatch counts."""
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_cuda, match_maxes_plain

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
    return k, errs, _check_k5_indices(k, p, args, exact, what)


def _check_k5_indices(k, p, args, exact, what):
    """The winner indices of K5's outputs ``k`` against the plain version's
    ``p`` on ``args``: equal when ``exact``; otherwise an index may differ
    only where the two winners tie within tolerance. Returns the mismatch
    counts."""
    import torch

    vis, txt, vb, tb = args

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
    return off


# (A, V, B, Q, D) that hit the edges of K5's tiles: chunks of 104 words (the
# wgmma's N), stages of 64 image rows (its M), 2 and 4 captions a block,
# k-steps of 16 and stages of 128, 50 caption tiles, so that 2 blocks share
# 5 images, the other builds (one chunk of 40 words, of 72, of 120, of 136),
# each side of the widest (136 and 137 words: one chunk and two), an odd
# number of tiles a block, and the other kernel (D = 130 and 384)
K5_EDGES = ((5, 65, 62, 202, 130), (2, 15, 1, 7, 8), (3, 63, 5, 103, 128),
            (3, 64, 4, 104, 128), (3, 65, 7, 105, 128), (2, 20, 3, 9, 384),
            (5, 70, 200, 9, 16), (3, 65, 6, 34, 128), (3, 65, 6, 66, 128),
            (2, 70, 5, 114, 128), (3, 1324, 5, 130, 128), (3, 1275, 5, 129, 128),
            (2, 130, 3, 136, 128), (2, 130, 3, 137, 128), (3, 193, 7, 130, 64))
# the patch grid of exp=vlgae_vit (49 patches, their pairs, attributes and
# the image): V in training (inclusive pair triangle) and in evaluation
# (strict), beside its longest captions (63 words: Q = 130, one q-chunk of 136)
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


def _k5_bound(A, V, B, Q, D):
    """K5's bound: bf16 operands and f32 masks read once, four [B, A, Q|V]
    outputs written once, a multiply-add per (a, b, q, v, d) at the bf16
    peak."""
    return bound(2 * (A * V + B * Q) * D + 4 * (A * V + B * Q) + 8 * B * A * (Q + V),
                 2 * A * B * Q * V * D, "bf16")


def _k5_row(state, args, what, errs=None, off=None, plain_reps=5):
    """One timed K5 row on ``args``: the plan, this tree's and the parent's
    K5 in turns (``device_ms``, ``parent_device_ms``), one call between two
    events, the plain version, one bf16 ``torch.matmul`` of the product (it
    stores ``[B*Q, A*V]`` and takes no maxes; the port never calls it) and
    the bound."""
    import torch

    from vlgae_tpu_torch.ops.match import match_fwd_plan, match_maxes_cuda, match_maxes_plain

    vis, txt = args[:2]
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    x, y = txt.reshape(B * Q, D), vis.reshape(A * V, D)
    turns = _k5_times(state, args)
    row = {"A": A, "V": V, "B": B, "Q": Q, "D": D,
           "plan": match_fwd_plan(A, V, B, Q, D, vis.data_ptr(), txt.data_ptr(),
                                  torch.cuda.get_device_properties(vis.device)
                                  .multi_processor_count),
           "device_ms": turns["new"], "parent_device_ms": turns.get("parent"),
           "ms": time_ms(lambda: match_maxes_cuda(*args)),
           "plain_ms": time_ms(lambda: match_maxes_plain(*args), reps=plain_reps, warmup=1),
           "product_only_library_ms": device_ms(lambda: torch.matmul(x, y.T), n=10),
           **_k5_bound(A, V, B, Q, D)}
    if errs is not None:
        row.update({"max_abs_err": errs, "index_mismatch_within_tol": off})
    return row


def phase_k5(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.ops.match import match_fwd_plan

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    A = B = 64
    Q, D = 102, 128
    vs_parent = {}
    # exact agreement, indices included, at the tiles' edges ...
    for shape in K5_EDGES:
        what = "at A={}, V={}, B={}, Q={}, D={}".format(*shape)
        args = _k5_inputs(rng, *shape, dev, "quarter")
        got = _check_k5(args, True, what)[0]
        vs_parent[what] = _k5_vs_parent(state, args, got, what)
    # ... and where nearly every maximum is tied and whole rows and columns
    # are masked (index 0 on those), on both kernels, at the widest build too
    tie_shapes = ((6, 130, 7, 110, 8), (6, 130, 7, 130, 128), (3, 70, 5, 110, 130))
    for tie_shape in tie_shapes:
        what = "on tied and wholly masked operands at A={}, V={}, B={}, Q={}, D={}".format(
            *tie_shape)
        args = _k5_inputs(rng, *tie_shape, dev, "ties")
        got = _check_k5(args, True, what)[0]
        _, li, _, lvi = got
        if int(li[:, 0].max()) != 0 or int(lvi[tie_shape[2] - 1].max()) != 0:
            raise AssertionError("K5: a wholly masked row or column did not give index 0")
        vs_parent[what] = _k5_vs_parent(state, args, got, what)
    timing = {}
    for V in (703, 739):  # the eval and the training shape
        args = _k5_inputs(rng, A, V, B, Q, D, dev, "random")
        got, errs, off = _check_k5(args, False, f"at V={V}")
        vs_parent[f"at V={V}, Q={Q}"] = _k5_vs_parent(state, args, got, f"at V={V}")
        timing[V] = _k5_row(state, args, f"V={V}", errs, off)
    # captions are padded to multiples of 8 words and Q = 2 * (length + 1): a
    # short batch (16 words), a middling one (32) and the longest of the
    # recipe (56 words: one chunk of 120) at the training V, beside the 51
    # positions the kernels are quoted at
    by_q = {}
    for q in (34, 66, 114):
        args = _k5_inputs(rng, A, 739, B, q, D, dev, "random")
        got = _check_k5(args, False, f"at V=739, Q={q}")[0]
        vs_parent[f"at V=739, Q={q}"] = _k5_vs_parent(state, args, got, f"at V=739, Q={q}")
        by_q[q] = _k5_row(state, args, f"Q={q}", plain_reps=3)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    at_vit = {}
    for what, V in VIT_V.items():
        args = _k5_inputs(rng, A, V, B, VIT_Q, D, dev, "random")
        chunks = match_fwd_plan(A, V, B, VIT_Q, D, args[0].data_ptr(), args[1].data_ptr(),
                                sm_count)["q_chunks"]
        before = match.launch_counts()["fwd_by_q_chunks"].get(chunks, 0)
        got, errs, off = _check_k5(args, False, f"at V={V}, Q={VIT_Q}")
        if match.launch_counts()["fwd_by_q_chunks"].get(chunks, 0) != before + 1:
            raise AssertionError(f"K5 at V={V}, Q={VIT_Q} did not take the plan's "
                                 f"{chunks} q-chunk(s)")
        vs_parent[f"at V={V}, Q={VIT_Q}"] = _k5_vs_parent(state, args, got,
                                                          f"at V={V}, Q={VIT_Q}")
        at_vit[what] = _k5_row(state, args, what, errs, off)
    plan = match_fwd_plan(A, 703, B, Q, D, sm_count=sm_count)
    emit({"phase": "k5", "shape": {"A": A, "B": B, "Q": Q, "V": [703, 739], "D": D},
          "instruction": "wgmma.mma_async.sync.aligned.m64n{}k16.f32.bf16.bf16".format(
              plan["q_chunk_words"]),
          "plan_V703": plan, "exact_at": [list(sh) for sh in K5_EDGES],
          "exact_on_ties_at": [list(sh) for sh in tie_shapes], "timing": timing,
          "timing_V739_by_Q": by_q, "timing_vit": at_vit,
          "parent_vs_new": vs_parent, "tolerance": [K5_ATOL, K5_RTOL]})
    _k5_shards(state, rng, dev)
    t = timing[703]
    state["match_fwd"] = {
        "max_abs_err": max(max(timing[V]["max_abs_err"].values()) for V in timing),
        "max_abs_err_unmasked": max(v for V in timing for k, v in
                                    timing[V]["max_abs_err"].items() if "unmasked" in k),
        "ms": t["ms"], "device_ms": t["device_ms"], "parent_device_ms": t["parent_device_ms"],
        "plain_ms": t["plain_ms"], "library_ms": None,
        "product_only_library_ms": t["product_only_library_ms"],
        "ms_V739": timing[739]["ms"], "device_ms_V739": timing[739]["device_ms"],
        **{k: t[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops")},
        "parent_vs_new": sorted(set(vs_parent.values())),
        "at_vit_shapes": {what: {k: v for k, v in r.items() if k != "plan"}
                          for what, r in at_vit.items()}}


# a data-parallel step's shards: every image (A = 64) against one rank's
# captions at world 2, 4 and 8, at the recipe's longest captions
SHARD_A, SHARD_V, SHARD_Q, SHARD_D = 64, 739, 114, 128
SHARD_BS = (32, 16, 8)


def _k5_shards(state, rng, dev):
    """K5 at A != B: each rank's captions against all 64 images. The shards'
    outputs, concatenated over the ranks, equal K5 on the whole batch exactly
    (quarter-integer and normal operands); each shard is held against the
    plain version and the parent's K5 (bit for bit); each shard's time in
    turns with the parent's, beside its bound and one bf16 matmul of its
    product."""
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_cuda

    A, V, Q, D = SHARD_A, SHARD_V, SHARD_Q, SHARD_D
    out, vs_parent = {}, {}
    for kind in ("quarter", "random"):
        vis, txt, vb, tb = _k5_inputs(rng, A, V, A, Q, D, dev, kind)
        with torch.no_grad():
            whole = match_maxes_cuda(vis, txt, vb, tb)
        for Bl in SHARD_BS:
            parts, errs = [], 0.0
            for r in range(A // Bl):
                rows = slice(r * Bl, (r + 1) * Bl)
                args = (vis, txt[rows].contiguous(), vb, tb[rows].contiguous())
                what = f"on caption shard {r} of {A // Bl} ({kind})"
                k, err, _ = _check_k5(args, kind == "quarter", what)
                vs_parent[what] = _k5_vs_parent(state, args, k, what)
                parts.append(k)
                errs = max(errs, err["logit_unmasked"], err["logit_v_unmasked"])
            for name, i in (("logit", 0), ("logit_idx", 1), ("logit_v", 2), ("logit_v_idx", 3)):
                if not torch.equal(torch.cat([p[i] for p in parts]), whole[i]):
                    raise AssertionError(f"K5's {name} over {A // Bl} caption shards "
                                         f"differs from the whole batch's ({kind})")
            if kind == "random":
                args = (vis, txt[:Bl].contiguous(), vb, tb[:Bl].contiguous())
                row = _k5_row(state, args, f"shard B={Bl}", plain_reps=3)
                out[Bl] = {"world": A // Bl, "max_abs_err_unmasked": errs,
                           **{k: v for k, v in row.items() if k != "plan"},
                           "grid": row["plan"]["grid"]}
    emit({"phase": "k5", "shards": out, "concatenation_exact": True,
          "parent_vs_new": vs_parent,
          "gathered_bytes_per_step": A * V * D * 2 + A * V * 4})
    state["match_maxes_sharded"] = {
        "k5_by_world": {out[b]["world"]: {k: out[b][k] for k in
                                          ("ms", "device_ms", "parent_device_ms", "plain_ms",
                                           "product_only_library_ms", "bound_ms")}
                        for b in out}}


def _k6_shards(state, rng, dev):
    """K6 at A != B: each rank's backward (all images, its captions). The
    ranks' ``dvis`` summed (what the reduce-scatter sums) equals the whole
    batch's within the bf16 roundings of the partial sums and of the whole
    (the unit roundoff 2^-8 of each partial's and of the whole's magnitude,
    plus K6's f32 tolerance); ``dtxt``
    concatenated equals the whole batch's exactly; each shard is held to the
    plain version; each shard's time beside its bound."""
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_bwd_cuda, match_maxes_bwd_plain

    A, V, Q, D = SHARD_A, SHARD_V, SHARD_Q, SHARD_D
    vis, txt, li, lvi, dm, dmv = _match_bwd_inputs(rng, A, V, A, Q, D, dev, "random")
    whole_dvis, whole_dtxt = match_maxes_bwd_cuda(vis, txt, li, lvi, dm, dmv)
    out = {}
    for Bl in SHARD_BS:
        dvis = torch.zeros(vis.shape, dtype=torch.float32, device=dev)
        mag = whole_dvis.float().abs()
        dtxt, err = [], 0.0
        for r in range(A // Bl):
            rows = slice(r * Bl, (r + 1) * Bl)
            args = (vis, txt[rows].contiguous(), li[rows].contiguous(),
                    lvi[rows].contiguous(), dm[rows].contiguous(), dmv[rows].contiguous())
            err = max(err, _check_k6(args, False, f"on caption shard {r} of {A // Bl}"))
            part, t = match_maxes_bwd_cuda(*args)
            dvis += part.float()
            mag += part.float().abs()
            dtxt.append(t)
        gap = (dvis - whole_dvis.float()).abs()
        if not bool((gap <= 2.0 ** -8 * mag + K6_ATOL).all()):
            raise AssertionError(f"K6's dvis summed over {A // Bl} shards differs from the "
                                 f"whole batch's: max {float(gap.max())}")
        if not torch.equal(torch.cat(dtxt), whole_dtxt):
            raise AssertionError(f"K6's dtxt over {A // Bl} shards differs from the whole's")
        args = (vis, txt[:Bl].contiguous(), li[:Bl].contiguous(), lvi[:Bl].contiguous(),
                dm[:Bl].contiguous(), dmv[:Bl].contiguous())
        out[Bl] = {"world": A // Bl, "max_abs_err": err, "dvis_sum_max_gap": float(gap.max()),
                   "dvis_sum_gap_over_magnitude": float((gap / mag.clamp_min(1e-30)).max()),
                   "ms": time_ms(lambda: match_maxes_bwd_cuda(*args)),
                   "device_ms": device_ms(lambda: match_maxes_bwd_cuda(*args), n=10),
                   "plain_ms": time_ms(lambda: match_maxes_bwd_plain(*args), reps=3, warmup=1),
                   # the two bf16 products over the dense winner weight
                   "product_only_library_ms": k6_product_library_ms(*args),
                   **_k6_bound(*args)}
    emit({"phase": "k6", "shards": out, "shape": {"A": A, "Q": Q, "V": V, "D": D},
          "dtxt_concatenation_exact": True})
    state["match_maxes_sharded"]["k6_by_world"] = {
        out[b]["world"]: {k: out[b][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "product_only_library_ms",
                                                 "dvis_sum_max_gap")} for b in out}


def _sharded_wrapper(state, rng, dev):
    """``match_maxes_sharded`` itself on the card: each rank's call after
    the gather (all 64 images, its captions; no group on one card), forward
    and backward through autograd, held against the plain versions on the
    same shard. On quarter-integer operands and cotangents, for every shard
    at world 2, 4 and 8, all four outputs and both gradients are equal. On
    normal ones (a rank's shard at each world) the values are within K5's
    tolerance, an index differs only at a tie, and the gradients are within
    K6's tolerance of the plain backward routed by the wrapper's own
    winners. Timed (forward and backward) at world 2 beside the sum of K5's
    and K6's bounds."""
    import torch

    from vlgae_tpu_torch.ops.match import (match_maxes_bwd_plain, match_maxes_plain,
                                           match_maxes_sharded)

    A, V, Q, D = SHARD_A, SHARD_V, SHARD_Q, SHARD_D

    def wrapper(vis, txt, vb, tb, dm, dmv):
        vis, txt = vis.detach().requires_grad_(True), txt.detach().requires_grad_(True)
        out = match_maxes_sharded(vis, txt, vb, tb, None)
        ((out[0] * dm).sum() + (out[2] * dmv).sum()).backward()
        return (*(o.detach() for o in out), vis.grad, txt.grad)

    def plain(vis, txt, vb, tb, dm, dmv):
        out = match_maxes_plain(vis, txt, vb, tb)
        return (*out, *match_maxes_bwd_plain(vis, txt, out[1], out[3], dm, dmv))

    names = ("logit", "logit_idx", "logit_v", "logit_v_idx", "dvis", "dtxt")
    errs, ties = dict.fromkeys(("logit", "logit_v", "dvis", "dtxt"), 0.0), {}
    for kind in ("quarter", "random"):
        vis, txt, vb, tb = _k5_inputs(rng, A, V, A, Q, D, dev, kind)
        draw = ((lambda *sh: rng.integers(-8, 9, sh) * 0.25) if kind == "quarter"
                else lambda *sh: rng.standard_normal(sh))
        dm = torch.tensor(draw(A, A, Q), dtype=torch.float32, device=dev)
        dmv = torch.tensor(draw(A, A, V), dtype=torch.float32, device=dev)
        for Bl in SHARD_BS:
            for r in range(A // Bl) if kind == "quarter" else (0,):
                rows = slice(r * Bl, (r + 1) * Bl)
                args = (vis, txt[rows].contiguous(), vb, tb[rows].contiguous(),
                        dm[rows].contiguous(), dmv[rows].contiguous())
                what = f"on caption shard {r} of {A // Bl} ({kind})"
                got = wrapper(*args)
                with torch.no_grad():
                    want = plain(*args)
                    if kind == "random":  # the backward routed by the wrapper's winners
                        ties[A // Bl] = _check_k5_indices(got, want, args[:4], False, what)
                        want = (*want[:4], *match_maxes_bwd_plain(
                            args[0], args[1], got[1], got[3], args[4], args[5]))
                for name, g, w in zip(names, got, want):
                    if kind == "quarter":
                        ok = torch.equal(g, w)
                    elif name.endswith("idx"):
                        continue
                    else:
                        g, w = g.float(), w.float()
                        live = w > -1e8  # a masked cell sits near -1e9
                        errs[name] = max(errs[name], float((g - w)[live].abs().max()))
                        ok = (close(g, w, K5_ATOL, K5_RTOL) if name.startswith("logit")
                              else close(g, w, K6_ATOL, K6_RTOL))
                    if not ok:
                        raise AssertionError(f"match_maxes_sharded's {name} disagrees "
                                             f"with the plain version {what}")
    Bl = SHARD_BS[0]
    args = (vis, txt[:Bl].contiguous(), vb, tb[:Bl].contiguous(), dm[:Bl].contiguous(),
            dmv[:Bl].contiguous())
    out = match_maxes_plain(*args[:4])
    k5 = _k5_bound(A, V, Bl, Q, D)
    k6 = _k6_bound(args[0], args[1], out[1], out[3], args[4], args[5])
    state["match_maxes_sharded"].update({
        "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "library_ms": None, "index_ties_by_world": ties,
        "what": "one rank's forward and backward at world 2 (all 64 images, its 32 "
                "captions) through autograd; the all-gather and reduce-scatter of the "
                "images are not in it (one card)",
        "ms": time_ms(lambda: wrapper(*args)),
        "device_ms": device_ms(lambda: wrapper(*args), n=10),
        "plain_ms": time_ms(lambda: plain(*args), reps=3, warmup=1),
        **bound(k5["bound_bytes"] + k6["bound_bytes"], k5["bound_ops"] + k6["bound_ops"],
                "bf16"),
        "k5_bound_ms": k5["bound_ms"], "k6_bound_ms": k6["bound_ms"]})
    emit({"phase": "k6", "sharded_wrapper": {
        k: state["match_maxes_sharded"][k] for k in
        ("max_abs_err_by_output", "index_ties_by_world", "ms", "device_ms", "plain_ms",
         "bound_ms", "bound_by")}, "shards_exact_on_quarter": list(SHARD_BS)})


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
    """K6's yardstick: the two bf16 ``torch.matmul`` products over a dense
    bf16 winner weight W (the two cotangents scattered onto their winning
    cells and added in bf16; a matmul's time does not depend on the
    values), prebuilt outside the timed region in the layouts they need,
    ``[A·V, B·Q] @ txt`` and ``[B·Q, A·V] @ vis``: at most two copies of
    W are alive at once. The port never calls them."""
    import torch

    A, V, D = vis.shape
    B, Q, _ = txt.shape
    torch.cuda.empty_cache()
    w = torch.zeros(B, A, Q, V, device=vis.device, dtype=torch.bfloat16)
    w.scatter_add_(3, li.long()[..., None], dm.bfloat16()[..., None])
    w.scatter_add_(2, lvi.long()[:, :, None, :], dmv.bfloat16()[:, :, None, :])
    w_vis = w.permute(1, 3, 0, 2).reshape(A * V, B * Q).contiguous()
    del w
    w_txt = w_vis.view(A, V, B, Q).permute(2, 3, 0, 1).reshape(B * Q, A * V).contiguous()
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
    _k6_shards(state, rng, dev)
    _sharded_wrapper(state, rng, dev)
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
    from vlgae_tpu_torch.ops.match import (match_bwd_plan, match_maxes_bwd_cuda,
                                           match_maxes_bwd_plain)

    vis, txt, li, lvi, dm, dmv = args
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    plan = match_bwd_plan(A, V, B, Q, D, vis.data_ptr(), txt.data_ptr())
    out = {"ms": time_ms(lambda: match_maxes_bwd_cuda(*args)),
           "device_ms": device_ms(lambda: match_maxes_bwd_cuda(*args), n=20),
           "kernels_ms": k6_kernels_ms(args),
           "plain_ms": time_ms(lambda: match_maxes_bwd_plain(*args), reps=5, warmup=1),
           "product_only_library_ms": k6_product_library_ms(*args),
           "list_lengths": k6_list_stats(li, lvi), "plan": plan,
           "scratch_bytes": plan["bytes"]}
    return {**out, **_k6_bound(*args)}


def _k6_bound(vis, txt, li, lvi, dm, dmv):
    """K6's bound for what these winners need: one multiply-add per feature
    and output (dvis, dtxt) for each distinct winning cell (b, a, q, v)."""
    import torch

    A, V, D = vis.shape
    B, Q, _ = txt.shape
    dev = vis.device
    ba = torch.arange(B * A, device=dev).view(B, A, 1)
    q_side = (ba * Q + torch.arange(Q, device=dev)) * V + li.long()
    v_side = (ba * Q + lvi.long()) * V + torch.arange(V, device=dev)
    cells = int(torch.unique(torch.cat([q_side.flatten(), v_side.flatten()])).numel())
    return {"winning_cells": cells,
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


def check_eval(root, pred_file):
    """``eval.py`` on a prediction file against the corpus at ``root``; its
    last line, or a failure when it exits non-zero."""
    ev = subprocess.run(
        [sys.executable, os.path.join(ROOT, "eval.py"), "--file", pred_file,
         "--dataroot", root], capture_output=True, text=True)
    if ev.returncode != 0:
        raise AssertionError(f"eval.py rc {ev.returncode}: {ev.stderr[-2000:]}")
    return ev.stdout.strip().splitlines()[-1]


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
    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # 104 images: 520 train, 260 dev and 260 test captions
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048,
                    n_box=36, len_range=(3, 50), seed=0)
        t_corpus = time.perf_counter() - t0
        overrides = _corpus_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1"
            for s in ("train", "dev", "test")] + ["init_seed=0", "device=cuda"]
        dmv_cuda.reset_launch_counts()
        match.reset_launch_counts()
        t0 = time.perf_counter()
        pipe, results = _run_predict(tmp, overrides)
        torch.cuda.synchronize()
        t_predict = time.perf_counter() - t0
        launches = {"dmv_fused": dmv_cuda.launch_counts()["fused"],
                    "match_fwd": match.launch_counts()["fwd"]}
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
            inputs = shard_batch(xp, pipe.dp)
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
        dmv_cuda.reset_launch_counts()
        match.reset_launch_counts()
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            pipe, test = train.main(overrides)
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        m = match.launch_counts()
        launches = {"dmv_fused": dmv_cuda.launch_counts()["fused"], "match_fwd": m["fwd"],
                    "match_bwd": m["bwd"]}
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
        upload = upload_numbers(xp["vis_box_feat"], pipe.device)
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
              "box_feat_upload_B64": upload,
              "shape": {"len": "3-50", "B": 64, "P": 36, "feat": 2048,
                        "precision": "bf16"}})
        for name, n in launches.items():
            state.setdefault(name, {}).setdefault("launches_by_path", {})[
                "vlgae_train"] = n
        state["train_step_ms"] = step_s * 1e3


def phase_export(state):
    """``export_forward`` / ``load_forward`` of the joint model at the
    recipe's widths (bf16), B = 64, on the card."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.predict import build_pipeline
    from vlgae_tpu_torch.training.export import KEYS, export_forward, load_forward
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    def counts():
        return {"dmv_fused": dmv_cuda.launch_counts()["fused"],
                "match_fwd": match.launch_counts()["fwd"]}

    def host_ms(fn, reps=7):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048,
                    n_box=36, len_range=(3, 50), seed=0)
        pipe = build_pipeline(_corpus_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1" for s in ("train", "dev", "test")],
            device="cuda", init_seed=0)
        x = next(b for b, _ in pipe.dm.batches("dev", shuffle=False)
                 if len(b["seq_len"]) == 64)
        x = {k: v for k, v in pad_batch_pow2(x)[0].items() if v.dtype != object}
        path = os.path.join(tmp, "forward.pt2")
        t0 = time.perf_counter()
        n_bytes = export_forward(pipe.model, x, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = load_forward(path)
        load_s = time.perf_counter() - t0
        inputs = shard_batch(x, pipe.dp)
        model = pipe.model.eval()
        with torch.no_grad():
            before = counts()
            got = program(inputs)
            torch.cuda.synchronize()
            after = counts()
            want = model(inputs)
            launches = {k: after[k] - before[k] for k in after}
            err = {k: float((got[k] - want[k]).abs().max()) for k in KEYS}
            exact = all(torch.equal(got[k], want[k]) for k in KEYS)
            if sorted(got) != sorted(KEYS) or not all(
                    close(got[k], want[k], EXPORT_ATOL, EXPORT_RTOL) for k in KEYS):
                raise AssertionError(f"export: the loaded program differs: {err}")
            if launches != {"dmv_fused": 2, "match_fwd": 1}:
                raise AssertionError(f"export: the loaded program launched {launches}")
            ms = {"loaded": host_ms(lambda: program(inputs)),
                  "eager": host_ms(lambda: model(inputs))}
        emit({"phase": "export", "bytes": n_bytes, "export_s": round(export_s, 3),
              "load_s": round(load_s, 3), "max_abs_err": err, "bit_equal": exact,
              "tolerance": {"atol": EXPORT_ATOL, "rtol": EXPORT_RTOL},
              "launches_per_call": launches, "forward_ms_B64": ms,
              "shape": {"B": 64, "len": int(x["word"].shape[1]), "P": 36, "feat": 2048,
                        "precision": "bf16"}})
    for name, n in launches.items():
        state.setdefault(name, {}).setdefault("launches_by_path", {})["export_forward"] = n


# n1 of the batches that hold the separate inside/outside kernels against
# their plain versions, by the mapping of dmv_inside.cu they take: 57 is the
# word path's; on an H100 (232,448 bytes of opt-in shared memory) 56/57 and
# 59/60 lie each side of the outside kernel's staging and shared/global
# boundaries, 75/76 each side of the inside kernel's staging boundary
INSIDE_GROUPS = {"warp": (1, 2, 3, 4, 5, 6, 7, 8, 9),
                 "smem": (10, 17, 51, 56, 57, 59, 60, 75, 76), "global": (101,)}
TIMED_N1 = (9, 17, 51, 57, 59, 60, 101)
# B of the warp mapping's checks: a ragged last block at two or four
# sentences a block
WARP_B = 65


def dmv_pass_steps(n1, parent=False):
    """Dependent width steps of one pass over a sentence of ``n1 - 1`` words:
    one a width in the one-barrier fills of every inside mapping and of the
    outside kernel (whose log pass has one more, width 0), two in the
    parent's warp mapping (n1 <= 9), whose fill had two barriers a width."""
    return 2 * (n1 - 1) if parent and n1 <= 9 else n1 - 1


def _parent_note(state):
    return ("ran: the parent commit's dmv_inside.cu and dmv_common.cuh "
            f"from {os.path.relpath(PARENT_DMV, ROOT)}, in this call" if "parent_dmv" in state
            else f"not run: no {os.path.relpath(PARENT_DMV, ROOT)}")


def _ragged(rng, n1, B=64):
    """B lengths in [1, n1-1] with the longest, a one-word sentence and a
    zero-length filler among them (what fits; zero-length rows alone at
    n1 = 1)."""
    import numpy as np

    if n1 == 1:
        return np.zeros(B, np.int64)
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
            lengths = _ragged(rng, n1, WARP_B if mapping == "warp" else 64)
            for kind in ("log", "max"):
                dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
                before = dmv_cuda.launch_counts()["inside"][mapping]
                got = dmv_inside(dec, attach, lens, kind)
                if dmv_cuda.launch_counts()["inside"][mapping] != before + 1:
                    raise AssertionError(f"K2 n1={n1} did not take the {mapping} mapping")
                want = dmv_total(dec, attach, lens, kind)
                fused = dmv_fused(dec, attach, lens, kind)[0]
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                result["cases"][f"n1={n1}/{kind}"] = {
                    "mapping": mapping, "total": err,
                    "vs_fused": float((got - fused).abs().max())}
                worst[mapping] = max(worst[mapping], err)
                again = dmv_inside(dec, attach, lens, kind)
                ok = (torch.equal(got.view(torch.int32), again.view(torch.int32))
                      and (torch.equal(got, want) and torch.equal(got, fused)
                           if kind == "max" else
                           close(got, want, K1_TOTAL_ATOL, K1_TOTAL_RTOL)))
                if not ok:
                    emit(result)
                    raise AssertionError(f"K2 n1={n1}/{kind} disagrees: {err}")
            # exact on quarter-integer potentials (ties included)
            dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev, quarter=True)
            if not torch.equal(dmv_inside(dec, attach, lens, "max"),
                               dmv_total(dec, attach, lens, "max")):
                raise AssertionError(f"K2 n1={n1}: max total not exact on quarter-integers")
    parent = state.get("parent_dmv")
    result["parent"] = _parent_note(state)
    for n1 in TIMED_N1:
        lengths = _ragged(rng, n1)
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        timing = {}
        steps = dmv_pass_steps(n1)
        for kind in ("log", "max"):
            timing[kind] = {
                "ms": device_ms(lambda: dmv_inside(dec, attach, lens, kind)),
                "call_ms": time_ms(lambda: dmv_inside(dec, attach, lens, kind)),
                "plain_ms": time_ms(lambda: dmv_total(dec, attach, lens, kind),
                                    reps=3, warmup=1),
                "fused_ms": device_ms(lambda: dmv_fused(dec, attach, lens, kind))}
            timing[kind]["ms_per_step"] = timing[kind]["ms"] / steps
            if parent is not None:
                got = dmv_inside(dec, attach, lens, kind)
                old = parent.inside(dec, attach, lens, kind, save=False)[0]
                timing[kind]["parent_ms"] = device_ms(
                    lambda: parent.inside(dec, attach, lens, kind, save=False))
                timing[kind]["parent_ms_per_step"] = (
                    timing[kind]["parent_ms"] / dmv_pass_steps(n1, parent=True))
                timing[kind]["parent_vs_new"] = float((got - old).abs().max())
        result["timing_B64"][f"n1={n1}"] = {
            **timing, **dmv_bound(lengths, n1, "inside"),
            "plan": dmv_cuda.inside_plan(n1, dmv_cuda._smem_optin),
            "dependent_steps": steps,
            "parent_dependent_steps": dmv_pass_steps(n1, parent=True)}
    # the floor under the warp mapping's chain of widths: a one-block PyTorch
    # kernel (a launch), and the warp kernel at n1 = 1 (zero-length rows: a
    # launch, the lengths' and the staging's first reads, a store a row)
    dec, attach, lens = _dmv_inputs(rng, _ragged(rng, 1), 1, dev)
    floor = {"launch_ms": device_ms(torch.empty(64, device=dev).zero_)}
    for what, fn in (("", lambda: dmv_inside(dec, attach, lens, "max")),
                     ("save_", lambda: dmv_cuda.dmv_inside_save(dec, attach, lens, "max"))):
        floor[f"warp_n1=1_{what}ms"] = device_ms(fn)
        if parent is not None:
            floor[f"parent_warp_n1=1_{what}ms"] = device_ms(
                lambda: parent.inside(dec, attach, lens, "max", save=bool(what)))
    result["floor_B64"] = floor
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
                                 "dependent_steps")},
            "ms_per_step": t["max"]["ms_per_step"],
            **({"parent_ms": t["max"]["parent_ms"], "parent_ms_log": t["log"]["parent_ms"]}
               if parent is not None else {})}


def phase_k3(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused, dmv_inside_save, dmv_outside
    from vlgae_tpu_torch.struct import dmv_inside_charts_plain, dmv_outside_plain

    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    result = {"phase": "k3", "cases": {}, "timing_B64": {}}
    parent = state.get("parent_dmv")
    worst = {"charts": 0.0, "outside": 0.0}
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for mapping, sizes in INSIDE_GROUPS.items():
        for n1 in sizes:
            lengths = _ragged(rng, n1, WARP_B if mapping == "warp" else 64)
            gout = _gout(len(lengths), dev)
            for kind in ("log", "max"):
                dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
                before = dmv_cuda.launch_counts()["inside_save"][mapping]
                total, charts = dmv_inside_save(dec, attach, lens, kind)
                if dmv_cuda.launch_counts()["inside_save"][mapping] != before + 1:
                    raise AssertionError(f"K3a n1={n1} did not take the {mapping} mapping")
                p_total, p_charts = dmv_inside_charts_plain(dec, attach, lens, kind)
                off = p_charts == -1e12
                out_global = dmv_cuda.launch_counts()["outside_global"]
                got = dmv_outside(dec, attach, lens, gout, total, charts, kind)
                out_mapping = dmv_cuda.outside_mapping(n1, dmv_cuda._smem_optin)
                if (dmv_cuda.launch_counts()["outside_global"]
                        != out_global + (out_mapping == "global")):
                    raise AssertionError(f"K3b n1={n1} did not take the {out_mapping} mapping")
                again = dmv_outside(dec, attach, lens, gout, total, charts, kind)
                on_plain = dmv_outside(dec, attach, lens, gout, p_total,
                                       p_charts.contiguous(), kind)
                # log: the plain version in f64, whose round-off is far below
                # the tolerance; in f32 its own reaches it at n1 = 101 (a GO
                # count of 44.3195 against 44.3204 in f64)
                want = tuple(x.float() for x in dmv_outside_plain(
                    dec, attach, lens, gout, total, charts, kind,
                    torch.float64 if kind == "log" else torch.float32))
                _, fd, fa = dmv_fused(dec, attach, lens, kind)
                fused = (gout.view(-1, 1, 1, 1, 1) * fd, gout.view(-1, 1, 1, 1) * fa)
                torch.cuda.synchronize()
                errs = {
                    "mapping": mapping, "outside_mapping": out_mapping,
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
                    worst_at = {}
                    for name, g, w, f in zip(("g_dec", "g_attach"), got, want, fused):
                        excess = (g - w).abs() - (K1_GRAD_ATOL + K1_GRAD_RTOL * w.abs())
                        k = int(excess.argmax())
                        worst_at[name] = {"at": list(np.unravel_index(k, tuple(g.shape))),
                                          "kernel": float(g.flatten()[k]),
                                          "plain": float(w.flatten()[k]),
                                          "k1": float(f.flatten()[k])}
                    raise AssertionError(f"K3 n1={n1}/{kind} disagrees: {errs} {worst_at}")
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
    result["parent"] = _parent_note(state)
    for n1 in TIMED_N1:
        lengths = _ragged(rng, n1)
        gout = _gout(len(lengths), dev)
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        timing = {}
        steps = dmv_pass_steps(n1)
        for kind in ("log", "max"):
            total, charts = dmv_inside_save(dec, attach, lens, kind)
            t = timing[kind] = {
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
            t["pair_ms"] = t["save_ms"] + t["outside_ms"]
            t["save_ms_per_step"] = t["save_ms"] / steps
            t["outside_ms_per_step"] = t["outside_ms"] / steps
            if parent is not None:
                p_total, p_charts = parent.inside(dec, attach, lens, kind, save=True)
                t["parent_save_ms"] = device_ms(
                    lambda: parent.inside(dec, attach, lens, kind, save=True))
                t["parent_save_ms_per_step"] = (
                    t["parent_save_ms"] / dmv_pass_steps(n1, parent=True))
                t["parent_vs_new"] = {
                    "total": float((p_total - total).abs().max()),
                    "charts": float((p_charts - charts).abs().max())}
        result["timing_B64"][f"n1={n1}"] = {
            **timing, "save_bound": dmv_bound(lengths, n1, "save"),
            "outside_bound": dmv_bound(lengths, n1, "outside"),
            "fused_bound": dmv_bound(lengths, n1, "fused"),
            "save_plan": dmv_cuda.inside_plan(n1, dmv_cuda._smem_optin),
            "outside_plan": dmv_cuda.outside_plan(n1, dmv_cuda._smem_optin),
            "dependent_steps": {"save": steps, "outside": steps},
            "parent_dependent_steps": {"save": dmv_pass_steps(n1, parent=True)}}
    result["tolerance"] = {"total_and_charts": [K1_TOTAL_ATOL, K1_TOTAL_RTOL],
                           "grads": [K1_GRAD_ATOL, K1_GRAD_RTOL], "max": "exact"}
    emit(result)
    t = result["timing_B64"]["n1=51"]
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_ops")
    state["dmv_inside_save"] = {
        "max_abs_err": worst["charts"], "ms": t["max"]["save_ms"],
        "plain_ms": t["max"]["save_plain_ms"], "library_ms": None,
        "ms_log": t["log"]["save_ms"], "timed_at": {"B": 64, "n1": 51, "kind": "max"},
        **{k: t["save_bound"][k] for k in keys},
        "dependent_steps": t["dependent_steps"]["save"],
        "ms_per_step": t["max"]["save_ms_per_step"],
        **({"parent_ms": t["max"]["parent_save_ms"], "parent_ms_log": t["log"]["parent_save_ms"]}
           if parent is not None else {})}
    state["dmv_outside"] = {
        "max_abs_err": worst["outside"], "ms": t["max"]["outside_ms"],
        "plain_ms": t["max"]["outside_plain_ms"], "library_ms": None,
        "ms_log": t["log"]["outside_ms"], "timed_at": {"B": 64, "n1": 51, "kind": "max"},
        **{k: t["outside_bound"][k] for k in keys},
        "dependent_steps": t["dependent_steps"]["outside"],
        "ms_per_step": t["max"]["outside_ms_per_step"]}
    # the warp and the global mapping serve both inside functions: their
    # rows keep the value-only time and add the chart-saving one
    for name, n1 in (("dmv_inside_small", 9), ("dmv_inside_long", 101)):
        ts = result["timing_B64"][f"n1={n1}"]
        state[name].update({"save_ms": ts["max"]["save_ms"], "save_ms_log": ts["log"]["save_ms"],
                            "save_ms_per_step": ts["max"]["save_ms_per_step"]})
        if parent is not None:
            state[name].update({"parent_save_ms": ts["max"]["parent_save_ms"],
                                "parent_save_ms_log": ts["log"]["parent_save_ms"]})


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
    from vlgae_tpu_torch.parallel.mesh import shard_batch

    with torch.no_grad():
        inputs = shard_batch(x, pipe.dp)
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

    counts, reset = kernel_counts, reset_kernel_counts

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
    for name in launches:
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
    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    def reset():
        dmv_cuda.reset_launch_counts()
        match.reset_launch_counts()

    def counts():
        # the recipe's captions reach n1 = 65 at most: K1's split placement
        c, m = dmv_cuda.launch_counts(), match.launch_counts()
        return {"dmv_fused": c["fused"], "dmv_fused_split": c["fused_split"],
                "match_fwd": m["fwd"],
                # captions of up to 63 words: Q <= 130, one pass over the images
                "match_fwd_one_q_chunk": m["fwd_by_q_chunks"].get(1, 0),
                "match_bwd": m["bwd"]}

    # the (V, Q) of every K5 call, to show which shapes the path reached
    shapes = set()
    orig = {"fwd": match.match_maxes, "bwd": match.match_maxes_bwd}

    def recording(vis, txt, vb, tb):
        shapes.add((int(vis.shape[1]), int(txt.shape[1])))
        return orig["fwd"](vis, txt, vb, tb)

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
        if launches["match_fwd_one_q_chunk"] != launches["match_fwd"]:
            raise AssertionError(f"vit train: a K5 launch took more than one q-chunk: "
                                 f"{launches}")
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
            inputs = shard_batch(x, pipe.dp)
            g0 = dmv_cuda.launch_counts()["fused_split"]
            out = pipe.model.eval()(inputs)
            on_path["k1"] = _check_dmv_on_path(out, inputs["seq_len"])
            if dmv_cuda.launch_counts()["fused_split"] != g0 + 2:
                raise AssertionError("vit: K1 at n1 = 65 did not take the split placement")
            dec, attach, lens = out["merged_dec"], out["merged_attach"], inputs["seq_len"]
            on_path["k1_device_ms"] = {kind: device_ms(lambda: dmv_fused(dec, attach, lens, kind))
                                       for kind in ("log", "max")}
            # the frozen ViT's forward and the pageable upload of the pixels
            px = inputs["vis_pixels"]
            vit_ms = device_ms(lambda: pipe.model.vis_encoder.vit(px), n=10)
        upload = upload_numbers(x["vis_pixels"], pipe.device)
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
        # K1 max on the Eisner potentials, all three on the split placement
        pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=True)
        reset()
        try:
            mbr_arc = pipe.eval_step(x)["arc"]
        finally:
            pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=False)
        mbr_counts = counts()
        if not (mbr_counts["dmv_fused"] == mbr_counts["dmv_fused_split"] == 3):
            raise AssertionError(f"vit MBR eval step: launches {mbr_counts}")
        with torch.no_grad():
            inputs = shard_batch(x, pipe.dp)
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
        if not (predict_launches["dmv_fused_split"] and predict_launches["match_fwd"]
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
          "vit_forward_device_ms_B64": vit_ms, "pixel_upload_B64": upload,
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
EISNER_N1 = {"B64_len1-50": 51, "B64_len1-64_split": 65, "B64_len86-100_global": 101}


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
    its time beside the plain fill's and, with ``_checkouts/parent_dmv/``,
    the parent's K1 timed in turns with it."""
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused
    from vlgae_tpu_torch.struct import (deptree_grads_fast, deptree_marginals,
                                        deptree_partition, eisner_as_dmv)

    parent = state.get("parent_dmv")
    cases, rows = {}, {}
    for name, n1 in EISNER_N1.items():
        lengths = eisner_lengths(rng, n1)
        arc = torch.tensor(rng.standard_normal((64, n1, n1)), dtype=torch.float32,
                           device=dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        dec, attach = eisner_as_dmv(arc)
        case = {}
        mapping = name.rsplit("_", 1)[1] if name.endswith(("_global", "_split")) else "smem"
        for kind in ("log", "max"):
            c0 = dmv_cuda.launch_counts()
            total = dmv_fused(dec, attach, lens, kind)[0]
            table = deptree_grads_fast(arc, lens, kind)
            c1 = dmv_cuda.launch_counts()
            moved = {m: c1[f"fused_{m}"] - c0[f"fused_{m}"] for m in ("global", "split")}
            if mapping != "smem" and moved[mapping] != 2:
                raise AssertionError(f"K1 Eisner {name} did not take the {mapping} mapping")
            want_t = deptree_partition(arc, lens, kind)
            want_g = deptree_marginals(arc, lens, kind)
            errs = {"total": float((total - want_t).abs().max()),
                    "table": float((table - want_g).abs().max())}
            ok = close(total, want_t, K1_TOTAL_ATOL, K1_TOTAL_RTOL) and (
                errs["table"] == 0.0 if kind == "max"
                else close(table, want_g, K1_GRAD_ATOL, K1_GRAD_RTOL))
            if not ok:
                raise AssertionError(f"K1 on Eisner potentials {name}/{kind}: {errs}")
            k1 = {"device_ms": lambda: dmv_fused(dec, attach, lens, kind)}
            if parent is not None and "dmv_fused" in parent.libs:
                # the parent's K1 in turns with this tree's, and its bits
                k1["parent_ms"] = lambda: parent.fused(dec, attach, lens, kind)
                new, old = dmv_fused(dec, attach, lens, kind), parent.fused(dec, attach,
                                                                             lens, kind)
                errs["parent_vs_new"] = max(float((a - b).abs().max()) for a, b in zip(new, old))
            case[kind] = {
                **errs, **_in_turns(k1),
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
            **{f"parent_ms_{k}": case[k]["parent_ms"] for k in ("log", "max")
               if "parent_ms" in case[k]},
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
    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    def reset():
        dmv_cuda.reset_launch_counts()
        match.reset_launch_counts()

    def counts():
        c = dmv_cuda.launch_counts()
        return {"dmv_fused": c["fused"], "dmv_fused_global": c["fused_global"],
                "dmv_inside": c["inside"]["smem"], "dmv_inside_small": c["inside"]["warp"],
                "dmv_inside_long": c["inside"]["global"],
                "dmv_inside_save": sum(c["inside_save"].values()),
                "dmv_outside": c["outside"], "match_fwd": match.launch_counts()["fwd"]}

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
                inputs = shard_batch(xp, card.dp)
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
            inputs = shard_batch(x, pipe.dp)
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


# the joint model's other grounding strategies (configs/model/vlgae.yaml keys)
GROUNDING_MODES = {
    "word": ["model.language_factor_mode=word"],
    "word+alldep": ["model.language_factor_mode=word+alldep"],
    "cap_img": ["model.gather_logit_mode=reduced", "model.loss_grounding_mode=cap_img|ce",
                "model.decode_grounding_mode=on_img", "model/metric=attachment_cap_img"],
}


def kernel_counts():
    """Every wrapper's launch count, by the rows of the ``kernels`` line."""
    from vlgae_tpu_torch.ops import dmv_cuda, match

    c, m = dmv_cuda.launch_counts(), match.launch_counts()
    return {"dmv_fused": c["fused"], "dmv_inside": c["inside"]["smem"],
            "dmv_inside_save": c["inside_save"]["smem"], "dmv_outside": c["outside"],
            "dmv_inside_small": c["inside"]["warp"] + c["inside_save"]["warp"],
            "dmv_inside_long": c["inside"]["global"] + c["inside_save"]["global"],
            "match_fwd": m["fwd"], "match_bwd": m["bwd"]}


def reset_kernel_counts():
    from vlgae_tpu_torch.ops import dmv_cuda, match

    dmv_cuda.reset_launch_counts()
    match.reset_launch_counts()


# K1, K2, the K3 pair, K5 and K6 of each step, by mode (the exp=vlgae
# captions pad to at most 56 words, so none takes the warp or global
# mapping): word trains the NLL through the K3 pair (no tree is reused) and
# evaluates it with K2, decoding with K1 max; word+alldep takes K1 log for
# the arc marginals and the K3 pair for the NLL, and evaluates as
# word+maxdep (K1 twice); the caption-image path takes K1 twice and no
# matching kernel
GROUNDING_STEP_LAUNCHES = {
    ("word", "train"): {"dmv_inside_save": 1, "dmv_outside": 1, "match_fwd": 1,
                        "match_bwd": 1},
    ("word", "eval"): {"dmv_fused": 1, "dmv_inside": 1, "match_fwd": 1},
    ("word+alldep", "train"): {"dmv_fused": 1, "dmv_inside_save": 1, "dmv_outside": 1,
                               "match_fwd": 1, "match_bwd": 1},
    ("word+alldep", "eval"): {"dmv_fused": 2, "match_fwd": 1},
    ("cap_img", "train"): {"dmv_fused": 2},
    ("cap_img", "eval"): {"dmv_fused": 2},
}


def _check_k3_on_path(save_args, out_args):
    """The K3 pair on a training step's own tensors (the Viterbi NLL of a
    mode that reuses no tree): the chart-saving inside kernel against the
    plain charts (exact in the max semiring), the outside kernel against
    its plain version under the step's own cotangent (the same support
    everywhere, within K1's tolerances on sentences without a tied best
    tree) and against K1 scaled by that cotangent; times and bounds."""
    import torch

    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused, dmv_inside_save, dmv_outside
    from vlgae_tpu_torch.struct import (dmv_inside_charts_plain, dmv_outside_plain,
                                        dmv_value_and_grads_plain)

    dec, attach, lens, kind = save_args
    gout = out_args[3]
    with torch.no_grad():
        total, charts = dmv_inside_save(dec, attach, lens, kind)
        p_total, p_charts = dmv_inside_charts_plain(dec, attach, lens, kind)
        gd, ga = dmv_outside(dec, attach, lens, gout, total, charts, kind)
        pd, pa = dmv_outside_plain(dec, attach, lens, gout, p_total, p_charts, kind)
        _, fd, fa = dmv_fused(dec, attach, lens, kind)
        _, _, wa = dmv_value_and_grads_plain(dec, attach, lens, kind)
    torch.cuda.synchronize()
    off = p_charts == -1e12
    tied = ((wa % 1) != 0).flatten(1).any(1) if kind == "max" else torch.zeros_like(lens,
                                                                                    dtype=torch.bool)
    g = gout.view(-1, *([1] * (gd.dim() - 1)))
    errs = {"n1": int(dec.shape[1]), "B": int(dec.shape[0]), "kind": kind,
            "lengths": [int(lens.min()), int(lens.max())],
            "tied_sentences": int(tied.sum()),
            "inside_total": float((total - p_total).abs().max()),
            "outside_untied": max(float((a[~tied] - b[~tied]).abs().max()) if bool(
                (~tied).any()) else 0.0 for a, b in ((gd, pd), (ga, pa))),
            "outside_vs_k1": max(float((gd - g * fd).abs().max()),
                                 float((ga - g.view(-1, 1, 1, 1) * fa).abs().max()))}
    inside_ok = (torch.equal(total, p_total) and torch.equal(charts[~off], p_charts[~off])
                 and bool((charts[off] == -1e12).all())) if kind == "max" else (
        close(total, p_total, K1_TOTAL_ATOL, K1_TOTAL_RTOL))
    outside_ok = (all(bool(((a != 0) == (b != 0)).all()) for a, b in ((gd, pd), (ga, pa)))
                  and all(close(a[~tied], b[~tied], K1_GRAD_ATOL, K1_GRAD_RTOL)
                          for a, b in ((gd, pd), (ga, pa)))
                  and close(gd, g * fd, K1_GRAD_ATOL, K1_GRAD_RTOL)
                  and close(ga, g.view(-1, 1, 1, 1) * fa, K1_GRAD_ATOL, K1_GRAD_RTOL))
    if not (inside_ok and outside_ok):
        raise AssertionError(f"the K3 pair disagrees on a training step's tensors: {errs}")
    n1 = int(dec.shape[1])
    save = {"ms": time_ms(lambda: dmv_inside_save(dec, attach, lens, kind)),
            "device_ms": device_ms(lambda: dmv_inside_save(dec, attach, lens, kind)),
            "plain_ms": time_ms(lambda: dmv_inside_charts_plain(dec, attach, lens, kind),
                                reps=3, warmup=1),
            "max_abs_err": errs["inside_total"], **dmv_bound(lens.tolist(), n1, "save")}
    outside = {"ms": time_ms(lambda: dmv_outside(dec, attach, lens, gout, total, charts,
                                                 kind)),
               "device_ms": device_ms(lambda: dmv_outside(dec, attach, lens, gout, total,
                                                          charts, kind)),
               "plain_ms": time_ms(lambda: dmv_outside_plain(dec, attach, lens, gout, total,
                                                             charts, kind), reps=3, warmup=1),
               "max_abs_err": errs["outside_untied"],
               **dmv_bound(lens.tolist(), n1, "outside")}
    return errs, save, outside


def _big_k5_timing(state, args):
    """K5's times at a wide shape (word+alldep's Q), in turns with the
    parent's K5 when its sources are there (and its outputs held to the
    parent's bit for bit), its plain version's and the yardstick: one bf16
    ``torch.matmul`` of the product (it stores all ``B*Q x A*V`` of it; the
    port never calls it). The bound counts the work of this run's masks: a
    masked (a, v) or (b, q) gives -INF whatever its product, so only the
    live rows are read and multiplied. Beside it, the share of K5's q-chunks
    (per caption, and per block's tile of captions) that hold no live
    word."""
    import torch
    import torch.nn.functional as F

    from vlgae_tpu_torch.ops.match import match_fwd_plan, match_maxes_cuda, match_maxes_plain

    vis, txt, vb, tb = args
    A, V, D = vis.shape
    B, Q, _ = txt.shape
    # a live row's bias is 0, a masked one's -1e9
    n_v, n_q = int((vb == 0).sum()), int((tb == 0).sum())
    plan = match_fwd_plan(A, V, B, Q, D, vis.data_ptr(), txt.data_ptr(),
                          torch.cuda.get_device_properties(vis.device).multi_processor_count)
    q_chunks, words, cap = plan["q_chunks"], plan["q_chunk_words"], plan["cap_tile"]
    live = F.pad(tb == 0, (0, q_chunks * words - Q)).view(B, q_chunks, words).any(-1)
    tiles = F.pad(live, (0, 0, 0, -B % cap)).view(-1, cap, q_chunks).any(1)
    with torch.no_grad():
        got = match_maxes_cuda(*args)
    vs_parent = _k5_vs_parent(state, args, got, "on a word+alldep step's tensors")
    del got
    turns = _k5_times(state, args)
    out = {"A": A, "V": V, "B": B, "Q": Q, "D": D, "plan": plan,
           "parent_vs_new": vs_parent,
           "ms": time_ms(lambda: match_maxes_cuda(*args), reps=5),
           "device_ms": turns["new"], "parent_device_ms": turns.get("parent"),
           "plain_ms": time_ms(lambda: match_maxes_plain(*args), reps=2, warmup=1)}
    torch.cuda.empty_cache()
    x, y = txt.reshape(B * Q, D), vis.reshape(A * V, D)
    out["product_only_library_ms"] = device_ms(lambda: torch.matmul(x, y.T), n=3, reps=3)
    torch.cuda.empty_cache()
    out.update({"live_vis_rows": n_v, "live_txt_rows": n_q,
                "live_txt_share": n_q / (B * Q),
                "dead_q_chunk_share": 1 - float(live.float().mean()),
                "dead_block_q_chunk_share": 1 - float(tiles.float().mean()),
                **bound(2 * (n_v + n_q) * D + 4 * (A * V + B * Q) + 8 * B * A * (Q + V),
                        2 * n_v * n_q * D, "bf16")})
    return out


def _grounding_pipeline(tmp, overrides, device):
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params

    cfg = compose(overrides)
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    init_params(model, 0)
    pipe = Pipeline(model, dm, cfg, device=device, workdir=tmp)
    pipe.setup_optimizer()
    return pipe


def _grounding_reference(tmp, name):
    """One mode at small widths and precision=32, the card against the CPU:
    ``predict``'s dev file (identical byte for byte, the dev loss within
    1e-4) and
    one joint train step (loss within ``TRAIN_LOSS_RTOL``, every
    gradient within ``TRAIN_GRAD_ATOL``/``RTOL``) on the first training
    batch whose Viterbi trees have no exact tie (where one ties, the card's
    DMV kernels mark every best tree and the CPU splits the gradient)."""
    import numpy as np
    import torch

    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain
    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    small = ["datamodule.pad_boxes=6", "_hidden_size=32", "_match_hidden_size=16",
             "_rank=4", "vis_encoder.n_in=16", "vis_encoder.n_hidden=32",
             "trainer.precision=32", "init_seed=0"] + GROUNDING_MODES[name]
    files, res = {}, {}
    for dev in ("cpu", "cuda"):
        _, r = _run_predict(tmp, _corpus_overrides(tmp) + small + [
            f"device={dev}", f"name={name}_{dev}"])
        with open(os.path.join(tmp, f"{name}_{dev}_dev.conll")) as f:
            files[dev] = f.read()
        res[dev] = r["dev"]
    rows = [(a.split("\t"), b.split("\t")) for a, b in zip(
        files["cpu"].splitlines(), files["cuda"].splitlines())]
    out = {"identical_dev_file": files["cpu"] == files["cuda"],
           "arcs_identical": all(a[:4] == b[:4] for a, b in rows),
           "align_rows_identical": float(np.mean([a == b for a, b in rows])),
           "dev": res}
    dloss = abs(res["cpu"]["loss"] - res["cuda"]["loss"])
    if not (out["identical_dev_file"] and dloss <= 1e-4 * (1 + abs(res["cpu"]["loss"]))):
        raise AssertionError(f"{name}: the card and the CPU disagree on the dev set: {out}")

    pipes = {dev: _grounding_pipeline(tmp, _small_overrides(tmp) + GROUNDING_MODES[name],
                                      dev) for dev in ("cpu", "cuda")}
    skipped = 0
    for x, y in pipes["cpu"].dm.batches("train", shuffle=False):
        x, y = pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]
        with torch.no_grad():
            o = pipes["cpu"].model.eval()(shard_batch(x, pipes["cpu"].dp))
            ind = dmv_value_and_grads_plain(o["merged_dec"], o["merged_attach"],
                                            torch.as_tensor(x["seq_len"]), "max")[2]
        if bool(((ind % 1) != 0).flatten(1).any(1).any()):
            skipped += 1
            continue
        break
    else:
        raise AssertionError(f"{name}: every training batch has a tied Viterbi tree")
    step = {}
    for dev, pipe in pipes.items():
        loss, _ = pipe.grad_step(x, y, False, 0.5)
        step[dev] = (float(loss), {n: p.grad.detach().cpu() for n, p in
                                   pipe.model.named_parameters() if p.grad is not None})
    (lc, gc), (lg, gg) = step["cpu"], step["cuda"]
    if sorted(gc) != sorted(gg):
        raise AssertionError(f"{name}: the card and the CPU differ in which params get grads")
    worst = max(float((gc[n] - gg[n]).abs().max()) for n in gc)
    bad = [n for n in gc if not close(gg[n], gc[n], TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL)]
    out.update({"train_loss": {"cpu": lc, "cuda": lg}, "max_grad_abs_err": worst,
                "n_params": len(gc), "tied_batches_skipped": skipped})
    if bad or abs(lc - lg) > TRAIN_LOSS_RTOL * abs(lc):
        raise AssertionError(f"{name}: train step card vs CPU: loss {lc} / {lg}, {bad}")
    return out


def phase_grounding_modes(state):
    """The joint model's other grounding strategies at ``exp=vlgae``'s
    published widths and bf16 on the corpus of phase ``slice``:
    ``word+alldep`` (words and every (head, dep) pair: Q = N + N^2 up to
    3,306 in training) and the caption-image path (``reduced`` /
    ``cap_img|ce`` / ``on_img``, ``metric=attachment_cap_img``) through
    ``train`` (one warm-up and one joint epoch) and ``predict``, ``eval.py``
    on each dev file; ``word`` by a train step and an eval step. Each
    mode's launches per step, K5 and K6 at word+alldep's widest Q and the
    K3 pair at its longest charts on the path's own tensors against their
    plain versions, step times at B = 64; then each mode at small widths and
    precision=32, the card against the CPU."""
    import json as _json
    import math

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import train
    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    def nonzero(c):
        return {k: v for k, v in c.items() if v}

    result = {"phase": "grounding_modes"}
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=104, feat_dim=2048, n_box=36, len_range=(3, 50), seed=0)
        base = _corpus_overrides(tmp) + [f"datamodule.{s}_dataloader.num_bucket=1"
                                         for s in ("train", "dev", "test")]
        # -- train and predict: word+alldep and the caption-image path ------
        for name in ("word+alldep", "cap_img"):
            run = os.path.join(tmp, f"run_{name}")
            overrides = base + GROUNDING_MODES[name]
            reset_kernel_counts()
            cwd = os.getcwd()
            os.chdir(tmp)
            t0 = time.perf_counter()
            try:
                pipe, test = train.main(overrides + [
                    "trainer.max_epochs=2", "model.init_epoch=1", f"workdir={run}",
                    "init_seed=0", "device=cuda"])
            finally:
                os.chdir(cwd)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            trained = kernel_counts()
            with open(os.path.join(run, "metrics.jsonl")) as f:
                lines = [_json.loads(line) for line in f]
            bad = [k for rec in lines for k, v in rec.items()
                   if ("loss" in k or k.endswith(("nll", "enll", "mt", "txt2vis")))
                   and not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"{name}: non-finite losses: {bad}")
            reset_kernel_counts()
            t0 = time.perf_counter()
            _, results = _run_predict(tmp, overrides + [
                f"checkpoint={run}/checkpoint/last.pt", "device=cuda", f"name={name}"])
            torch.cuda.synchronize()
            t_predict = time.perf_counter() - t0
            predicted = kernel_counts()
            dev_file = os.path.join(tmp, f"{name}_dev.conll")
            with open(dev_file) as f:
                text = f.read()
            if text.count("\n\n") != len(pipe.dm.datasets["dev"]):
                raise AssertionError(f"{name}: {text.count(chr(10) * 2)} dev sentences")
            need = (("dmv_fused", "dmv_inside_save", "dmv_outside", "match_fwd", "match_bwd")
                    if name == "word+alldep" else ("dmv_fused",))
            if not all(trained[k] for k in need) or not predicted["dmv_fused"]:
                raise AssertionError(f"{name}: a kernel of the path never launched: "
                                     f"{trained} {predicted}")
            if name == "cap_img":
                if trained["match_fwd"] or trained["match_bwd"] or predicted["match_fwd"]:
                    raise AssertionError(f"cap_img launched a matching kernel: {trained}")
                if "caption/acc" not in results["dev"]:
                    raise AssertionError(f"cap_img: no caption accuracy: {results['dev']}")
                if any(row.split("\t")[4:] != ["X", "X"] for row in text.splitlines() if row):
                    raise AssertionError("cap_img: an ALIGN column is not the X placeholder")
            for split, r in results.items():
                if not all(math.isfinite(float(v)) for v in r.values()):
                    raise AssertionError(f"{name} {split}: non-finite {r}")
            tail = {"train_dev": check_eval(root, os.path.join(run, "dev.predict.txt")),
                    "predict_dev": check_eval(root, dev_file)}
            key = name.replace("+", "_")
            by_path[f"vlgae_{key}_train"] = trained
            by_path[f"vlgae_{key}_predict"] = predicted
            result[name] = {"train_s": round(t_train, 3), "predict_s": round(t_predict, 3),
                            "launches_train": nonzero(trained),
                            "launches_predict": nonzero(predicted), "test": test,
                            "dev": results["dev"], "eval_py_tail": tail}

        # -- one step at a time, B = 64: launches, times, the path's tensors --
        captured = {}
        orig = {"fwd": match.match_maxes, "bwd": match.match_maxes_bwd,
                "save": dmv_cuda.dmv_inside_save, "outside": dmv_cuda.dmv_outside}

        def capturing(key, fn):
            def call(*args):
                captured.setdefault(key, tuple(
                    a.detach() if isinstance(a, torch.Tensor) else a for a in args))
                return fn(*args)
            return call

        steps = {}
        for name in GROUNDING_MODES:
            pipe = _grounding_pipeline(tmp, base + GROUNDING_MODES[name] + [
                "datamodule.train_dataloader.num_bucket=1"], "cuda")
            train_b = [(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0])
                       for x, y in pipe.dm.batches("train", shuffle=False)
                       if len(x["seq_len"]) == 64]
            train_b.sort(key=lambda b: -b[0]["word"].shape[1])
            eval_b = [pad_batch_pow2(x)[0] for x, _ in pipe.dm.batches("dev", shuffle=False)]
            eval_b.sort(key=lambda b: -b["word"].shape[1])
            train_b, eval_b = train_b[:3], eval_b[:3]
            if not train_b:
                raise AssertionError(f"{name}: no training batch of 64 captions")
            rec = {"padded_len_train": [int(b[0]["word"].shape[1]) for b in train_b],
                   "padded_len_eval": [int(b["word"].shape[1]) for b in eval_b]}
            for what, batches, run_step in (
                    ("train", train_b, lambda b: float(pipe.train_step(*b, False, 0.5)[0])),
                    ("eval", eval_b, lambda b: pipe.eval_step(b, 0.5))):
                run_step(batches[0])  # warm-up
                torch.cuda.synchronize()
                if name == "word+alldep" and what == "train":
                    # the widest batch's own tensors, captured on the way
                    match.match_maxes = capturing("fwd", orig["fwd"])
                    match.match_maxes_bwd = capturing("bwd", orig["bwd"])
                    dmv_cuda.dmv_inside_save = capturing("save", orig["save"])
                    dmv_cuda.dmv_outside = capturing("outside", orig["outside"])
                times = []
                reset_kernel_counts()
                try:
                    for b in batches:
                        t0 = time.perf_counter()
                        run_step(b)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                finally:
                    match.match_maxes, match.match_maxes_bwd = orig["fwd"], orig["bwd"]
                    dmv_cuda.dmv_inside_save = orig["save"]
                    dmv_cuda.dmv_outside = orig["outside"]
                launched = nonzero(kernel_counts())
                per_step = {k: v / len(batches) for k, v in launched.items()}
                want = GROUNDING_STEP_LAUNCHES[(name, what)]
                if per_step != want:
                    raise AssertionError(f"{name} {what} step launched {per_step}, "
                                         f"expected {want}")
                by_path[f"vlgae_{name.replace('+', '_')}_{what}_steps"] = launched
                rec[f"{what}_step_ms_B64"] = [round(t * 1e3, 3) for t in times]
                rec[f"{what}_step_ms_median_B64"] = statistics.median(times) * 1e3
                rec[f"{what}_launches_per_step"] = per_step
            steps[name] = rec
            del pipe
            torch.cuda.empty_cache()
        result["steps"] = steps

        # -- K5/K6 at word+alldep's widest Q, the K3 pair at its longest charts
        fwd, bwd = captured["fwd"], captured["bwd"]
        _, k5_err, k5_off = _check_k5(fwd, False, "on a word+alldep step's tensors")
        k5 = {"max_abs_err": k5_err, "index_mismatch_within_tol": k5_off,
              "q_chunks": match.match_fwd_q_tiling(int(fwd[1].shape[1])),
              **_big_k5_timing(state, fwd)}
        k6_err = _check_k6(bwd, False, "on a word+alldep step's tensors")
        k6 = {"max_abs_err": k6_err, **k6_timing(bwd)}
        k3_errs, k3a, k3b = _check_k3_on_path(captured["save"], captured["outside"])
        result["k5_at_alldep"] = {k: v for k, v in k5.items() if k != "plan"}
        result["k5_plan"] = k5["plan"]
        result["k6_at_alldep"] = {k: v for k, v in k6.items() if k != "plan"}
        result["k3_at_path"] = {"check": k3_errs, "inside_save": k3a, "outside": k3b}
        state.setdefault("match_fwd", {})["at_word_alldep"] = result["k5_at_alldep"]
        state.setdefault("match_bwd", {})["at_word_alldep"] = {
            k: v for k, v in result["k6_at_alldep"].items() if k != "list_lengths"}
        state.setdefault("dmv_inside_save", {})["at_word_alldep"] = {
            "n1": k3_errs["n1"], **k3a}
        state.setdefault("dmv_outside", {})["at_word_alldep"] = {"n1": k3_errs["n1"], **k3b}

        # -- each mode at small widths and precision=32, card against CPU ----
        small = os.path.join(tmp, "small")
        make_corpus(os.path.join(small, "vlparse"), n_imgs=8, feat_dim=16, n_box=6,
                    len_range=(3, 12), seed=1)
        result["card_vs_cpu"] = {name: _grounding_reference(small, name)
                                 for name in GROUNDING_MODES}
    result["launches_by_path"] = by_path
    emit(result)
    for path, counts in by_path.items():
        for kname, n in counts.items():
            if n:
                state.setdefault(kname, {}).setdefault("launches_by_path", {})[path] = n


# -- the structured surface: semirings, samplers, distributions ----------------------
# card against CPU on the first STRUCT_REF_B sentences (the longest among
# them), each method's card time at B = 64; tolerances of the CPU tests
STRUCT_N1 = (51, 65)
STRUCT_REF_B = 16
STRUCT_EXPECT = dict(atol=1e-5, rtol=1e-4)  # entropy, cross-entropy, KL, risk
STRUCT_EXACT = dict(atol=1e-5, rtol=1e-5)  # counts, k-max scores, top-k trees


def _struct_close(got, want, tol, what):
    """``got`` (card) against ``want`` (CPU) on the reference rows: entries
    both below -1e8 (the semiring zero of k-max channels past a sentence's
    trees) count as equal, and non-finite entries must be non-finite at the
    same places."""
    import torch

    got = got.detach().cpu()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"struct {what}: non-finite at other places")
    both = (got < -1e8) & (want < -1e8)
    g = torch.where(both | ~fin, 0.0, got)
    w = torch.where(both | ~fin, 0.0, want)
    err = float((g - w).abs().max())
    if not close(g, w, tol["atol"], tol["rtol"]):
        raise AssertionError(f"struct {what}: card and CPU differ by {err}")
    return err


def _trees_ok(ind, lengths):
    """``ind [k, B, N1, N1]`` arc indicators: one head per word, and the
    heads of each sample a projective tree."""
    import torch

    from vlgae_tpu_torch.struct.alg import istree

    ind = ind.detach().cpu()
    bad = 0
    for b, n in enumerate(lengths.tolist()):
        cols = ind[:, b, :, 1:n + 1]
        if not bool((cols.sum(1) == 1).all()):
            return False
        for heads in torch.argmax(cols, 1).tolist():
            bad += not istree(heads, proj=True)
    return bad == 0


def phase_struct(state):
    """The rest of the parser's structured surface on the card (the generic
    semiring fills of ``struct/dmv.py`` and ``struct/deptree.py``, plain
    PyTorch on the tensors' device): every new method of ``DMV1o`` and
    ``DependencyCRF`` at B = 64, n1 = 51 and 65 from seed 0, held to the same
    call on the CPU; the Log/Max totals of the generic fills to the value-only
    inside kernel (K2); the best k-max score to ``max``; 64 samples and a
    Gumbel relaxation per sentence are trees; ``count`` not finite exactly
    where f32 overflows (NaN from a 0 x inf chart cell, as in vlgae_tpu)."""
    import numpy as np
    import torch

    from vlgae_tpu_torch.struct import (DependencyCRF, DMV1o, LogSemiring, MaxSemiring,
                                        deptree_partition, deptree_total_fast,
                                        dmv_merge, dmv_partition, dmv_total_fast)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    result = {"phase": "struct", "B": 64, "ref_B": STRUCT_REF_B, "cases": {}}
    for n1 in STRUCT_N1:
        B, N = 64, n1 - 1
        lengths = rng.integers(1, n1, B)
        lengths[:3] = (N, 1, 2)
        dec, attach, root = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                             for s in ((B, N, 2, 2, 2), (B, N, N, 2), (B, N)))
        ar = torch.arange(N)
        pad = ar[None, :] >= torch.from_numpy(lengths)[:, None]
        attach = attach.masked_fill(pad[:, :, None, None] | pad[:, None, :, None], -1e12)
        root = root.masked_fill(pad, -1e12)
        md, ma = dmv_merge(dec, attach, root)
        other = [x + 0.5 * torch.randn(x.shape, generator=torch.Generator().manual_seed(n1))
                 for x in (md, ma)]
        arc = torch.from_numpy(rng.standard_normal((B, n1, n1)).astype(np.float32))
        arc_q = arc + 0.5 * torch.from_numpy(rng.standard_normal(arc.shape).astype(np.float32))
        cost = torch.from_numpy(rng.random(arc.shape).astype(np.float32))
        lens = torch.from_numpy(lengths)
        R = STRUCT_REF_B

        def dists(device, rows):
            m = lambda x: x[:rows].to(device)  # noqa: E731
            return (DMV1o((m(md), m(ma)), m(lens)), DMV1o((m(other[0]), m(other[1])), m(lens)),
                    DependencyCRF(m(arc), m(lens)), DependencyCRF(m(arc_q), m(lens)), m(cost))

        card, cpu = dists(dev, B), dists("cpu", R)
        case = {"errors": {}, "card_ms_B64": {}}

        def methods(d, q, c, cq, cs):
            return {
                "dmv_entropy": (lambda: d.entropy, STRUCT_EXPECT),
                "dmv_cross_entropy": (lambda: d.cross_entropy(q), STRUCT_EXPECT),
                "dmv_kl": (lambda: d.kl(q), STRUCT_EXPECT),
                "dmv_count": (lambda: d.count, STRUCT_EXACT),
                "dmv_kmax5": (lambda: d.kmax(5), STRUCT_EXACT),
                "dmv_topk3": (lambda: d.topk(3), STRUCT_EXACT),
                "crf_entropy": (lambda: c.entropy, STRUCT_EXPECT),
                "crf_cross_entropy": (lambda: c.cross_entropy(cq), STRUCT_EXPECT),
                "crf_kl": (lambda: c.kl(cq), STRUCT_EXPECT),
                "crf_risk": (lambda: c.risk(cs), STRUCT_EXPECT),
                "crf_count": (lambda: c.count, STRUCT_EXACT),
                "crf_kmax5": (lambda: c.kmax(5), STRUCT_EXACT),
                "crf_topk3": (lambda: c.topk(3), STRUCT_EXACT),
            }

        card_m, cpu_m = methods(*card), methods(*cpu)
        got = {}
        # the checked call is the timed one: the fills are many small
        # launches, and the host's dispatch sets their time
        for name, (fn, tol) in card_m.items():
            got[name], case["card_ms_B64"][name] = timed_call(fn)
            want = cpu_m[name][0]()
            g = got[name][..., :R] if got[name].dim() <= 2 else got[name][:, :R]
            if name.endswith("topk3"):
                # channels past a sentence's number of trees follow ties among
                # semiring zeros: compare the trees each sentence has
                counts = cpu_m[name.replace("topk3", "count")][0]()
                k = torch.nan_to_num(counts, nan=3.0, posinf=3.0).clamp(max=3).long()
                keep = torch.arange(3)[:, None] < k[None]
                keep = keep.view(3, R, *([1] * (want.dim() - 2))).expand_as(want)
                g, want = torch.where(keep, g.cpu(), 0.0), torch.where(keep, want, 0.0)
            case["errors"][name] = _struct_close(g, want, tol, f"n1={n1} {name}")
        d, _, c, _, _ = card
        # the generic fill's Log/Max totals against K2 (dmv_total_fast on
        # the card; deptree_total_fast rides it through eisner_as_dmv)
        for kind, S in (("log", LogSemiring), ("max", MaxSemiring)):
            for what, a, b in (
                    ("dmv", dmv_partition(d.dec, d.attach, d.lengths, S),
                     dmv_total_fast(d.dec, d.attach, d.lengths, kind)),
                    ("crf", deptree_partition(c.arc, c.lengths, S),
                     deptree_total_fast(c.arc, c.lengths, kind))):
                err = float((a - b).abs().max())
                case["errors"][f"{what}_{kind}_generic_vs_K2"] = err
                if not close(a, b, K1_TOTAL_ATOL, K1_TOTAL_RTOL):
                    raise AssertionError(f"struct n1={n1}: generic {what} {kind} vs K2: {err}")
        for what, dist in (("dmv", d), ("crf", c)):
            if not close(got[f"{what}_kmax5"][0], dist.max, K1_TOTAL_ATOL, K1_TOTAL_RTOL):
                raise AssertionError(f"struct n1={n1}: {what} kmax(5)[0] != max")
        gen = torch.Generator(device=dev).manual_seed(n1)
        drawn = {}
        for name, fn in (("dmv_sample64", lambda: d.sample(gen, 64).sum(-1)),
                         ("crf_sample64", lambda: c.sample(gen, 64)),
                         ("dmv_gumbel", lambda: d.gumbel_crf(gen).sum(-1)[None]),
                         ("crf_gumbel", lambda: c.gumbel_crf(gen, temperature=0.5)[None])):
            drawn[name], case["card_ms_B64"][name] = timed_call(fn)
        for what, ind in drawn.items():
            if not _trees_ok(ind, lens):
                raise AssertionError(f"struct n1={n1}: {what} are not all trees")
        counts = got["dmv_count"]
        nonfinite = int((~torch.isfinite(counts)).sum())
        case["count_nonfinite_sentences"] = nonfinite
        case["count_nonfinite_lengths_min"] = (
            int(lens[~torch.isfinite(counts).cpu()].min()) if nonfinite else None)
        if (n1 == 51) != (nonfinite == 0):
            raise AssertionError(f"struct n1={n1}: {nonfinite} counts not finite")
        result["cases"][f"n1={n1}"] = case
    result["tolerance"] = {"expectation": STRUCT_EXPECT, "exact": STRUCT_EXACT,
                           "generic_vs_K2": [K1_TOTAL_ATOL, K1_TOTAL_RTOL]}
    emit(result)


# -- the parser's context and variational modes on the kernels' paths -----------------
VARIATIONAL_LANG = ["model.variational_mode=all:vae", "model.z_dim=64"]
VARIATIONAL_JOINT = ["model.dep_model_cfg.variational_mode=all:ib",
                     "model.dep_model_cfg.z_dim=64"]


def phase_variational(state):
    """The variational bottleneck (the recipes ship ``variational_mode:
    'none'``; ``z_dim = 64`` is this phase's choice) on the kernels' paths:
    ``exp=lang_only`` under ``all:vae`` through ``train`` (one warm-up and one
    NLL epoch on phase ``lang_only``'s corpus) and ``predict``, the K3 pair
    in each NLL step and K1 (max) with K2/K4 in each eval step, held to
    their plain versions on a step's own tensors; one ``exp=vlgae`` bf16
    joint train step under ``all:ib`` (K1 twice, K5, K6); and card against
    CPU at small widths and precision=32 (identical dev predictions, the
    posterior mean at eval) under ``all:vae``, ``tag:ib`` and
    ``context_mode=max`` for ``exp=lang_only`` and ``all:ib`` for
    ``exp=vlgae``."""
    import json as _json
    import math

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import train
    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    counts, reset = kernel_counts, reset_kernel_counts
    result = {"phase": "variational", "lang_only": VARIATIONAL_LANG,
              "vlgae": VARIATIONAL_JOINT}
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=LANG_N_IMGS, feat_dim=4,
                    n_box=3, len_range=(3, 50), seed=0)
        run = os.path.join(tmp, "run")
        overrides = _lang_overrides(tmp, False) + VARIATIONAL_LANG
        reset()
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            pipe, test = train.main(overrides + [
                "trainer.max_epochs=2", "model.init_epoch=1", f"workdir={run}",
                "init_seed=0", "device=cuda"])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        result["train_s"] = round(time.perf_counter() - t0, 3)
        by_path["lang_only_variational_train"] = counts()
        raw = dmv_cuda.launch_counts()
        if not (sum(raw["inside_save"].values()) == raw["outside"] > 0
                and sum(raw["inside"].values()) == raw["fused"] > 0):
            raise AssertionError(f"variational lang_only train: launches {raw}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            lines = [_json.loads(line) for line in f]
        kl = [rec["train/lstm_kl"] for rec in lines if "train/loss" in rec]  # by epoch
        bad = [k for rec in lines for k, v in rec.items()
               if k.endswith(("loss", "nll", "enll", "kl")) and not math.isfinite(float(v))]
        if len(kl) != 2 or bad:
            raise AssertionError(f"variational lang_only: KL terms {kl}, non-finite {bad}")
        result["train_lstm_kl"], result["test"] = kl, test

        # NLL steps on batches of 64 training captions: the K3 pair once each
        ds = pipe.dm.datasets["train"]
        insts = [i for i in ds if 8 < i["seq_len"] <= 16][:64]
        x, y = pipe.dm.collate("train", insts, 16)
        xp, yp = pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]
        reset()
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            loss, _ = pipe.train_step(xp, yp, False, 0.5)
            float(loss)
            times.append(time.perf_counter() - t0)
        c = dmv_cuda.launch_counts()
        if not (c["inside_save"]["smem"] == 4 == c["outside"] and c["fused"] == 0):
            raise AssertionError(f"variational lang_only NLL step: launches {c}")
        result["train_step_ms_B64_L16"] = {"median": statistics.median(times[1:]) * 1e3,
                                           "all": [round(t * 1e3, 3) for t in times]}
        result["kernels_on_batches"] = {"train_L=16": _check_lang_batch(pipe, xp, True)}
        reset()
        pipe.evaluate("dev")
        c = dmv_cuda.launch_counts()
        n_steps = len(pipe.step_times)
        if not (c["fused"] == n_steps == sum(c["inside"].values())
                and sum(c["inside_save"].values()) == 0 == c["outside"]):
            raise AssertionError(f"variational lang_only eval: launches {c}")
        x, _ = next(pipe.dm.batches("dev", shuffle=False))
        result["kernels_on_batches"]["eval"] = _check_lang_batch(
            pipe, pad_batch_pow2(x)[0], False)
        result["eval_step_ms_median"] = statistics.median(pipe.step_times) * 1e3
        reset()
        t0 = time.perf_counter()
        _, pres = _run_predict(tmp, overrides + [
            f"checkpoint={os.path.join(run, 'checkpoint', 'last.pt')}", "device=cuda"])
        torch.cuda.synchronize()
        result["predict_s"] = round(time.perf_counter() - t0, 3)
        by_path["lang_only_variational_predict"] = counts()
        if not all(math.isfinite(float(r["loss"])) for r in pres.values()):
            raise AssertionError(f"variational lang_only predict: {pres}")
        result["predict"] = {k: pres[k] for k in ("dev", "test")}

    # one exp=vlgae bf16 joint step under the bottleneck, at the recipe's widths
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048, n_box=36,
                    len_range=(3, 50), seed=0)
        pipe = _grounding_pipeline(tmp, _corpus_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1" for s in ("train", "dev", "test")]
            + VARIATIONAL_JOINT, "cuda")
        full = [b for b in pipe.dm.batches("train") if len(b[0]["seq_len"]) == 64]
        if not full:
            raise AssertionError("no training batch of 64 captions")
        captured = {}
        orig = {"fwd": match.match_maxes, "bwd": match.match_maxes_bwd}

        def capturing(key):
            def call(*args):
                captured.setdefault(key, tuple(a.detach() for a in args))
                return orig[key](*args)
            return call

        match.match_maxes, match.match_maxes_bwd = capturing("fwd"), capturing("bwd")
        times = []
        try:
            reset()
            for k in range(3):
                x, y = full[k % len(full)]
                t0 = time.perf_counter()
                loss, aux = pipe.train_step(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0],
                                            False, 0.5)
                float(loss)
                times.append(time.perf_counter() - t0)
        finally:
            match.match_maxes, match.match_maxes_bwd = orig["fwd"], orig["bwd"]
        step = counts()
        by_path["vlgae_variational_train_steps"] = step
        want = {"dmv_fused": 6, "match_fwd": 3, "match_bwd": 3}
        if {k: v for k, v in step.items() if v} != want:
            raise AssertionError(f"variational joint step: launches {step}")
        if not ("lstm_kl" in aux and math.isfinite(float(aux["lstm_kl"]))):
            raise AssertionError(f"variational joint step: loss terms {sorted(aux)}")
        _, k5_err, _ = _check_k5(captured["fwd"], False, "on a variational joint step")
        k6_err = _check_k6(captured["bwd"], False, "on a variational joint step")
        result["vlgae_step"] = {"launches_3_steps": step, "k5_max_abs_err": k5_err,
                                "k6_max_abs_err": k6_err,
                                "lstm_kl": float(aux["lstm_kl"]),
                                "train_step_ms_B64": [round(t * 1e3, 3) for t in times]}

    # card against CPU at small widths, precision=32 (eval: the posterior mean)
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=8, feat_dim=16, n_box=6,
                    len_range=(3, 12), seed=1)
        cases = {
            "lang_only_all_vae": _lang_overrides(tmp, True) + ["model.variational_mode=all:vae",
                                                               "model.z_dim=8"],
            "lang_only_tag_ib": _lang_overrides(tmp, True) + ["model.variational_mode=tag:ib",
                                                              "model.z_dim=8"],
            "lang_only_max": _lang_overrides(tmp, True) + ["model.context_mode=max"],
            "vlgae_all_ib": _small_overrides(tmp) + [
                "model.dep_model_cfg.variational_mode=all:ib",
                "model.dep_model_cfg.z_dim=8"],
        }
        result["card_vs_cpu"] = {}
        for name, ovs in cases.items():
            files = {}
            for dev in ("cpu", "cuda"):
                _run_predict(tmp, ovs + ["init_seed=0", f"device={dev}", f"name={name}_{dev}"])
                with open(os.path.join(tmp, f"{name}_{dev}_dev.conll")) as f:
                    files[dev] = f.read()
            result["card_vs_cpu"][name] = files["cpu"] == files["cuda"]
            if files["cpu"] != files["cuda"]:
                emit(result)
                raise AssertionError(f"variational {name}: card and CPU predict differently")
    result["launches_by_path"] = by_path
    emit(result)
    for path, c in by_path.items():
        for kname, n in c.items():
            if n:
                state.setdefault(kname, {}).setdefault("launches_by_path", {})[path] = n


# -- the datamodule and embedding options: a BERT directory, DepDataModule, gold graphs
# bert-base-cased's published widths (its config.json on the Hugging Face hub)
BERT_BASE = {"model_type": "bert", "vocab_size": 28996, "hidden_size": 768,
             "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "max_position_embeddings": 512,
             "type_vocab_size": 2, "hidden_act": "gelu", "layer_norm_eps": 1e-12}
BERT_NARROW = dict(BERT_BASE, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128)
# the gold scene graph and whole-image features (vis_encoder.use_img)
GOLD_IMG = ["datamodule.use_gold_scene_graph=true", "datamodule.use_img=true",
            "vis_encoder.use_img=true"]


def corpus_words(root):
    """Every word of the corpus's CoNLL files."""
    words = []
    for split in ("train", "init", "val", "test"):
        with open(os.path.join(root, f"{split}.conll")) as f:
            words += [line.split("\t")[1] for line in f if line.strip()]
    return words


def write_bert_dir(path, words, config):
    """A BERT directory without weights and without ``tokenizer_config.json``
    (so ``do_lower_case`` takes its default, true): ``config.json`` and a
    WordPiece ``vocab.txt`` of the special tokens, then of ``words``: every
    other one whole, the rest as their first two letters and one ``##``
    piece a letter, every fifth one left out (it tokenizes to ``[UNK]``)."""
    os.makedirs(path, exist_ok=True)
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    for i, w in enumerate(sorted({w.lower() for w in words})):
        if i % 5 == 4:
            continue
        pieces += [w] if i % 2 == 0 or len(w) < 3 else [w[:2]] + [f"##{c}" for c in w[2:]]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(dict.fromkeys(pieces)) + "\n")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return path


def write_gold_and_images(root, seed):
    """Beside the corpus at ``root``: ``gold_feats/<img_id>.npy`` (one row an
    object of the image's scene graph: features of the width of
    ``det_feats/`` and box),
    ``vlparse_train_sg_raw.json`` (the training images' scene graphs with
    four objects and two relations in place of three and one) and
    ``<split>.npy`` (one whole-image feature row an image)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "gold_feats"), exist_ok=True)
    with open(os.path.join(root, "vlparse.json")) as f:
        sg = {e["coco_id"]: e for e in json.load(f)}
    feat_dim = np.load(os.path.join(root, "det_feats", f"{min(sg)}.npy")).shape[1] - 4
    with open(os.path.join(root, "id_list", "train.txt")) as f:
        train_ids = {int(line) for line in f if line.strip()}
    raw = []
    for img_id in sorted(sg):
        entry = sg[img_id]
        if img_id in train_ids:
            objs = [dict(id=k, x=float(10 * k), y=5.0, width=20.0, height=30.0 + k)
                    for k in range(4)]
            rels = [dict(id=4, subj=0, obj=1, x=0.0, y=0.0, width=1.0, height=1.0),
                    dict(id=5, subj=3, obj=2, x=0.0, y=0.0, width=1.0, height=1.0)]
            txt2sg = [{"1": {"type": "OBJ", "preferred": s % 4, "candidates": [[s % 4, 1.0]]},
                       "2": {"type": "REL", "preferred": 4 + s % 2, "candidates": [[4, 1.0]]},
                       "0": {"type": "ATTR", "preferred": 3, "candidates": [[3, 1.0]]}}
                      for s in range(5)]
            entry = dict(entry, obj=objs, rel=rels, txt2sg=txt2sg)
            raw.append(entry)
        boxes = np.array([[o["x"], o["y"], o["x"] + o["width"], o["y"] + o["height"]]
                          for o in entry["obj"]], np.float32)
        feats = rng.standard_normal((len(boxes), feat_dim)).astype(np.float32)
        np.save(os.path.join(root, "gold_feats", f"{img_id}.npy"),
                np.concatenate([feats, boxes], 1))
    with open(os.path.join(root, "vlparse_train_sg_raw.json"), "w") as f:
        json.dump(raw, f)
    for split in ("train", "init", "val", "test"):
        with open(os.path.join(root, "id_list", f"{split}.txt")) as f:
            n = len(f.read().split())
        np.save(os.path.join(root, f"{split}.npy"),
                rng.standard_normal((n, feat_dim)).astype(np.float32))


def _dep_overrides(root):
    """``datamodule._target_`` set to ``DepDataModule`` on the plain CoNLL
    files of the corpus under ``root``, with ``ignore_stop_word``."""
    v = os.path.join(root, "vlparse")
    return ["datamodule._target_=vlgae_tpu.data.DepDataModule",
            f"datamodule.train_path={v}/train.conll",
            f"datamodule.train_init_path={v}/init.conll",
            f"datamodule.dev_path={v}/val.conll", f"datamodule.test_path={v}/test.conll",
            "datamodule.ignore_stop_word=true"]


def _card_vs_cpu_dev(tmp, overrides, name, joint):
    """``predict`` (weights from seed 0) on the CPU and on the card: the dev
    files identical, or, for the joint model, a row differing only where a
    near tie decides it: its ALIGN column where its grounding or its tree
    holds a near tie (``_tied_align_rows``, as phase ``mbr`` allows), and its
    arcs too where the sentence's Viterbi tree wins by less than
    ``MBR_MARGIN`` (on an exact tie K1 marks every best tree where the CPU
    splits, and the heads are an argmax over those marks); the dev losses
    within 1e-4."""
    import torch

    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    texts, losses, card = {}, {}, None
    for dev in ("cpu", "cuda"):
        pipe, res = _run_predict(tmp, overrides + ["init_seed=0", f"device={dev}",
                                                   f"name={name}_{dev}"])
        with open(os.path.join(tmp, f"{name}_{dev}_dev.conll")) as f:
            texts[dev] = f.read()
        losses[dev] = res["dev"]["loss"]
        card = pipe if dev == "cuda" else card
    blocks = [[b.splitlines() for b in texts[d].split("\n\n") if b.strip()]
              for d in ("cuda", "cpu")]
    ids = [inst["id"] for inst in card.dm.datasets["dev"]]
    differ = {(sid, i): (ra.split("\t"), rb.split("\t")) for sid, a, b in zip(ids, *blocks)
              for i, (ra, rb) in enumerate(zip(a, b)) if ra != rb}
    untied, won = dict(differ), {}
    if differ and joint:
        tied = {}
        with torch.no_grad():
            for x, _ in card.dm.batches("dev", shuffle=False):
                xp, real = pad_batch_pow2(x)
                inputs = shard_batch(xp, card.dp)
                o = card.model.eval()(inputs)
                lens = inputs["seq_len"]
                viterbi = torch.argmax(o["dep_reuse"]["max"][2].sum(-1)[:, :, 1:], dim=1)
                m = dmv_margins(o["merged_dec"], o["merged_attach"], lens, viterbi)
                for j, (sid, t) in enumerate(zip(x["id"][:real], _tied_align_rows(
                        card.model, o, inputs, real))):
                    tied[int(sid)], won[int(sid)] = t, float(m[j]) >= MBR_MARGIN
        untied = {k: v for k, v in differ.items()
                  if won[k[0]] and (v[0][:4] != v[1][:4] or not tied[k[0]][0]
                                    and k[1] not in tied[k[0]][1])}
    out = {"identical_dev_file": texts["cpu"] == texts["cuda"], "dev_loss": losses,
           "sentences": len(ids), "rows_differing": len(differ),
           "rows_differing_head": sum(a[:4] != b[:4] for a, b in differ.values()),
           "sentences_won_by_less_than_margin": sum(not w for w in won.values()),
           "rows_differing_untied": len(untied),
           "untied_rows": {f"{sid}:{i}": v for (sid, i), v in list(untied.items())[:4]}}
    if not (len(blocks[0]) == len(blocks[1]) == len(ids) and not untied
            and abs(losses["cpu"] - losses["cuda"]) <= 1e-4 * (1 + abs(losses["cpu"]))):
        raise AssertionError(f"data_options {name}: card and CPU disagree: {out}")
    return out


def _predict_steps(pipe):
    """The eval steps of one ``predict`` run: every batch of its splits."""
    return sum(len(list(pipe.dm.batches(s, shuffle=False)))
               for s in ("train", "dev", "test") if s in pipe.dm.datasets)


def _joint_steps(pipe, batches, n):
    """``n`` joint train steps at B = 64 (host clock), K5's and K6's first
    call captured; ``(times, launches, captured)``."""
    from vlgae_tpu_torch.ops import match
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    captured = {}
    orig = {"fwd": match.match_maxes, "bwd": match.match_maxes_bwd}

    def capturing(key):
        def call(*args):
            captured.setdefault(key, tuple(a.detach() for a in args))
            return orig[key](*args)
        return call

    match.match_maxes, match.match_maxes_bwd = capturing("fwd"), capturing("bwd")
    times = []
    try:
        reset_kernel_counts()
        for k in range(n):
            x, y = batches[k % len(batches)]
            t0 = time.perf_counter()
            loss, _ = pipe.train_step(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0], False, 0.5)
            float(loss)
            times.append(time.perf_counter() - t0)
    finally:
        match.match_maxes, match.match_maxes_bwd = orig["fwd"], orig["bwd"]
    return times, kernel_counts(), captured


def _joint_kernels_on_path(pipe, batch, captured, what):
    """K1 (log and max) on the eval forward of a training batch, K5 and K6
    on a train step's captured tensors, each against its plain version."""
    import torch

    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    with torch.no_grad():
        inputs = shard_batch(pad_batch_pow2(batch[0])[0], pipe.dp)
        k1 = _check_dmv_on_path(pipe.model.eval()(inputs), inputs["seq_len"])
    _, k5_err, k5_off = _check_k5(captured["fwd"], False, what)
    k6_err = _check_k6(captured["bwd"], False, what)
    return {"k1": k1, "k5_max_abs_err": k5_err, "k5_index_mismatch_within_tol": k5_off,
            "k6_max_abs_err": k6_err, "vis": list(captured["fwd"][0].shape),
            "txt": list(captured["fwd"][1].shape)}


def phase_data_options(state):
    """The datamodule and embedding options on the kernels' paths, random
    weights from seed 0: (a) ``exp=vlgae`` at bf16 with a local BERT
    directory at bert-base-cased's published widths (768 x 12, a WordPiece
    ``vocab.txt`` of the corpus): three train steps at B = 64, K1 / K5 / K6
    held to their plain versions on a step's tensors, the BERT forward's
    device time and memory, ``predict`` and ``eval.py``; card against CPU
    at 64 x 2 and precision=32. (b) ``exp=lang_only`` through
    ``DepDataModule`` (plain CoNLL) with ``ignore_stop_word``: one warm-up
    and one NLL epoch, ``predict``, the K3 pair, K1 (max) and K2/K4 held to
    their plain versions on a batch's tensors; card against CPU. (c)
    ``exp=vlgae`` with the gold scene graph and whole-image features: one
    train step (K1, K5, K6 held), ``predict``, ``eval.py``; card against
    CPU."""
    import math

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import train
    from vlgae_tpu_torch.ops import dmv_cuda
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    counts, reset = kernel_counts, reset_kernel_counts
    result = {"phase": "data_options"}
    by_path = {}
    bucket1 = [f"datamodule.{s}_dataloader.num_bucket=1" for s in ("train", "dev", "test")]

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=104, feat_dim=2048, n_box=36, len_range=(3, 50), seed=0)
        # (a) a BERT directory at bert-base-cased's widths
        bert = write_bert_dir(os.path.join(tmp, "bert-base"), corpus_words(root), BERT_BASE)
        ovs = _corpus_overrides(tmp) + bucket1 + [f"embedding.transformer.args.model={bert}"]
        t0 = time.perf_counter()
        pipe = _grounding_pipeline(tmp, ovs, "cuda")
        item = pipe.model.dependency.embedding.transformer
        n_bert = sum(p.numel() for p in item.bert.parameters())
        a = {"bert": {k: BERT_BASE[k] for k in ("hidden_size", "num_hidden_layers",
                                                 "num_attention_heads", "intermediate_size",
                                                 "vocab_size")},
             "bert_params": n_bert, "bert_param_bytes": 4 * n_bert,
             "build_s": round(time.perf_counter() - t0, 3)}
        H, L, inter = (BERT_BASE[k] for k in ("hidden_size", "num_hidden_layers",
                                              "intermediate_size"))
        if item.bert.config.hidden_size != H or len(item.bert.encoder.layer) != L:
            raise AssertionError(f"data_options: the BERT is {item.bert.config}")
        ids = {i for inst in pipe.dm.datasets["train"] for i in inst["subword_ids"]}
        if not ({1, 2, 3} <= ids and len(ids) > 10):
            raise AssertionError(f"data_options: subword ids {sorted(ids)}")
        full = [b for b in pipe.dm.batches("train") if len(b[0]["seq_len"]) == 64]
        if not full:
            raise AssertionError("no training batch of 64 captions")
        times, step, captured = _joint_steps(pipe, full, 3)
        want = {"dmv_fused": 6, "match_fwd": 3, "match_bwd": 3}
        if {k: v for k, v in step.items() if v} != want:
            raise AssertionError(f"bert-base joint steps: launches {step}")
        by_path["bert_base_train_steps"] = step
        a["kernels_on_path"] = _joint_kernels_on_path(pipe, full[0], captured,
                                                      "on a bert-base joint step")
        a["train_step_ms_B64"] = [round(t * 1e3, 3) for t in times]
        # the steps' device-busy time under the profiler (kernel time only)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for x, y in full[:2]:
                loss, _ = pipe.train_step(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0],
                                          False, 0.5)
                float(loss)
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / 2
        a["profiled_train_step"] = {"wall_ms": wall * 1e3 / 2, "device_busy_ms": busy,
                                    "idle_share": 1 - busy / (wall * 1e3 / 2),
                                    "kernels": len(kern) / 2}
        # the frozen BERT's forward alone on the longest batch's subwords
        x = max(full, key=lambda b: b[0]["subword"].shape[1])[0]
        sub = [torch.as_tensor(x[k]).cuda() for k in ("subword", "subword_mask",
                                                     "subword_first", "subword_last")]
        B, S = sub[0].shape
        flops = B * L * (2 * S * (4 * H * H + 2 * H * inter) + 4 * S * S * H)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            ms = time_ms(lambda: item(*sub), reps=7)
        a["bert_forward"] = {
            "B": B, "S": S, "device_ms": ms, "flops": flops,
            "bound_ms_f32": flops / PEAK_FLOPS["f32"] * 1e3,
            "tflop_per_s": flops / ms / 1e9,
            "activation_peak_bytes": torch.cuda.max_memory_allocated() - base}
        # predict from the trained weights, eval.py on its dev file
        pipe.save_checkpoint("last")
        reset()
        t0 = time.perf_counter()
        ppipe, res = _run_predict(tmp, ovs + [
            f"checkpoint={os.path.join(tmp, 'checkpoint', 'last.pt')}", "device=cuda",
            "name=bert"])
        torch.cuda.synchronize()
        a["predict_s"] = round(time.perf_counter() - t0, 3)
        c = counts()
        n_steps = _predict_steps(ppipe)
        if c["dmv_fused"] != 2 * n_steps or c["match_fwd"] != n_steps:
            raise AssertionError(f"bert-base predict: launches {c} over {n_steps} steps")
        by_path["bert_base_predict"] = c
        if not all(math.isfinite(float(r["loss"])) for r in res.values()):
            raise AssertionError(f"bert-base predict: {res}")
        a["predict"] = {k: res[k] for k in ("dev", "test")}
        a["eval_py_tail"] = check_eval(root, os.path.join(tmp, "bert_dev.conll"))
        result["bert_base"] = a
        del pipe, ppipe, item, sub
        torch.cuda.empty_cache()

        # (c) the gold scene graph and whole-image features on the same corpus
        write_gold_and_images(root, seed=3)
        ovs = _corpus_overrides(tmp) + bucket1 + GOLD_IMG
        pipe = _grounding_pipeline(tmp, ovs, "cuda")
        full = [b for b in pipe.dm.batches("train") if len(b[0]["seq_len"]) == 64]
        x0 = full[0][0]
        if not ("vis_img" in x0 and (x0["vis_box_mask"].sum(1) == 4).all()
                and x0["vis_rel_mask"].any()):
            raise AssertionError("gold scene graph: the batches hold no gold boxes")
        times, step, captured = _joint_steps(pipe, full, 1)
        if {k: v for k, v in step.items() if v} != {"dmv_fused": 2, "match_fwd": 1,
                                                    "match_bwd": 1}:
            raise AssertionError(f"gold scene graph step: launches {step}")
        by_path["gold_img_train_step"] = step
        c_res = {"train_step_ms_B64": [round(t * 1e3, 3) for t in times],
                 "kernels_on_path": _joint_kernels_on_path(pipe, full[0], captured,
                                                           "on a gold scene graph step")}
        pipe.save_checkpoint("last")
        reset()
        ppipe, res = _run_predict(tmp, ovs + [
            f"checkpoint={os.path.join(tmp, 'checkpoint', 'last.pt')}", "device=cuda",
            "name=gold"])
        c = counts()
        n_steps = _predict_steps(ppipe)
        if c["dmv_fused"] != 2 * n_steps or c["match_fwd"] != n_steps:
            raise AssertionError(f"gold predict: launches {c} over {n_steps} steps")
        by_path["gold_img_predict"] = c
        c_res["predict"] = {k: res[k] for k in ("dev", "test")}
        c_res["eval_py_tail"] = check_eval(root, os.path.join(tmp, "gold_dev.conll"))
        result["gold_img"] = c_res
        del pipe, ppipe

    # card against CPU at small widths and precision=32
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=8, feat_dim=16, n_box=6, len_range=(3, 12), seed=1)
        bert = write_bert_dir(os.path.join(tmp, "bert"), corpus_words(root), BERT_NARROW)
        result["bert_base"]["card_vs_cpu"] = _card_vs_cpu_dev(
            tmp, _small_overrides(tmp) + [f"embedding.transformer.args.model={bert}"],
            "bert_narrow", joint=True)
        result["dep_lang_only_card_vs_cpu"] = _card_vs_cpu_dev(
            tmp, _lang_overrides(tmp, True) + _dep_overrides(tmp), "dep", joint=False)
        write_gold_and_images(root, seed=4)
        result["gold_img"]["card_vs_cpu"] = _card_vs_cpu_dev(
            tmp, _small_overrides(tmp) + GOLD_IMG, "gold", joint=True)

    # (b) exp=lang_only through DepDataModule, at the recipe's widths
    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=400, feat_dim=4, n_box=3,
                    len_range=(3, 50), seed=0)
        run = os.path.join(tmp, "run")
        ovs = _lang_overrides(tmp, False) + _dep_overrides(tmp)
        reset()
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            pipe, test = train.main(ovs + ["trainer.max_epochs=2", "model.init_epoch=1",
                                           f"workdir={run}", "init_seed=0", "device=cuda"])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        b = {"train_s": round(time.perf_counter() - t0, 3), "test": test,
             "datamodule": type(pipe.dm).__name__,
             "stop_words": pipe.dm.stop_words_source,
             "dev_captions": len(pipe.dm.datasets["dev"])}
        raw = dmv_cuda.launch_counts()
        by_path["dep_lang_only_train"] = counts()
        if not (sum(raw["inside_save"].values()) == raw["outside"] > 0
                and sum(raw["inside"].values()) == raw["fused"] > 0
                and b["datamodule"] == "DepDataModule"):
            raise AssertionError(f"dep lang_only train: launches {raw}, {b}")
        insts = [i for i in pipe.dm.datasets["train"] if i["seq_len"] <= 16][:64]
        x, _ = pipe.dm.collate("train", insts, 16)
        b["kernels_on_batches"] = {"train_L=16": _check_lang_batch(
            pipe, pad_batch_pow2(x)[0], True)}
        x, _ = next(pipe.dm.batches("dev", shuffle=False))
        b["kernels_on_batches"]["eval"] = _check_lang_batch(pipe, pad_batch_pow2(x)[0], False)
        reset()
        ppipe, res = _run_predict(tmp, [
            f"checkpoint={os.path.join(run, 'checkpoint', 'last.pt')}", "device=cuda",
            "name=dep"])
        c = dmv_cuda.launch_counts()
        n_steps = _predict_steps(ppipe)
        if not (c["fused"] == n_steps == sum(c["inside"].values())
                and c["inside"]["warp"] > 0 and c["inside"]["smem"] > 0):
            raise AssertionError(f"dep lang_only predict: launches {c} over {n_steps} steps")
        by_path["dep_lang_only_predict"] = counts()
        with open(os.path.join(tmp, "dep_dev.conll")) as f:
            n_sent = f.read().count("\n\n")
        if n_sent != len(ppipe.dm.datasets["dev"]) or not all(
                math.isfinite(float(r["loss"])) for r in res.values()):
            raise AssertionError(f"dep lang_only predict: {n_sent} sentences, {res}")
        b["predict"] = {k: res[k] for k in ("dev", "test")}
        result["dep_lang_only"] = b
    result["launches_by_path"] = by_path
    emit(result)
    for path, c in by_path.items():
        for kname, n in c.items():
            if n:
                state.setdefault(kname, {}).setdefault("launches_by_path", {})[path] = n


# launches of one step on the data-parallel path (exp=vlgae, bf16): a
# warm-up step launches nothing; a joint train step K1 twice (log and max
# trees), K5 and K6 through match_maxes_sharded; an eval step K1 twice and K5
PARALLEL_STEP_LAUNCHES = {
    "warmup": {"dmv_fused": 0, "match_fwd": 0, "match_bwd": 0, "match_maxes_sharded": 0},
    "train": {"dmv_fused": 2, "match_fwd": 1, "match_bwd": 1, "match_maxes_sharded": 1},
    "eval": {"dmv_fused": 2, "match_fwd": 1, "match_bwd": 0, "match_maxes_sharded": 1},
}
PARALLEL_LOSS_RTOL = 1e-6
# a (data, model) grid against the plain run. The first step's loss: the
# row-parallel product sums the model ranks' partial products, an f32
# reordering; under bf16 a reordered sum can round an operand to the next
# bf16 value, one bf16 ulp relative. The metric lines after a warm-up and a
# joint epoch of 3 steps: near-tied Viterbi trees and matching winners flip
# under that round-off and Adam's first steps carry it on (1.1e-3 at f32,
# 4.3e-4 at bf16 on four H100s); a wrong collective moves them by far more
TP_F32_RTOL, TP_BF16_RTOL, TP_LINES_RTOL = 1e-5, 2.0 ** -8, 1e-2


def torchrun_worker(out_path, module, args):
    """``vlgae_tpu_torch.<module>.main(args)`` in this process (a rank under
    ``torchrun``, or a plain process), with PyTorch's deterministic
    algorithms where it has them, so that two runs of the same steps add in
    the same order; writes the launches of each train and eval step, each
    train step's loss (summed over the data group: the global batch's) and
    where the process group ran to ``out_path`` (rank 0)."""
    import torch
    import torch.distributed as dist

    torch.use_deterministic_algorithms(True, warn_only=True)
    sys.path.insert(0, ROOT)
    from vlgae_tpu_torch import predict, train
    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.parallel.mesh import global_sum, is_sharded, shutdown
    from vlgae_tpu_torch.training.pipeline import Pipeline

    def counts():
        m = match.launch_counts()
        return {"dmv_fused": dmv_cuda.launch_counts()["fused"], "match_fwd": m["fwd"],
                "match_bwd": m["bwd"], "match_maxes_sharded": m["sharded"]}

    steps, losses = [], []

    def counting(kind, fn):
        def step(self, x, *rest):
            before = counts()
            out = fn(self, x, *rest)
            torch.cuda.synchronize()
            after = counts()
            what = "warmup" if kind == "train" and rest[1] else kind
            steps.append({"kind": what, **{k: after[k] - before[k] for k in after}})
            if kind == "train":
                losses.append(float(global_sum(out[0].detach(), self.dp)))
            return out
        return step

    Pipeline.train_step = counting("train", Pipeline.train_step)
    Pipeline.eval_step = counting("eval", Pipeline.eval_step)
    try:
        pipe, _ = {"train": train, "predict": predict}[module].main(args)
        grouped = dist.is_initialized()
        info = {"backend": dist.get_backend() if grouped else None,
                "world": dist.get_world_size() if grouped else 1,
                "grid": [pipe.dp.world, pipe.mp.size],
                "rank": pipe.world.rank, "device": str(pipe.device),
                "group": pipe.dp.group is not None, "steps": steps, "losses": losses,
                "launches": counts(),
                # (the state dict's leaves: FSDP registers them sharded for it)
                "sharded_params": sum(is_sharded(t) for t in pipe.model.state_dict().values()),
                "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
        if pipe.world.rank == 0:
            with open(out_path, "w") as f:
                json.dump(info, f)
    finally:
        shutdown()


def _torchrun(module, args, cwd, tag, launcher=True, nproc=1):
    """``python -m torch.distributed.run --standalone --nproc_per_node=<nproc>``
    of :func:`torchrun_worker` (with ``launcher=False``, the worker alone, as
    a plain process); rank 0's JSON."""
    out = os.path.join(cwd, f"{tag}.json")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}"] if launcher else [sys.executable])
    # cuBLAS's deterministic workspace, for the deterministic algorithms
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        launch + [os.path.abspath(__file__), "--torchrun-worker", out, module, *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module} ({tag}) rc {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def _run_losses(workdir):
    import json as _json

    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [_json.loads(line) for line in f]
    return [{k: v for k, v in rec.items()
             if k.startswith(("train/", "val/", "test/")) and not k.endswith("time")}
            for rec in lines]


def phase_parallel(state):
    """Data-parallel training on the card. NCCL refuses two ranks on one
    device, so the world is 1: ``train`` under ``torchrun
    --nproc_per_node=1`` with ``model.match_kernel=pallas_sharded`` at the
    recipe's widths and bf16 on the corpus of phase ``train`` (one warm-up
    and one joint epoch of 3 steps each), replicated and with
    ``trainer.fsdp``: the NCCL group on cuda:0, each step's launches (K1
    twice, K5 and K6 through ``match_maxes_sharded``), the metric lines equal
    the plain run's (one process, no torchrun) within
    ``PARALLEL_LOSS_RTOL``; then ``predict`` under torchrun and ``eval.py``.
    Every run is a fresh process with PyTorch's deterministic algorithms
    (atomic adds in some backward kernels would otherwise reorder sums, and
    Adam's first steps turn that into 1e-6 of the loss within 3 steps)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    with tempfile.TemporaryDirectory() as tmp:
        make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048,
                    n_box=36, len_range=(3, 50), seed=0)
        base = _corpus_overrides(tmp) + [
            f"datamodule.{s}_dataloader.num_bucket=1" for s in ("train", "dev", "test")] + [
            "trainer.max_epochs=2", "model.init_epoch=1", "trainer.fast_dev_run=3",
            "init_seed=0", "device=cuda"]
        t0 = time.perf_counter()
        info = plain_info = _torchrun("train", base + [
            f"workdir={os.path.join(tmp, 'plain')}"], tmp, "plain", launcher=False)
        if info["backend"] is not None:
            raise AssertionError(f"the plain run joined a process group: {info}")
        plain = _run_losses(os.path.join(tmp, "plain"))
        result = {"phase": "parallel", "plain_s": round(time.perf_counter() - t0, 3),
                  "runs": {}}
        launches = {}
        for tag, extra in (("replicated", []), ("fsdp", ["trainer.fsdp=true"])):
            workdir = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            info = _torchrun("train", base + ["model.match_kernel=pallas_sharded",
                                              f"workdir={workdir}"] + extra, tmp, tag)
            run = {"s": round(time.perf_counter() - t0, 3),
                   **{k: info[k] for k in ("backend", "world", "device", "nccl",
                                           "sharded_params", "launches")}}
            if (info["backend"], info["world"], info["device"], info["group"]) != (
                    "nccl", 1, "cuda:0", True):
                raise AssertionError(f"torchrun {tag}: the group ran {info}")
            # the JAX rule shards nothing over one rank: trainer.fsdp leaves
            # the model whole at world 1 (FSDP2 runs at world >= 2 only)
            if info["sharded_params"]:
                raise AssertionError(f"torchrun {tag}: {info['sharded_params']} sharded "
                                     "leaves at world 1")
            kinds = {}
            for step in info["steps"]:
                kind = step.pop("kind")
                if step != PARALLEL_STEP_LAUNCHES[kind]:
                    raise AssertionError(f"torchrun {tag}: a {kind} step launched {step}")
                kinds[kind] = kinds.get(kind, 0) + 1
            if not (kinds.get("train") and kinds.get("eval") and kinds.get("warmup")):
                raise AssertionError(f"torchrun {tag}: steps {kinds}")
            got = _run_losses(workdir)
            worst = 0.0
            if len(got) != len(plain):
                raise AssertionError(f"torchrun {tag}: {len(got)} metric lines, plain {len(plain)}")
            for a, b in zip(got, plain):
                for k, v in b.items():
                    if not isinstance(v, float) or "loss" not in k and not k.endswith(
                            ("nll", "enll", "txt2vis", "vis2txt")):
                        continue
                    rel = abs(a[k] - v) / max(abs(v), 1e-30)
                    worst = max(worst, rel)
                    if rel > PARALLEL_LOSS_RTOL:
                        raise AssertionError(f"torchrun {tag}: {k} {a[k]} vs plain {v}")
            run.update(steps=kinds, loss_max_rel_vs_plain=worst,
                       per_step=PARALLEL_STEP_LAUNCHES)
            result["runs"][tag] = run
            launches[f"parallel_train_{tag}"] = info["launches"]
        # predict under torchrun on the FSDP run's checkpoint, then eval.py
        pdir = os.path.join(tmp, "predict")
        os.makedirs(pdir)
        info = _torchrun("predict", [
            f"checkpoint={os.path.join(tmp, 'fsdp', 'checkpoint', 'last.pt')}",
            "device=cuda", "name=dp"], pdir, "predict")
        for step in info["steps"]:
            kind = step.pop("kind")
            if step != PARALLEL_STEP_LAUNCHES[kind]:
                raise AssertionError(f"torchrun predict: an {kind} step launched {step}")
        result["predict"] = {"eval_steps": len(info["steps"]), "backend": info["backend"],
                             "eval_py": check_eval(os.path.join(tmp, "vlparse"),
                                                   os.path.join(pdir, "dp_dev.conll"))}
        launches["parallel_predict"] = info["launches"]
        # trainer.model_parallel=2 over several cards, each grid against a
        # plain run: the (1, 2) grid at bf16 (the recipe: K5/K6 on the path)
        # and at precision 32, with four cards the (2, 2) grid with FSDP at
        # bf16. A model rank sums the row-parallel product in another order
        # than one process: the first step's loss (before any update) is
        # held to that round-off, f32 (TP_F32_RTOL) or one bf16 ulp
        # (TP_BF16_RTOL); the metric lines after two epochs, where Viterbi
        # trees and matching winners flip on near ties and Adam's first
        # steps carry the difference on, to TP_LINES_RTOL
        cards = torch.cuda.device_count()
        if cards < 2:
            result["grids"] = ("not run: one card; NCCL refuses two ranks on one device, "
                               "so trainer.model_parallel=2 needs two cards or more")
        else:
            f32 = ["trainer.precision=32"]
            plain32_info = _torchrun("train", base + f32 + [
                f"workdir={os.path.join(tmp, 'plain32')}"], tmp, "plain32", launcher=False)
            plain32 = _run_losses(os.path.join(tmp, "plain32"))
            steps_f32 = {kind: {**n, "match_fwd": 0, "match_bwd": 0, "match_maxes_sharded": 0}
                         for kind, n in PARALLEL_STEP_LAUNCHES.items()}
            grids = [("grid_1x2", 2, [], (plain, plain_info), TP_BF16_RTOL,
                      PARALLEL_STEP_LAUNCHES),
                     ("grid_1x2_f32", 2, f32, (plain32, plain32_info), TP_F32_RTOL, steps_f32)]
            if cards >= 4:
                grids.append(("grid_2x2", 4, ["trainer.fsdp=true"], (plain, plain_info),
                              TP_BF16_RTOL, PARALLEL_STEP_LAUNCHES))
            result["grids"] = {}
            for tag, nproc, extra, (ref, ref_info), rtol, per_step in grids:
                workdir = os.path.join(tmp, tag)
                t0 = time.perf_counter()
                info = _torchrun("train", base + ["model.match_kernel=pallas_sharded",
                                                  "trainer.model_parallel=2",
                                                  f"workdir={workdir}"] + extra,
                                 tmp, tag, nproc=nproc)
                if (info["backend"], info["world"], tuple(info["grid"])) != (
                        "nccl", nproc, (nproc // 2, 2)):
                    raise AssertionError(f"torchrun {tag}: the group ran {info}")
                for step in info["steps"]:
                    kind = step.pop("kind")
                    if step != per_step[kind]:
                        raise AssertionError(f"torchrun {tag}: a {kind} step launched {step}")
                got = _run_losses(workdir)
                gaps = {}  # the largest relative gap of each metric over the lines
                for a, b in zip(got, ref):
                    for k, v in b.items():
                        if isinstance(v, float) and ("loss" in k or k.endswith(
                                ("nll", "enll", "txt2vis", "vis2txt"))):
                            gaps[k] = max(gaps.get(k, 0.0),
                                          abs(a[k] - v) / max(abs(v), 1e-30))
                first = abs(info["losses"][0] - ref_info["losses"][0]) / abs(
                    ref_info["losses"][0])
                if first > rtol or len(got) != len(ref) or max(gaps.values()) > TP_LINES_RTOL:
                    raise AssertionError(
                        f"torchrun {tag}: the first step's loss {first} from the plain "
                        f"run's (limit {rtol}); {len(got)} metric lines against {len(ref)}, "
                        f"relative gaps {gaps} (limit {TP_LINES_RTOL})")
                result["grids"][tag] = {"s": round(time.perf_counter() - t0, 3),
                                        "sharded_params": info["sharded_params"],
                                        "first_step_loss_rel_gap": first, "limit": rtol,
                                        "lines_rel_gap_vs_plain": gaps,
                                        "launches": info["launches"]}
                launches[f"parallel_train_{tag}"] = info["launches"]
        result["launches_by_path"] = launches
        emit(result)
    for path, c in launches.items():
        for kname, n in c.items():
            if n:
                state.setdefault(kname, {}).setdefault("launches_by_path", {})[path] = n
    if not state["match_maxes_sharded"].get("launches_by_path"):
        raise AssertionError("match_maxes_sharded was never launched on the parallel path")


GRANITE_SMALL = {
    "model_type": "granitemoehybrid", "vocab_size": 1000, "hidden_size": 256,
    "num_hidden_layers": 2, "layer_types": ["mamba", "attention"], "num_attention_heads": 4,
    "num_key_value_heads": 2, "attention_multiplier": 0.0078125, "mamba_n_heads": 8,
    "mamba_d_head": 64, "mamba_d_state": 128, "mamba_n_groups": 1, "mamba_d_conv": 4,
    "mamba_expand": 2, "mamba_chunk_size": 256, "num_local_experts": 72,
    "num_experts_per_tok": 10, "experts_held": 9, "intermediate_size": 128,
    "shared_intermediate_size": 256, "embedding_multiplier": 12, "residual_multiplier": 0.22,
    "rms_norm_eps": 1e-5, "position_embedding_type": "nope", "hidden_act": "silu"}


def phase_granite(state):
    """(a) K7 (``vlgae::moe_experts``) at the granite cell's layer: 64
    captions of 40 subword positions (2,560, of which 1,600 real), hidden
    4,096, experts of 768, top-10 of 72 drawn uniformly, experts 0-8 held;
    against the plain version, its device time, the plain version's, the
    bound (``perfbench/flops/granite.py``'s count); no PyTorch call computes
    it (library null). (b) ``exp=vlgae`` with a granite directory
    (``GRANITE_SMALL``: a Mamba2 and an attention layer, 72 experts, 9
    held) through the train CLI (one epoch) and ``predict`` on the card:
    K7 launched once a layer per encoder call."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch import predict, train
    from vlgae_tpu_torch.ops import moe
    from vlgae_tpu_torch.utils import trace

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    T, H, inter, E, k, nh = 2560, 4096, 768, 72, 10, 9
    x = torch.randn(T, H, generator=g).to(torch.bfloat16).to(dev)
    sel = torch.rand(T, E, generator=g).argsort(-1)[:, :k].to(dev)
    gates = torch.softmax(torch.randn(T, k, generator=g), -1).to(dev)
    mask = (torch.arange(T) % 40 < 25).to(dev)
    w_in = (0.02 * torch.randn(nh, 2 * inter, H, generator=g)).to(torch.bfloat16).to(dev)
    w_out = (0.02 * torch.randn(nh, H, inter, generator=g)).to(torch.bfloat16).to(dev)
    args = (x, sel, gates, 0, nh, mask, w_in, w_out)
    got = moe.moe_experts(*args)
    want = moe.moe_experts_plain(*args)
    err = float((got - want).abs().max())
    if err > 2e-3 * float(want.abs().max()):
        raise AssertionError(f"K7 against its plain version: {err}")
    held = (sel < nh) & mask[:, None]
    pairs, rows, live = int(held.sum()), int(held.any(1).sum()), int(mask.sum())
    hit = int(torch.unique(sel[held]).numel())
    row = {"max_abs_err": err, "ms": device_ms(lambda: moe.moe_experts(*args)),
           "plain_ms": device_ms(lambda: moe.moe_experts_plain(*args), n=3, reps=3),
           "library_ms": None, "pairs": pairs,
           **bound(hit * 3 * H * inter * 2 + rows * H * 2 + live * H * 4 + live * k * 12,
                   2 * 3 * H * inter * pairs, "bf16")}
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=16, feat_dim=2048, n_box=36, len_range=(3, 20), seed=0)
        gdir = write_bert_dir(os.path.join(tmp, "granite"), corpus_words(root), GRANITE_SMALL)
        ovs = _corpus_overrides(tmp) + [f"embedding.transformer.args.model={gdir}",
                                        "trainer.max_epochs=1", "model.init_epoch=0",
                                        "device=cuda", "init_seed=0",
                                        f"workdir={os.path.join(tmp, 'run')}"]
        c0 = trace.counters()
        pipe, _ = train.main(ovs)
        enc = pipe.model.dependency.embedding.transformer.bert
        n_layers = len(enc.layers)
        c1 = trace.counters()
        calls = (c1.get("moe.k7", 0) - c0.get("moe.k7", 0))
        if type(enc).__name__ != "GraniteHybrid" or calls == 0 or calls % n_layers:
            raise AssertionError(f"granite train: {type(enc).__name__}, K7 launches {calls}")
        by_path["granite_train"] = calls
        del pipe
        cwd = os.getcwd()
        os.chdir(tmp)  # predict writes <name>_<split>.conll here
        try:
            predict.main([f"checkpoint={os.path.join(tmp, 'run', 'checkpoint', 'last.pt')}",
                          "device=cuda", "name=granite"])
        finally:
            os.chdir(cwd)
        if not os.path.exists(os.path.join(tmp, "granite_dev.conll")):
            raise AssertionError("granite predict wrote no dev predictions")
        c2 = trace.counters()
        calls = c2.get("moe.k7", 0) - c1.get("moe.k7", 0)
        if calls == 0 or calls % n_layers:
            raise AssertionError(f"granite predict: K7 launches {calls}")
        by_path["granite_predict"] = calls
    row["launches_by_path"] = by_path
    state["moe_experts"] = row
    emit({"phase": "granite", **row})


def graphs_against_eager(make, batches, steps=12):
    """``steps`` joint-phase train steps (``Pipeline.grad_step`` then
    ``apply_step``, alpha 0.5) over ``batches`` in turn, of a fresh pipeline
    ``make()`` whose step runs as CUDA graphs against a second one whose
    ``StepGraphs`` never capture (the same stretches, eagerly), both from
    ``make``'s weights and dropout seed. Raises unless every step's loss,
    terms, gradients and updated parameters are bit-equal and every tensor
    argument of the graphed side's K1, K5 and K6 calls still holds its
    value after all steps; returns the readings. Both run under
    ``torch.use_deterministic_algorithms``: the backward's scatter and
    index-add kernels otherwise sum by atomics in an order that differs
    from run to run (two eager runs differ as much), and cuBLAS takes a
    fixed workspace (``CUBLAS_WORKSPACE_CONFIG``, where cuBLAS is not yet
    set up in the process)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _graphs_against_eager(make, batches, steps)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _graphs_against_eager(make, batches, steps):
    import torch

    from vlgae_tpu_torch.ops import dmv_cuda, match
    from vlgae_tpu_torch.training.graphs import StepGraphs
    from vlgae_tpu_torch.utils import trace

    graphed, eager = make(), make()
    eager._graphable, eager.graphs = True, StepGraphs(eager)
    eager.graphs.capturing = False
    calls = []
    entries = [(dmv_cuda, "dmv_fused"), (match, "match_maxes"), (match, "match_maxes_bwd")]
    orig = [getattr(m, n) for m, n in entries]

    def recording(name, fn):
        def call(*args, **kw):
            calls.append((name, [(a, a.detach().clone()) for a in args if torch.is_tensor(a)]))
            return fn(*args, **kw)
        return call

    def step(pipe, x, y):
        t0 = time.perf_counter()
        loss, terms = pipe.grad_step(x, y, False, 0.5)
        grads = [p.grad.clone() for p in pipe.optimizer.params]
        pipe.apply_step()
        params = [p.detach().clone() for p in pipe.optimizer.params]
        torch.cuda.synchronize()
        return (loss, terms, grads, params), time.perf_counter() - t0

    gaps, times = [], {"graphed": [], "eager": []}
    names = ("graph.capture", "graph.replay", "graph.eager")
    counters = dict.fromkeys(names, 0)
    for i in range(steps):
        x, y = batches[i % len(batches)]
        for m, n in entries:
            setattr(m, n, recording(n, getattr(m, n)))
        c0 = trace.counters()
        try:
            got, t = step(graphed, x, y)
        finally:
            for (m, n), fn in zip(entries, orig):
                setattr(m, n, fn)
        c1 = trace.counters()
        for k in names:
            counters[k] += c1.get(k, 0) - c0.get(k, 0)
        want, t_eager = step(eager, x, y)
        times["graphed"].append(t * 1e3)
        times["eager"].append(t_eager * 1e3)
        pairs = ([(got[0], want[0])] + [(got[1][k], want[1][k]) for k in want[1]]
                 + list(zip(got[2], want[2])) + list(zip(got[3], want[3])))
        gaps.append(max(float((a.float() - b.float()).abs().max()) for a, b in pairs))
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"graphed step {i} differs from the eager one: "
                                 f"largest gap {gaps[-1]}")
    changed = [(n, i) for i, (n, args) in enumerate(calls)
               for a, then in args if not torch.equal(a, then)]
    if changed:
        raise AssertionError(f"kernel arguments overwritten after their step: {changed[:8]}")
    kinds = {n: sum(1 for c, _ in calls if c == n) for _, n in entries}
    if kinds != {"dmv_fused": 2 * steps, "match_maxes": steps, "match_maxes_bwd": steps}:
        raise AssertionError(f"kernel calls on the graphed side: {kinds}")
    return {"steps": steps, "bit_equal": True, "largest_gap": max(gaps),
            "kernel_calls": kinds, "arguments_kept": True, "counters": counters,
            "step_ms_graphed": [round(t, 3) for t in times["graphed"]],
            "step_ms_eager": [round(t, 3) for t in times["eager"]]}


def phase_graphs(state):
    """The graphed joint step against the same stretches run eagerly at the
    bertbase cell's configuration (``graphs_against_eager``), on two batch
    shapes of B = 64."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_data import make_corpus

    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params, pad_batch_pow2

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vlparse")
        make_corpus(root, n_imgs=40, feat_dim=2048, n_box=36, len_range=(3, 30), seed=0)
        bert = write_bert_dir(os.path.join(tmp, "bert-base"), corpus_words(root), BERT_BASE)
        ovs = _corpus_overrides(tmp) + [f"embedding.transformer.args.model={bert}",
                                        "datamodule.train_dataloader.num_bucket=2",
                                        "model.init_epoch=0"]
        cfg = compose(ovs)
        dm = build_datamodule(cfg)

        def make():
            model = build_model(cfg, dm)
            init_params(model, 7)
            pipe = Pipeline(model, dm, cfg, device="cuda", workdir=tmp, seed=11)
            pipe.setup_optimizer()
            return pipe

        shapes = {}
        for x, y in dm.batches("train", shuffle=False):
            xp, yp = pad_batch_pow2(x)[0], pad_batch_pow2(y)[0]
            shapes.setdefault(xp["token"].shape, (xp, yp))
        batches = [b for (B, _), b in sorted(shapes.items()) if B == 64][:2]
        if len(batches) < 2:
            raise AssertionError(f"two batch shapes of B = 64 wanted: {sorted(shapes)}")
        out = graphs_against_eager(make, batches)
        torch.cuda.synchronize()
    emit({"phase": "graphs", "shapes": [list(b[0]["token"].shape) for b in batches], **out})


PHASES = {"env": phase_env, "build": phase_build, "native_io": phase_native_io,
          "k1": phase_k1, "k5": phase_k5, "k6": phase_k6, "reference": phase_reference,
          "train_reference": phase_train_reference, "slice": phase_slice,
          "train": phase_train, "export": phase_export, "k2": phase_k2, "k3": phase_k3,
          "lang_only_reference": phase_lang_only_reference,
          "lang_only": phase_lang_only, "vit_reference": phase_vit_reference,
          "vit": phase_vit, "mbr": phase_mbr, "em": phase_em,
          "grounding_modes": phase_grounding_modes, "struct": phase_struct,
          "variational": phase_variational, "data_options": phase_data_options,
          "parallel": phase_parallel, "granite": phase_granite, "graphs": phase_graphs}


def main():
    if sys.argv[1:2] == ["--torchrun-worker"]:
        torchrun_worker(sys.argv[2], sys.argv[3], sys.argv[4:])
        return 0
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
    only = None
    if sys.argv[1:2] == ["--phases"]:
        only = {"env", "build", *sys.argv[2].split(",")}
        unknown = only - set(PHASES)
        if unknown:
            raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    for name, phase in PHASES.items():
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        phase(state)
        seconds[name] = round(time.perf_counter() - t0, 3)
    emit({"phase_seconds": seconds, "total_s": round(sum(seconds.values()), 3)})
    print(nvidia_smi_line())
    if only is not None:  # a subset drives only some paths: no kernel table
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
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
