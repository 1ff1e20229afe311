"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. env       - torch / CUDA / nvcc versions and the card (nvidia-smi)
  2. build     - compile every kernel from csrc/ (one nvcc per source, in
                 parallel)
  3. k1        - the fused DMV kernel against its plain version (log + max),
                 at B=64 with ragged lengths 1..50, a batch with lengths up
                 to 80 and n1 < 10
  4. k5        - the matching-max kernel against its plain version at
                 A=B=64, Q=102, V=703, D=128 (bf16)
  5. k6        - the matching backward against its plain version at the
                 training shape A=B=64, Q=102, V=739, D=128 (its K5 forward
                 held against the plain version too), exactly at a ragged
                 shape, and exactly where the bf16 rounding of the summed
                 cell weight shows
  6. reference - the card against the CPU on a small corpus (predictions)
  7. train_reference - one joint train step, the card against the CPU, at
                 small widths and precision=32 (loss and every gradient)
  8. slice     - ``vlgae_tpu_torch.predict`` (exp=vlgae, init_seed=0,
                 device=cuda) on a synthetic corpus at the recipe's widths,
                 then ``eval.py`` on the dev predictions
  9. train     - ``vlgae_tpu_torch.train`` on that corpus at the recipe's
                 widths and bf16: one warm-up and one joint epoch, the
                 checkpoints, ``eval.py`` on the test predictions, K5 and
                 K6 on a joint step's own tensors, and the train-step time
                 at B=64
Then the card's name and power limit, the per-kernel table and, as the
last line, ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero without that line. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    "dmv_fused": {
        "route": "cuda",
        "source": "vlgae_tpu_torch/csrc/dmv_fused.cu",
        "replaces": "vlgae_tpu/ops/dmv_pallas.py:878",
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
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        out = dict(zip(KERNELS, pool.map(one, KERNELS)))
    emit({"phase": "build", "seconds": out,
          "wall_s": round(time.perf_counter() - t0, 3)})


def _dmv_inputs(rng, lengths, n1, device):
    import numpy as np
    import torch

    from vlgae_tpu_torch.struct import dmv_merge

    B, n = len(lengths), n1 - 1
    dec = torch.tensor(rng.standard_normal((B, n, 2, 2, 2)), dtype=torch.float32)
    attach = torch.tensor(rng.standard_normal((B, n, n, 2)), dtype=torch.float32)
    root = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    mdec, mattach = dmv_merge(dec, attach, root)
    return (mdec.to(device), mattach.to(device),
            torch.tensor(np.asarray(lengths), dtype=torch.int32, device=device))


def phase_k1(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops.dmv_cuda import dmv_fused
    from vlgae_tpu_torch.struct import dmv_value_and_grads_plain

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    recipe = rng.integers(1, 51, 64)
    recipe[:3] = (1, 50, 0)  # length 1, the longest, a zero-length filler
    cases = {
        "B64_len1-50": (recipe, 51),
        "B16_len-to-80": (np.r_[80, 0, 1, rng.integers(51, 81, 13)], 81),
        "B16_n1-lt-10": (np.r_[0, 1, 8, rng.integers(0, 9, 13)], 9),
    }
    worst = 0.0
    result = {"phase": "k1", "cases": {}}
    for name, (lengths, n1) in cases.items():
        dec, attach, lens = _dmv_inputs(rng, lengths, n1, dev)
        for kind in ("log", "max"):
            kt, kd, ka = dmv_fused(dec, attach, lens, kind)
            pt, pd, pa = dmv_value_and_grads_plain(dec, attach, lens, kind)
            torch.cuda.synchronize()
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
            "ms": time_ms(lambda: dmv_fused(dec, attach, lens, kind)),
            "plain_ms": time_ms(
                lambda: dmv_value_and_grads_plain(dec, attach, lens, kind),
                reps=5, warmup=1),
        }
    result["timing_B64_len1-50"] = timing
    result["tolerance"] = {"total": [K1_TOTAL_ATOL, K1_TOTAL_RTOL],
                           "grads": [K1_GRAD_ATOL, K1_GRAD_RTOL]}
    emit(result)
    state["dmv_fused"] = {
        "max_abs_err": worst,
        "ms": timing["log"]["ms"] + timing["max"]["ms"],
        "plain_ms": timing["log"]["plain_ms"] + timing["max"]["plain_ms"],
    }


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


def phase_k5(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_cuda, match_maxes_plain

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    A = B = 64
    Q, V, D = 102, 703, 128
    vis = torch.tensor(rng.standard_normal((A, V, D)), dtype=torch.float32,
                       device=dev).bfloat16()
    txt = torch.tensor(rng.standard_normal((B, Q, D)), dtype=torch.float32,
                       device=dev).bfloat16()
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.2, -1e9, 0.0),
                      dtype=torch.float32, device=dev)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0),
                      dtype=torch.float32, device=dev)
    # a second shape with ragged tiles and Q over one 128-row chunk
    # (captions of 100 words), checked for exact agreement
    small = [torch.tensor(rng.integers(-8, 9, s) * 0.25, dtype=torch.float32,
                          device=dev).bfloat16() for s in ((5, 65, 130), (62, 202, 130))]
    small += [torch.tensor(np.where(rng.random(s) < 0.3, -1e9, 0.0),
                           dtype=torch.float32, device=dev) for s in ((5, 65), (62, 202))]
    _check_k5(small, True, "at A=5, V=65, B=62, Q=202, D=130")
    _, errs, off = _check_k5((vis, txt, vb, tb), False, f"at V={V}")
    ms = time_ms(lambda: match_maxes_cuda(vis, txt, vb, tb))
    plain_ms = time_ms(lambda: match_maxes_plain(vis, txt, vb, tb), reps=5,
                       warmup=1)
    emit({"phase": "k5", "shape": {"A": A, "B": B, "Q": Q, "V": V, "D": D},
          "exact_at": {"A": 5, "V": 65, "B": 62, "Q": 202, "D": 130},
          "max_abs_err": errs, "index_mismatch_within_tol": off,
          "tolerance": [K5_ATOL, K5_RTOL], "ms": ms, "plain_ms": plain_ms})
    state["match_fwd"] = {"max_abs_err": max(errs.values()), "ms": ms,
                          "plain_ms": plain_ms}


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


def phase_k6(state):
    import numpy as np
    import torch

    from vlgae_tpu_torch.ops.match import match_maxes_bwd_cuda, match_maxes_bwd_plain

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
    ms = time_ms(lambda: match_maxes_bwd_cuda(*args))
    plain_ms = time_ms(lambda: match_maxes_bwd_plain(*args), reps=5, warmup=1)
    emit({"phase": "k6", "shape": shape, "exact_at": exact_shape,
          "exact_12bit_cotangents_at": round_shape, "rounded_pair": pair,
          "max_abs_err": err, "tolerance": [K6_ATOL, K6_RTOL],
          "bit_identical_reruns": identical, "ms": ms, "plain_ms": plain_ms})
    state["match_bwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
            state.setdefault(name, {})["launches_predict"] = n
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


def _small_overrides(root):
    return _corpus_overrides(root) + [
        "datamodule.pad_boxes=6", "datamodule.sample_boxes=0", "_hidden_size=32",
        "_match_hidden_size=16", "_rank=4", "vis_encoder.n_in=16",
        "vis_encoder.n_hidden=32", "trainer.precision=32",
        "encoder.dropout=0", "model.word_encoder.dropout=0",
        "model.dep_model_cfg.head_ff.dropout=0",
        "model.dep_model_cfg.mid_ff.dropout=0"]


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
        vis, txt = captured["bwd"][:2]
        emit({"phase": "train", "train_s": round(t_train, 3), "launches": launches,
              "test": test, "epochs": len([r for r in lines if "train/loss" in r]),
              "losses": losses, "eval_py_tail": ev.stdout.strip().splitlines()[-1],
              "k5_on_path": {"max_abs_err": k5_err, "index_mismatch_within_tol": k5_off,
                             "vis": list(captured["fwd"][0].shape),
                             "txt": list(captured["fwd"][1].shape)},
              "k6_on_path": {"max_abs_err": path_err, "vis": list(vis.shape),
                             "txt": list(txt.shape)},
              "train_step_ms_median_B64": step_s * 1e3,
              "train_step_ms_B64": [round(t * 1e3, 3) for t in times],
              "sentences_per_s_B64": 64 / step_s,
              "shape": {"len": "3-50", "B": 64, "P": 36, "feat": 2048,
                        "precision": "bf16"}})
        for name, n in launches.items():
            state.setdefault(name, {})["launches"] = n
        state["train_step_ms"] = step_s * 1e3


PHASES = {"env": phase_env, "build": phase_build, "k1": phase_k1,
          "k5": phase_k5, "k6": phase_k6, "reference": phase_reference,
          "train_reference": phase_train_reference, "slice": phase_slice,
          "train": phase_train}


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
    for phase in PHASES.values():
        phase(state)
    print(nvidia_smi_line())
    rows = []
    for name, info in KERNELS.items():
        row = {"name": name, **info, **state.get(name, {})}
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
