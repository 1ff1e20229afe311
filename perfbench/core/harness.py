"""One run of one cell: set-up, the measured window (or, with ``--trace
1``, a traced stretch inside it), then the comparison with the reference,
and the result line."""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
import tempfile
import time

from .. import families
from . import compare, guard, manifest, program, record, spans, trace

TRACE_LEAD_S = 2.0
TRACE_STEPS = 12


def device_info(torch, trace_tl=None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
         "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    if trace_tl is not None:
        d["busy_s"] = trace_tl["busy_s"]
        d["window_s"] = trace_tl["window_s"]
    return d


@contextlib.contextmanager
def upload_span(span):
    """``bench.upload`` around the pipeline's upload of a batch."""
    from vlgae_tpu_torch.training import pipeline

    orig = pipeline.shard_batch

    def wrapped(batch, dp):
        with span("bench.upload"):
            return orig(batch, dp)

    pipeline.shard_batch = wrapped
    try:
        yield
    finally:
        pipeline.shard_batch = orig


def host_stats(step_ms, wait_s):
    """Where a window's time went, to standard error: the steps' device ms
    (median, 90th percentile, the time of steps over twice the median), the
    host's mean wait for a batch, this process's CPU seconds."""
    import statistics

    q = statistics.quantiles(step_ms, n=10)
    med = statistics.median(step_ms)
    t = os.times()
    print(json.dumps({"step_ms_median": med, "step_ms_p90": q[8],
                      "slow_step_ms": sum(d - med for d in step_ms if d > 2 * med),
                      "batch_wait_ms_mean": wait_s * 1e3 / len(step_ms),
                      "cpu_s": t.user + t.system}), file=sys.stderr)


def train_window(torch, pipe, it, alpha, seconds):
    """Train steps until the host clock passes ``seconds``; the rate is the
    captions of every step over the device time from the window's start to
    the last step's end (CUDA events, read after the window)."""
    start = torch.cuda.Event(enable_timing=True)
    bad = torch.zeros((), dtype=torch.int32, device="cuda")
    start.record()
    t_end = time.perf_counter() + seconds
    ends = []
    wait = 0.0
    while time.perf_counter() < t_end:
        t_wait = time.perf_counter()
        x, y, real = program.next_batch(it, program.nospan)
        wait += time.perf_counter() - t_wait
        loss, _ = pipe.train_step(x, y, False, alpha)
        bad += (~torch.isfinite(loss)).int()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append((ev, real))
    torch.cuda.synchronize()
    window_s = start.elapsed_time(ends[-1][0]) / 1e3
    n = sum(r for _, r in ends)
    steps = [a.elapsed_time(b) for a, b in zip([start] + [e for e, _ in ends[:-1]],
                                               [e for e, _ in ends])]
    host_stats(steps, wait)
    return {"train_sent_per_s": n / window_s}, len(ends), int(bad)


def traced(torch, family, run_step, it, span_steps=TRACE_STEPS):
    """Profile ``span_steps`` steps: the device timeline, the bounds of the
    family's kernels, each step's real sizes, and the reduction of the
    program's spans and counters (``spans.reduce``), taken after the
    profile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sizes = []
    before = spans.counters()
    with record.launches(family.KERNELS) as rec, upload_span(record_function), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(span_steps):
            x, y, real = program.next_batch(it, record_function)
            sizes.append(family.step_sizes(x, real))
            with record_function("bench.step"):
                run_step(x, y, real)
        torch.cuda.synchronize()
    after = spans.counters()
    t = trace.read_profile(prof)
    reduced = spans.reduce(t, spans.read_events(prof), before, after)
    return trace.timeline(t), record.bounds(family.KERNELS, rec), sizes, reduced


def per_layer(cell, ctx) -> dict:
    from .. import metrics

    out = {}
    for m in cell["per_layer"]:
        v = metrics.read(m["name"], ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_train(torch, cell, pipe, args, t0, fault=None):
    c, traffic = cell["config"], cell["traffic"]
    family = families.load(c)
    n_tag = len(program.tag_names(pipe))
    alpha = float(traffic["alpha"])
    it = program.epochs(pipe, traffic["split"])
    if fault is not None:
        fault(pipe)
    first = program.train_first_steps(pipe, it, alpha, program.nospan)
    for _ in range(max(0, program.epoch_len(pipe, traffic["split"]) - 3)):
        x, y, _ = program.next_batch(it, program.nospan)
        pipe.train_step(x, y, False, alpha)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = {"setup_s": setup_s}
    if args.trace:
        t_lead = time.perf_counter() + TRACE_LEAD_S
        while time.perf_counter() < t_lead:
            x, y, _ = program.next_batch(it, program.nospan)
            pipe.train_step(x, y, False, alpha)
        tl, bounds, sizes, reduced = traced(
            torch, family, lambda x, y, real: pipe.train_step(x, y, False, alpha), it)
        w = family.widths(c, n_tag)
        ctx = {"loop": "train", "timeline": tl, "bounds": bounds, "widths": w,
               "step_ops": family.step_ops(w, sizes, bounds, True), "program": reduced}
        metrics, attempted, failed = per_layer(cell, ctx), tl["n_steps"], 0
        extra = {"trace": tl, "program": reduced,
                 "bounds_s": {k: v for k, v in bounds.items() if k.endswith("_s")}}
    else:
        e2e, attempted, failed = train_window(torch, pipe, it, alpha, args.seconds)
        metrics = {m["name"]: {"value": (e2e | res)[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
        extra = {}
    device = device_info(torch, extra.get("trace"))
    return first, metrics, attempted, failed, device, extra


def reference_train(torch, cell, seed, first, workdir, tf32=False, device="cuda"):
    """The reference's first steps on its own inputs, read by the family
    from the files in ``workdir`` for the rows of the program's batches (the
    program is freed by now); its readings, with ``input_diff``: the
    entries in which the program's batches differ from those inputs."""
    from .weights import make_weights

    c = cell["config"]
    family = families.load(c)
    reader = family.reference_inputs(c, workdir, cell["traffic"]["split"])
    built = [reader.batch(b, real) for b, real in zip(first["batches"], first["real"])]
    W = make_weights(family.param_shapes(c, len(reader.tag_names)).items(), seed,
                     torch.device(device), family.weight_rule)
    batches = [{k: torch.as_tensor(v).to(device) for k, v in x.items()} for x, _ in built]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ref = family.first_steps(W, c, batches, reader.tag_names, seed,
                                 float(cell["traffic"]["alpha"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ref["input_diff"] = sum(d for _, d in built)
    return ref


def program_extra(family, pipe, first) -> dict:
    """The program's side of the family's ``extra`` readings, from the
    pipeline after the window and the first batch as the program fed it;
    empty for a family without them."""
    hook = getattr(family, "program_extra", None)
    return {} if hook is None else hook(pipe, first["batches"][0])


def finite_or_inf(readings: dict) -> dict:
    return {k: (v if not isinstance(v, float) or math.isfinite(v) else math.inf)
            for k, v in readings.items()}


def main(args, t0, fault=None) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA device; this benchmark runs on the card only",
              file=sys.stderr)
        return 3
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    if torch.cuda.device_count() < int(cell["workload"]["chips"]):
        print(f"perfbench: {args.workload} needs {cell['workload']['chips']} cards",
              file=sys.stderr)
        return 3
    if cell["traffic"]["loop"] != "train":
        raise ValueError(f"no loop {cell['traffic']['loop']!r} in this harness")
    c = cell["config"]
    family = families.load(c)

    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        family.write_inputs(c, cell["traffic"], args.seed, tmp)
        pipe = program.build(c, args.seed, tmp)
        names = program.tag_names(pipe)
        if list(pipe.dm.token2tag or []) != list(range(len(names))) or pipe.dm.token2word:
            raise RuntimeError("the recipe's tokens are expected to be its tags")
        first, metrics, attempted, failed, device, extra = run_train(
            torch, cell, pipe, args, t0, fault)
        first["extra"] = program_extra(family, pipe, first)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        ref = reference_train(torch, cell, args.seed, first, tmp)
        readings = compare.train_readings(first, ref)
        detail = {"loss": {"program": first["loss"], "reference": ref["loss"]},
                  "viterbi_tied_sentences": ref.get("tied")}
    readings = finite_or_inf(readings)
    correct, checks = compare.judge(readings, cell["limits"])
    correct = correct and failed == 0
    found = guard.forbidden_loaded()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if "trace" in extra:
        tl = extra["trace"]
        result["breakdown"] = {"device_ops": tl["device_ops"], "idle_gaps": tl["idle_gaps"]}
    result["checks"] = checks
    detail["worst"] = readings.get("_worst")
    detail["readings"] = {k: v for k, v in readings.items() if not k.startswith("_")}
    if "trace" in extra:
        detail["kernels"] = {n: v for n, v in extra["trace"]["kernel_s"].items()
                             if "dmv" in n or "match" in n}
        detail["bounds"] = extra.get("bounds_s")
        detail["program"] = extra["program"]
    print(json.dumps(detail), file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def control_readings(cell_name: str, seed: int) -> dict:
    """The control of a training cell at its own size: the reference with
    TF32 on (the nearest precision below the configuration's f32 with TF32
    off) in the program's place, against the reference as configured, on
    the rows of the cell's first three batches. Runs on the card."""
    import torch

    cell = manifest.cell(manifest.load(), cell_name)
    c = cell["config"]

    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        families.load(c).write_inputs(c, cell["traffic"], seed, tmp)
        pipe = program.build(c, seed, tmp)
        it = program.epochs(pipe, cell["traffic"]["split"])
        first = {"batches": [], "real": []}
        for _ in range(3):
            x, _, real = program.next_batch(it, program.nospan)
            first["batches"].append(program.host_copy(x))
            first["real"].append(real)
        del pipe, it
        gc.collect()
        torch.cuda.empty_cache()
        low = reference_train(torch, cell, seed, first, tmp, tf32=True)
        ref = reference_train(torch, cell, seed, first, tmp)
        return compare.train_readings(low, ref)
