"""The program's own spans (``record_function`` ranges named ``vlgae.*``,
CPU events of the same profile as the device's operations) and counters
(``vlgae_tpu_torch.utils.trace``) over a traced stretch, per step:

- each span's self time: its duration less the part its child spans on
  the same host thread cover, summed over the profile (which holds the
  stretch's steps and the batches they took, as ``bench.batch_wait`` does);
- the device's idle time by the innermost span the host was in: the idle
  gaps ``trace.timeline`` finds, each put down to the shortest ``vlgae.*``
  span on any host thread (autograd runs the backward on a thread of its
  own) that holds the gap's midpoint, or to ``unattributed``;
- the CUDA runtime's launch, copy and fill calls of the stretch by the
  innermost span that holds each call's start, or ``unattributed``;
- each counter's change over the stretch.

A program without these spans or counters gives empty tables, all of the idle
time and runtime calls under ``unattributed``."""

from __future__ import annotations

from collections import defaultdict

from . import trace

PREFIX = "vlgae."
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
UNATTRIBUTED = "unattributed"


def counters() -> dict:
    """The program's counters now; empty for a program without them."""
    try:
        from vlgae_tpu_torch.utils import trace as program_trace
    except ImportError:
        return {}
    return program_trace.counters()


def read_events(prof) -> dict:
    """``{"spans": [(name, start_us, end_us, thread)], "runtime": [(name,
    start_us, end_us, thread)]}``: the CPU events of a finished
    ``torch.profiler.profile`` that are program spans or runtime calls."""
    from torch.autograd import DeviceType

    spans, runtime = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        row = (e.name, e.time_range.start, e.time_range.end, e.thread)
        if e.name.startswith(PREFIX):
            spans.append(row)
        elif e.name.startswith(RUNTIME_CALLS):
            runtime.append(row)
    return {"spans": spans, "runtime": runtime}


def stretch(t: dict) -> tuple:
    """``(start_us, end_us)`` of the stretch, as :func:`trace.timeline` takes
    it: from the first ``bench.step`` to the last device operation's end."""
    steps = [s for s in t["spans"] if s[0] == "bench.step"]
    return (min(s[1] for s in steps),
            max([e for _, _, e in t["device"]] + [s[2] for s in steps]))


def idle_gaps(t: dict) -> list:
    """``[(start_us, end_us)]``: the stretch's gaps between device
    operations, as :func:`trace.timeline` takes them."""
    t0, t1 = stretch(t)
    busy = trace.merge([(max(s, t0), min(e, t1)) for _, s, e in t["device"]
                        if e > t0 and s < t1])
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def self_us(spans: list) -> dict:
    """Each span name's summed self time: a span's duration less the union of
    the other spans of its thread that lie inside it."""
    out = defaultdict(float)
    for name, s, e, th in spans:
        inner = [(cs, ce) for cn, cs, ce, cth in spans
                 if cth == th and s <= cs and ce <= e and (cs, ce) != (s, e)]
        out[name] += (e - s) - sum(b - a for a, b in trace.merge(inner))
    return out


def innermost(spans: list, at: float) -> str:
    inside = [sp for sp in spans if sp[1] <= at <= sp[2]]
    return min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else UNATTRIBUTED


def idle_under(reduced, roots) -> float | None:
    """Device idle ms a step put down to the spans ``roots`` and their stage
    spans (``<root>.*``), from :func:`reduce`'s ``idle_ms``; None where the
    stretch recorded none of them."""
    if not reduced:
        return None
    hit = [v for k, v in reduced["idle_ms"].items()
           if any(k == r or k.startswith(r + ".") for r in roots)]
    return sum(hit) if hit else None


def reduce(t: dict, ev: dict, before: dict, after: dict) -> dict:
    """Per step of the stretch: ``self_ms`` and ``idle_ms`` by span name,
    ``launches`` by span name (runtime calls), their totals, and
    ``counters`` (each counter's change). ``t`` is
    :func:`trace.read_profile`'s, ``ev`` :func:`read_events`'s of the same
    profile, ``before``/``after`` :func:`counters` around it."""
    n = sum(1 for s in t["spans"] if s[0] == "bench.step")
    spans = ev["spans"]
    names = {sp[0] for sp in spans}
    gaps = idle_gaps(t)
    t0, t1 = stretch(t)
    idle = defaultdict(float, dict.fromkeys(names, 0.0))
    for s, e in gaps:
        idle[innermost(spans, (s + e) / 2)] += e - s
    calls = defaultdict(float, dict.fromkeys(names, 0.0))
    for _, s, _, _ in ev["runtime"]:
        if t0 <= s <= t1:
            calls[innermost(spans, s)] += 1
    out = {
        "n_steps": n,
        "self_ms": {k: v / 1e3 / n for k, v in sorted(self_us(spans).items())},
        "idle_ms": {k: v / 1e3 / n for k, v in sorted(idle.items())},
        "idle_ms_total": sum(e - s for s, e in gaps) / 1e3 / n,
        "launches": {k: v / n for k, v in sorted(calls.items())},
        "launches_total": sum(calls.values()) / n,
        "counters": {k: (after[k] - before.get(k, 0)) / n for k in sorted(after)
                     if after[k] != before.get(k, 0)},
    }
    pack_ms = out["self_ms"].get(PREFIX + "data.pack")
    if pack_ms and "data.pack_bytes" in out["counters"]:
        out["pack_MB_per_s"] = out["counters"]["data.pack_bytes"] / 1e6 / (pack_ms / 1e3)
    return out
