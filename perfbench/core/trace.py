"""The device timeline of a traced stretch: busy and idle time, launches,
the operations that took most time, and the idle gaps by the host span they
fell in. The harness marks its own spans with ``record_function`` names that
start with ``bench.``."""

from __future__ import annotations

from collections import defaultdict


def read_profile(prof) -> dict:
    """``{"device": [(name, start_us, end_us)], "spans": [(name, start_us,
    end_us)]}`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.events():
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not name.startswith("bench."):
                device.append((name, start, end))
        elif name.startswith("bench."):
            spans.append((name, start, end))
    return {"device": device, "spans": spans}


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    base = name.split("(")[0].split("<")[0].replace("void ", "").strip()
    return (base or name)[:96]


def timeline(t: dict) -> dict:
    """The stretch from the first ``bench.step`` span's start to the end of
    the last device operation."""
    steps = [s for s in t["spans"] if s[0] == "bench.step"]
    t0 = min(s[1] for s in steps)
    t1 = max([e for _, _, e in t["device"]] + [s[2] for s in steps])
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in t["device"] if e > t0 and s < t1]
    busy = merge([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for n, s, e in dev:
        by_name[short(n)] += (e - s) / 1e6
    gaps = defaultdict(float)
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            mid = (prev + s) / 2
            inside = [sp for sp in t["spans"] if sp[1] <= mid <= sp[2]]
            label = (min(inside, key=lambda sp: sp[2] - sp[1])[0][len("bench."):]
                     if inside else "loop")
            gaps[label] += (s - prev) / 1e6
        prev = max(prev, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy_us / 1e6,
            "n_steps": len(steps), "n_device_ops": len(dev),
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
            "kernel_s": dict(by_name),
            "span_s": {n: sum(e - s for m, s, e in t["spans"] if m == n) / 1e6
                       for n in {sp[0] for sp in t["spans"]}}}
