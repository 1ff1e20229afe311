"""The reduction of the program's spans and counters (``core/spans.py``) on
a synthetic profile of two steps, with hand counts: self time, idle gaps put
down to the innermost span on either of two host threads, runtime calls by
span, ``unattributed`` completing each sum, the counters' changes; empty
tables for a program without spans; and ``trace.timeline`` unchanged by the
``vlgae.*`` events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench.core import spans, trace

MAIN, AUTOGRAD = 1, 2


def _ev(name, start, end, thread=MAIN, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def _step(o):
    """One step at offset ``o`` (us): the base events (the bench's spans, the
    device's operations, runtime calls and an operator) and the program's."""
    base = [_ev("bench.batch_wait", o + 0, o + 30), _ev("bench.step", o + 30, o + 100),
            _ev("aten::mm", o + 35, o + 36),
            _ev("cudaMemcpyAsync", o + 31.5, o + 31.6),
            _ev("cudaLaunchKernel", o + 35, o + 35.1),
            _ev("cudaLaunchKernel", o + 45, o + 45.1),
            _ev("cuLaunchKernelEx", o + 70, o + 70.1, AUTOGRAD),
            _ev("cudaLaunchKernel", o + 95, o + 95.1),
            _ev("cudaMemsetAsync", o + 99.5, o + 99.6)]
    base += [_ev(f"k{i}", s, e, device=DeviceType.CUDA) for i, (s, e) in enumerate(
        [(o + 36.5, o + 38), (o + 46, o + 48), (o + 71, o + 75), (o + 90, o + 99.2),
         (o + 99.8, o + 104)])]
    prog = [_ev("vlgae.data.collate", o + 2, o + 25), _ev("vlgae.data.pack", o + 5, o + 20),
            _ev("vlgae.data.pad", o + 26, o + 28), _ev("vlgae.train_step", o + 31, o + 99),
            _ev("vlgae.forward", o + 32, o + 60), _ev("vlgae.forward.dmv", o + 40, o + 50),
            _ev("vlgae.backward", o + 61, o + 84), _ev("vlgae.optimizer", o + 85, o + 98),
            # a span of another host thread, inside the backward's time
            _ev("vlgae.data.pack", o + 80, o + 86, AUTOGRAD),
            # the device-side range of a span, flagged as an annotation
            _ev("vlgae.forward", o + 36.5, o + 48, device=DeviceType.CUDA, annotation=True)]
    return base, prog


def _profile():
    base, prog = [], []
    for o in (0, 100):
        b, p = _step(o)
        base, prog = base + b, prog + p
    base.append(_ev("cudaLaunchKernel", 10, 10.1))  # before the stretch
    return SimpleNamespace(events=lambda: base), SimpleNamespace(events=lambda: base + prog)


def _reduce(prof, before=None, after=None):
    return spans.reduce(trace.read_profile(prof), spans.read_events(prof),
                        before or {}, after or {})


def test_the_timeline_is_unchanged_by_the_programs_spans():
    base, full = _profile()
    assert trace.timeline(trace.read_profile(base)) == trace.timeline(trace.read_profile(full))


def test_self_time_idle_and_launches_by_span_with_hand_counts():
    _, full = _profile()
    before = {"data.pack_bytes": 100, "upload.bytes": 5}
    after = {"data.pack_bytes": 300, "upload.bytes": 5, "dmv.fused": 4}
    got = _reduce(full, before, after)
    ms = 1e-3  # one us in ms
    assert got["n_steps"] == 2
    # self time: the other thread's span does not count against the backward
    assert got["self_ms"] == pytest.approx({
        "vlgae.data.collate": 8 * ms, "vlgae.data.pack": 21 * ms, "vlgae.data.pad": 2 * ms,
        "vlgae.train_step": 4 * ms, "vlgae.forward": 18 * ms, "vlgae.forward.dmv": 10 * ms,
        "vlgae.backward": 23 * ms, "vlgae.optimizer": 13 * ms})
    # gaps: [30, 36.5] and [48, 71] the forward, [38, 46] its dmv stage, [75, 90]
    # the other thread's pack (shorter than the backward around it), [104, 136.5]
    # the next batch's collate, [99.2, 99.8] no span of the program
    assert got["idle_ms"] == pytest.approx({
        "vlgae.forward": 26.25 * ms, "vlgae.forward.dmv": 8 * ms, "vlgae.data.pack": 15 * ms,
        "vlgae.data.collate": 16.25 * ms, "unattributed": 0.6 * ms,
        "vlgae.data.pad": 0.0, "vlgae.train_step": 0.0, "vlgae.backward": 0.0,
        "vlgae.optimizer": 0.0})
    tl = trace.timeline(trace.read_profile(full))
    idle = (tl["window_s"] - tl["busy_s"]) * 1e3 / tl["n_steps"]
    assert sum(got["idle_ms"].values()) == pytest.approx(got["idle_ms_total"])
    assert got["idle_ms_total"] == pytest.approx(idle)
    # runtime calls: the autograd thread's launch goes to the backward
    assert got["launches"] == pytest.approx({
        "vlgae.train_step": 1, "vlgae.forward": 1, "vlgae.forward.dmv": 1,
        "vlgae.backward": 1, "vlgae.optimizer": 1, "unattributed": 1,
        "vlgae.data.collate": 0, "vlgae.data.pack": 0, "vlgae.data.pad": 0})
    assert sum(got["launches"].values()) == got["launches_total"] == 6
    assert got["counters"] == {"data.pack_bytes": 100, "dmv.fused": 2}
    assert got["pack_MB_per_s"] == pytest.approx(100 / 1e6 / (21e-6))


def test_a_program_without_spans_gives_empty_tables():
    base, _ = _profile()
    bare = _reduce(base)
    assert bare["self_ms"] == {} and bare["counters"] == {}
    assert bare["idle_ms"] == {"unattributed": pytest.approx(66.1e-3)}
    assert bare["launches"] == {"unattributed": 6}
