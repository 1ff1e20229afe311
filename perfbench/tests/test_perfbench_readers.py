"""The per-layer readers of the port's spans (``ctx["program"]``, the
reduction of ``core/spans.py``) on a hand-made reduction: each span's idle
ms with its stage spans, nothing where the stretch recorded none of them,
and the three together within the step's idle time."""

import pytest

from perfbench import metrics

IDLE = {"vlgae.forward": 5.0, "vlgae.forward.dmv": 2.0, "vlgae.forward.text": 1.0,
        "vlgae.loss": 3.0, "vlgae.loss.grounding": 4.0, "vlgae.backward": 30.0,
        "vlgae.optimizer": 2.5, "vlgae.upload": 0.5, "vlgae.train_step": 1.0,
        "vlgae.data.pad": 6.0, "vlgae.forwarded": 100.0, "unattributed": 0.25}
REDUCED = {"n_steps": 12, "idle_ms": IDLE, "idle_ms_total": sum(IDLE.values())}
READ = {"forward_idle_ms.train": 15.0, "backward_idle_ms.train": 30.0,
        "optimizer_idle_ms.train": 2.5}


@pytest.mark.parametrize("name", sorted(READ))
def test_idle_by_span_from_the_reduction(name):
    assert metrics.read(name, {"loop": "train", "program": REDUCED}) == READ[name]
    assert metrics.read(name, {"loop": "parse", "program": REDUCED}) is None
    assert metrics.read(name, {"loop": "train"}) is None
    bare = {"n_steps": 12, "idle_ms": {"unattributed": 40.0}, "idle_ms_total": 40.0}
    assert metrics.read(name, {"loop": "train", "program": bare}) is None
    zero = dict(REDUCED, idle_ms=dict.fromkeys(IDLE, 0.0))
    assert metrics.read(name, {"loop": "train", "program": zero}) == 0.0


def test_the_three_lie_within_the_steps_idle_time():
    ctx = {"loop": "train", "program": REDUCED}
    assert sum(metrics.read(n, ctx) for n in READ) <= REDUCED["idle_ms_total"]
