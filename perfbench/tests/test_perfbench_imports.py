"""A run loads nothing of JAX or of the JAX package, compared by whole
top-level names, and the reference loads nothing of the port."""

import subprocess
import sys

from perfbench.core import guard, manifest

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted(sys.modules)))
"""


def modules_after(body: str) -> list:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=manifest.ROOT, body=body)],
                         capture_output=True, text=True, check=True)
    return __import__("json").loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(["vlgae_tpu_torch.models", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["vlgae_tpu.models", "jax.numpy", "optax"]) == [
        "jax", "optax", "vlgae_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports: the harness, the metric readers, the
    family, the reference and the port's modules the pipeline builds
    from."""
    mods = modules_after(
        "import runpy; from perfbench.core import harness, program, record, trace\n"
        "from perfbench import metrics\n"
        "import perfbench.metrics.mfu, perfbench.metrics.match_roofline\n"
        "import perfbench.metrics.forward_idle_ms, perfbench.metrics.backward_idle_ms\n"
        "import perfbench.metrics.optimizer_idle_ms, perfbench.families.vlgae\n"
        "from perfbench.reference import model, train\n"
        "from vlgae_tpu_torch.predict import build_datamodule, compose\n"
        "from vlgae_tpu_torch.training.factory import build_model\n"
        "from vlgae_tpu_torch.training.pipeline import Pipeline\n"
        "from vlgae_tpu_torch.ops import dmv_cuda, match\n"
        "runpy.run_path(%r, run_name='not_main')" % (manifest.ROOT + "/perfbench/run.py"))
    assert "vlgae_tpu_torch" in mods
    assert guard.forbidden_loaded(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    mods = modules_after("from perfbench.reference import model, train, dmv")
    tops = {m.split(".", 1)[0] for m in mods}
    assert "vlgae_tpu_torch" not in tops and not guard.forbidden_loaded(mods)
