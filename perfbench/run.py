"""The benchmark of ``vlgae_tpu_torch`` on one NVIDIA card.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named ``--workload``: writes its corpus
from the seed, builds the port's pipeline with weights made from the seed,
warms up, measures for ``--seconds`` (``--trace 1``: a profiled stretch for
the per-layer metrics instead), compares the program's first steps with the
plain reference, and prints one JSON line. Exits non-zero without a CUDA
card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout; no JAX through
# a library's optional backend
CACHE = os.path.join(ROOT, ".perfbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from perfbench.core import harness

    sys.exit(harness.main(parse(), T0))
