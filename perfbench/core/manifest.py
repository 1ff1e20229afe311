"""``BENCHMARK.json`` and the files it names: each configuration's file
(which names its family, ``perfbench/families/<family>.py``), each traffic
mix's file under ``perfbench/traffic/<mix>.json`` and each cell's limits
under ``perfbench/limits/<cell>.json``."""

from __future__ import annotations

import json
import os

from .. import families

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")


def load(path=os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports (end-to-end with ``--trace 0``, per-layer with 1)."""
    w = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    config = _json(os.path.join(ROOT, conf["file"]))
    families.load(config)
    return {"workload": w,
            "config": config,
            "traffic": _json(os.path.join(BENCH, "traffic", w["traffic"] + ".json")),
            "limits": _json(os.path.join(BENCH, "limits", name + ".json")),
            "end_to_end": [m for m in manifest["end_to_end"] if reports(m)],
            "per_layer": [m for m in manifest["per_layer"] if reports(m)]}
