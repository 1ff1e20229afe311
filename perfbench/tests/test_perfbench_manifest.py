"""The manifest keeps to the benchmark's contract: names, units and
lengths; and every cell's configuration, traffic mix, limits and metric
readers are found by name."""

import importlib
import json
import os
import re

import pytest

from perfbench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.load()


def test_top_level_keys_and_lengths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in MAN["paths"])


def test_names_units_and_text():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in MAN["workloads"]] + [c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(w):
    c = manifest.cell(MAN, w["name"])
    assert c["traffic"]["loop"] == "train"
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())
    reported = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in reported
        family = m["name"].split(".", 1)[0]
        assert hasattr(importlib.import_module(f"perfbench.metrics.{family}"), "read")
    conf = next(x for x in MAN["configs"] if x["name"] == w["config"])
    with open(os.path.join(manifest.ROOT, conf["file"])) as f:
        assert json.load(f)["reduced"] == conf["reduced"]
