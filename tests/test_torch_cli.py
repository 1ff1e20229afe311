"""The port's training CLI (``python -m vlgae_tpu_torch.train``) beyond one
run: the multirun sweep (``-m``), the hyperparameter-search bridge
(``VLGAE_SEARCH_PARAMS`` / ``VLGAE_SEARCH_RESULT``), wandb (inert without
the package; with a stand-in module, the metric lines and the watcher's
histograms), the ``torch.profiler`` trace (``profile=true``), and the
pipeline's default device. ``exp=lang_only`` at narrow widths on the CPU,
as tests/test_e2e.py drives the JAX CLI; no JAX here.
"""

import inspect
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import synth_data
from test_torch_lang_only import overrides


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9))
    return root


def _args(corpus, *extra):
    return overrides(corpus) + ["trainer.max_epochs=1", "device=cpu", "init_seed=0",
                                *extra]


def test_multirun_sweeps_comma_lists(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MULTIRUN_ID", raising=False)
    results = train.main(["-m"] + _args(corpus, "optimizer.args.lr=0.001,0.002"))
    assert [r["job"] for r in results] == [0, 1]
    assert results[0]["group"] == results[1]["group"]
    assert [r["overrides"] for r in results] == [["optimizer.args.lr=0.001"],
                                                 ["optimizer.args.lr=0.002"]]
    (sweep,) = (tmp_path / "outputs" / "multirun").iterdir()
    lines = [json.loads(line) for line in (sweep / "results.jsonl").read_text().splitlines()]
    assert len(lines) == 2 and all(np.isfinite(line["test"]["loss"]) for line in lines)
    for job, lr in (("0", 0.001), ("1", 0.002)):
        meta = json.loads((sweep / job / "multirun.json").read_text())
        assert meta["group"] == results[0]["group"] and meta["job"] == int(job)
        assert json.loads((sweep / job / "config.json").read_text())[
            "optimizer"]["args"]["lr"] == lr
        assert (sweep / job / "test.predict.txt").exists()
    assert "MULTIRUN_ID" not in os.environ


@pytest.mark.parametrize("value", ["range(1,3)", "glob(*)", "interval(0,1)"])
def test_multirun_rejects_hydra_sweep_functions(value):
    from vlgae_tpu_torch.train import _sweep_axes

    with pytest.raises(ValueError, match="sweep function"):
        _sweep_axes([f"optimizer.args.lr={value}"])
    fixed, axes = _sweep_axes(["a=1,2", "b=[0@0, 0.5@100]", "c='x,y'", "d=3"])
    assert axes == [("a", ["1", "2"])]
    assert fixed == ["b=[0@0, 0.5@100]", "c='x,y'", "d=3"]


def test_search_bridge_params_in_result_out(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    monkeypatch.chdir(tmp_path)
    result = tmp_path / "trial.json"
    monkeypatch.setenv("VLGAE_SEARCH_PARAMS", json.dumps({"optimizer.args.lr": 0.002}))
    monkeypatch.setenv("VLGAE_SEARCH_RESULT", str(result))
    pipe, test = train.main(_args(corpus, "workdir=run"))
    assert pipe.cfg["optimizer"]["args"]["lr"] == 0.002
    out = json.loads(result.read_text())
    assert out["best"] == pipe.best and out["test"]["uas"] == pytest.approx(test["uas"])


def test_wandb_absent_logs_jsonl_only(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    pipe, _ = train.main(_args(corpus, "workdir=run", "+wandb=true",
                               "+watch_model.log=all", "+watch_model.log_freq=1"))
    assert pipe.watcher is not None and not pipe.watcher.active
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert any("test/uas" in json.loads(line) for line in lines)


def test_wandb_present_gets_metrics_and_histograms(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    logged = []
    fake = types.SimpleNamespace(run=None, Histogram=lambda a: ("hist", len(a)))

    def init(project=None, name=None, config=None):
        fake.run = types.SimpleNamespace(project=project, name=name, config=config)
        return types.SimpleNamespace(log=lambda m, step=None: logged.append(("run", m)))

    fake.init = init
    fake.log = lambda payload, step=None: logged.append(("watch", payload))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.chdir(tmp_path)
    pipe, _ = train.main(_args(corpus, "workdir=run", "+wandb=true",
                               "+watch_model.log=all", "+watch_model.log_freq=1"))
    assert fake.run.config["optimizer"]["args"]["lr"] == pipe.cfg["optimizer"]["args"]["lr"]
    assert any(kind == "run" and "test/uas" in m for kind, m in logged)
    hist = [m for kind, m in logged if kind == "watch"]
    assert len(hist) == pipe.step
    assert any(k.startswith("gradients/") for k in hist[0])
    assert any(k.startswith("parameters/") for k in hist[0])


def test_profile_writes_a_trace(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    monkeypatch.chdir(tmp_path)
    pipe, _ = train.main(_args(corpus, "workdir=run", "+profile=true",
                               "trainer.max_epochs=2"))
    assert pipe.step >= 5 and pipe.profiler is None
    traces = list((tmp_path / "run" / "profile").glob("trace_step*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_pipeline_defaults_to_the_card():
    """``Pipeline()`` without a device runs on the card, and raises when
    there is none; CPU callers name ``device='cpu'``."""
    from vlgae_tpu_torch.training.pipeline import Pipeline

    assert inspect.signature(Pipeline).parameters["device"].default == "cuda"
    model = torch.nn.Linear(2, 2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(model, None, {})
