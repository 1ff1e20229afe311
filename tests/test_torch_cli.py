"""The port's training CLI (``python -m vlgae_tpu_torch.train``) beyond one
run: the multirun sweep (``-m``), the hyperparameter-search bridge
(``VLGAE_SEARCH_PARAMS`` / ``VLGAE_SEARCH_RESULT``), wandb (inert without
the package; with a stand-in module, the metric lines and the watcher's
histograms), the ``torch.profiler`` trace (``profile=true``), and the
pipeline's default device: ``exp=lang_only`` at narrow widths on the CPU,
as tests/test_e2e.py drives the JAX CLI. Then the datamodule and embedding
choices that the JAX CLIs make, held to vlgae_tpu: a plain CoNLL corpus
through ``DepDataModule`` (``train`` and ``predict`` against the JAX
``train.py``, prediction files and vocabularies byte-identical), and a
local BERT directory (its ``config.json`` and WordPiece ``vocab.txt``;
subword ids exact, dev predictions byte-identical at ``precision=32``).
"""

import inspect
import json
import os
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import synth_data
from test_torch_lang_only import REPO, overrides


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


def _dep_overrides(corpus, workdir):
    v = f"{corpus}/vlparse"
    return overrides(corpus) + [
        "datamodule._target_=vlgae_tpu.data.DepDataModule",
        f"datamodule.train_path={v}/train.conll", f"datamodule.train_init_path={v}/init.conll",
        f"datamodule.dev_path={v}/val.conll", f"datamodule.test_path={v}/test.conll",
        "datamodule.ignore_stop_word=true", "datamodule.use_char=true",
        "embedding.word_embedding.normalize_time=nowhere",
        "embedding.tag_embedding.normalize_time=nowhere",
        "trainer.max_epochs=1", "optimizer.args.lr=0", f"workdir={workdir}"]


def test_dep_datamodule_train_and_predict_match_jax_train(corpus, tmp_path, monkeypatch):
    """``datamodule._target_`` without VLParse: both CLIs read the plain
    CoNLL files (no image, every dev caption), with the stop-word option
    (NLTK absent: the empty list) and the char field. The port starts from
    the JAX run's weights; at lr 0 both keep them through one epoch, so the
    dev and test files of ``train`` and the dev file of ``predict`` equal
    the JAX ``train.py``'s."""
    from vlgae_tpu_torch import predict, train

    monkeypatch.syspath_prepend(str(REPO))
    import train as jax_train

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "nltk.corpus", None)
    jpipe, jtest = jax_train.main(_dep_overrides(corpus, "jrun"))
    assert type(jpipe.dm).__name__ == "DepDataModule"
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jax.device_get(jpipe.state.params))
    np.savez(tmp_path / "jax.npz", **{"/".join(k): np.asarray(v) for k, v in flat.items()})
    pipe, test = train.main(_dep_overrides(corpus, "run") + [
        f"weights={tmp_path / 'jax.npz'}", "device=cpu"])
    assert type(pipe.dm).__name__ == "DepDataModule" and pipe.dm.stop_words_source == "empty"
    assert not any(k.startswith("vis") for k in next(pipe.dm.batches("dev"))[0])
    jrun, run = tmp_path / "jrun", tmp_path / "run"
    names = sorted(p.name for p in jrun.glob("vocab_*.txt"))
    assert names == ["vocab_char.txt", "vocab_tag.txt", "vocab_token.txt", "vocab_word.txt"]
    for name in names + ["dev.predict.txt", "test.predict.txt"]:
        assert (run / name).read_bytes() == (jrun / name).read_bytes(), name
    assert test["uas"] == pytest.approx(jtest["uas"])
    predict.main([f"checkpoint={run / 'checkpoint' / 'last.pt'}", "device=cpu", "name=port"])
    assert (tmp_path / "port_dev.conll").read_bytes() == (jrun / "dev.predict.txt").read_bytes()


def write_bert_dir(path, words, hidden=64, layers=2):
    """A BERT directory without weights: ``config.json`` (``hidden`` x
    ``layers``) and a WordPiece ``vocab.txt`` built from ``words``: the
    special tokens, every other word whole, the rest as a first piece and
    ``##`` pieces, and every fifth word left out (``[UNK]``)."""
    path.mkdir(parents=True, exist_ok=True)
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    for i, w in enumerate(sorted(set(words))):
        if i % 5 == 4:
            continue
        pieces += [w] if i % 2 == 0 or len(w) < 2 else [w[:2]] + [f"##{c}" for c in w[2:]]
    (path / "vocab.txt").write_text("\n".join(dict.fromkeys(pieces)) + "\n")
    (path / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 120, "hidden_size": hidden,
        "num_hidden_layers": layers, "num_attention_heads": 4,
        "intermediate_size": 2 * hidden, "max_position_embeddings": 64}))
    return path


def test_bert_directory_predictions_match_jax(corpus, tmp_path, monkeypatch):
    """``embedding.transformer.args.model`` naming a local directory: the
    port builds the BERT of its ``config.json`` (2 x 64) and tokenizes with
    its ``vocab.txt``, as vlgae_tpu's ``train.py`` does with
    ``AutoConfig`` and ``HFTokenizer``."""
    from flax import traverse_util

    from test_torch_slice import overrides as vlgae_overrides
    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HFTokenizer, attach_subwords
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve
    from vlgae_tpu_torch import predict

    words = [line.split("\t")[1] for split in ("train", "val", "test")
             for line in (corpus / "vlparse" / f"{split}.conll").read_text().splitlines()
             if line]
    bert = write_bert_dir(tmp_path / "bert", words)
    ovs = vlgae_overrides(corpus) + [f"embedding.transformer.args.model={bert}"]
    cfg = resolve(ConfigComposer(str(REPO / "configs")).compose("config_train", ovs))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    jdm = attach_subwords(VLParseDataModule(**dm_cfg).setup(), HFTokenizer(str(bert)))
    jpipe = Pipeline(build_model(cfg, jdm), jdm, cfg, workdir=str(tmp_path),
                     devices=jax.devices()[:1])
    jpipe.init_state(next(jdm.batches("test", shuffle=False)), seed=0)
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(jpipe.state.params)).items()}
    assert flat["params/dependency/embedding/transformer/bert/encoder/layer/1/output/"
                "dense/kernel"].shape == (128, 64)
    np.savez(tmp_path / "jax.npz", **flat)
    jres, jout = jpipe.evaluate("dev")
    jpipe.write_predictions(str(tmp_path / "jax_dev.conll"), "dev", jout)
    monkeypatch.chdir(tmp_path)
    pipe, results = predict.main(ovs + [f"weights={tmp_path / 'jax.npz'}", "device=cpu",
                                        "name=port"])
    for split, ds in jdm.datasets.items():
        for inst, jinst in zip(pipe.dm.datasets[split], ds, strict=True):
            for k in ("subword_ids", "subword_first", "subword_last"):
                assert inst[k] == jinst[k], (split, k)
    ids = {i for ds in jdm.datasets.values() for inst in ds for i in inst["subword_ids"]}
    # [UNK] (1) for the words left out; [CLS] (2) and [SEP] (3) around each caption
    assert {1, 2, 3} <= ids and len(ids) > 10
    assert pipe.dm.datasets["dev"][0]["subword_ids"][::len(pipe.dm.datasets["dev"][0][
        "subword_ids"]) - 1] == [2, 3]
    assert (tmp_path / "port_dev.conll").read_bytes() == (tmp_path / "jax_dev.conll").read_bytes()
    np.testing.assert_allclose(results["dev"]["loss"], jres["loss"], rtol=1e-4, atol=1e-4)


def test_progress_bar_is_the_iterator_off_a_terminal(monkeypatch):
    """``trainer.progress_bar``: as in vlgae_tpu, the plain iterator when
    disabled or when stderr is not a terminal, else an ASCII tqdm bar."""
    import io
    import sys

    from vlgae_tpu.training.pipeline import _progress_bar as jbar
    from vlgae_tpu_torch.training.pipeline import _progress_bar

    it = iter(range(3))
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    assert _progress_bar(it, 3, "epoch 0") is it is jbar(it, 3, "epoch 0")

    class Tty(io.StringIO):
        def isatty(self):
            return True

    monkeypatch.setattr(sys, "stderr", Tty())
    assert _progress_bar(it, 3, "epoch 0", enable=False) is it
    import tqdm

    bar = _progress_bar(range(3), 3, "epoch 0")
    assert isinstance(bar, tqdm.tqdm) and bar.ascii and list(bar) == [0, 1, 2]
