"""The port's ``exp=lang_only`` slice against vlgae_tpu on one corpus.

A tiny synthetic corpus (tests/synth_data.py) and the text-only recipe
(BiLSTM encoder, word + tag embeddings, ``context_mode: hx``, lexicalised
tokens) at the narrow widths of ``tests/test_e2e.py::test_lang_only_exp``;
the JAX model's params are carried into the port through
``vlgae_tpu_torch.convert``. Held to: heads equal and the eval-step loss
within 1e-4; the prediction files byte-identical at ``precision=32``; one
warm-up step and one NLL step (every dropout 0): losses 1e-5 relative,
gradients 1e-5 + 1e-4 relative, updated parameters 2e-6 absolute where the
gradient is above round-off (Adam's first steps are about lr times the sign
of the gradient) and |step| <= lr everywhere.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import synth_data
from vlgae_tpu_torch import convert

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
NO_DROPOUT = ["_dropout=0", "encoder.lstm_dropout=0", "encoder.pre_dropout=0",
              "encoder.pre_shared_dropout=0", "encoder.post_dropout=0",
              "encoder.post_shared_dropout=0"]


def overrides(root, layers=1, dropout=True):
    return [
        "exp=lang_only", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.pad_boxes=8", "datamodule.num_lex=6",
        "datamodule.train_dataloader.batch_size=8",
        "datamodule.train_dataloader.num_bucket=1",
        "datamodule.dev_dataloader.num_bucket=1",
        "datamodule.dev_dataloader.batch_size=8",
        "datamodule.test_dataloader.num_bucket=1",
        "datamodule.test_dataloader.batch_size=8",
        "model.init_epoch=1", "_hidden_size=32", "_rank=4",
        "encoder.hidden_size=16", f"encoder.num_layers={layers}",
        "model.root_emb_dim=8", "model.dec_emb_dim=8", "trainer.precision=32",
    ] + ([] if dropout else NO_DROPOUT)


def _jax_pipeline(root, ovs):
    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve

    cfg = resolve(ConfigComposer(str(REPO / "configs")).compose("config_train", ovs))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    dm = VLParseDataModule(**dm_cfg).setup()
    pipe = Pipeline(build_model(cfg, dm), dm, cfg, workdir=str(root),
                    devices=jax.devices()[:1])
    pipe.init_state(next(dm.batches("train", shuffle=False)), seed=0)
    flat = traverse_util.flatten_dict(jax.device_get(pipe.state.params))
    return pipe, {"/".join(k): np.asarray(v) for k, v in flat.items()}


def _port_pipeline(root, ovs, flat):
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline

    cfg = compose(ovs)
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    model.load_state_dict(convert.flax_to_torch(flat, model), strict=True)
    pipe = Pipeline(model, dm, cfg, device="cpu", workdir=str(root))
    pipe.setup_optimizer()
    return pipe


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("lang_only")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=8, n_box=8,
                           len_range=(3, 9))
    return root


@pytest.fixture(scope="module")
def pair(corpus):
    """(JAX pipeline, port pipeline, flat params): two LSTM layers."""
    jpipe, flat = _jax_pipeline(corpus, overrides(corpus, layers=2))
    np.savez(os.path.join(corpus, "weights.npz"), **flat)
    return jpipe, _port_pipeline(corpus, overrides(corpus, layers=2), flat), flat


def _pad(x):
    from vlgae_tpu.parallel import pad_batch_to_devices

    return pad_batch_to_devices(x, 1, pow2=True)[0]


def test_model_is_the_bare_parser_without_region_features(pair):
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV
    from vlgae_tpu_torch.models.text_encoder import RNNEncoder

    jpipe, tpipe, flat = pair
    assert isinstance(tpipe.model, DiscriminativeNDMV) and not tpipe.is_joint
    assert isinstance(tpipe.model.encoder, RNNEncoder)
    assert tpipe.model.cfg.context_mode == "hx"
    assert [i.name for i in tpipe.model.embedding.items] == ["word_embedding",
                                                             "tag_embedding"]
    assert "params/encoder/fwd_1/cell/OptimizedLSTMCell_0/hf/bias" in flat
    # lexicalised tokens: word:tag pairs plus <unk>:tag backoffs
    assert tpipe.dm.token_mode == "joint"
    assert tpipe.dm.vocabs["token"].idx2word == jpipe.dm.vocabs["token"].idx2word
    assert tpipe.dm.vocabs["word"].idx2word == jpipe.dm.vocabs["word"].idx2word
    assert list(tpipe.dm.token2word) == list(jpipe.dm.token2word)
    assert list(tpipe.dm.token2tag) == list(jpipe.dm.token2tag)
    x, y = next(tpipe.dm.batches("dev", shuffle=False))
    assert not any(k.startswith("vis") for k in (*x, *y))
    jx, _ = next(jpipe.dm.batches("dev", shuffle=False))
    for k in x:
        np.testing.assert_array_equal(x[k], jx[k], err_msg=k)


def test_eval_step_matches_jax(pair):
    jpipe, tpipe, _ = pair
    alpha = jnp.asarray(0.5, jnp.float32)
    n = 0
    for (x, y), (tx, _) in zip(jpipe.dm.batches("dev", shuffle=False),
                               tpipe.dm.batches("dev", shuffle=False)):
        xp, yp = _pad(x), _pad(y)
        fn = jpipe._get_eval_step(tuple((k, v.shape) for k, v in sorted(xp.items())))
        want = jax.device_get(fn(jpipe.state.params,
                                 {k: jnp.asarray(v) for k, v in xp.items()},
                                 {k: jnp.asarray(v) for k, v in yp.items()}, alpha))
        from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

        got = tpipe.eval_step(pad_batch_pow2(tx)[0])
        assert sorted(got) == ["arc", "loss"]
        np.testing.assert_array_equal(got["arc"], np.asarray(want["arc"]))
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
        n += 1
    assert n >= 1


def test_prediction_files_identical(pair, corpus, tmp_path, monkeypatch):
    jpipe, _, _ = pair
    from vlgae_tpu_torch.predict import main

    jres, jout = jpipe.evaluate("dev")
    jpipe.write_predictions(str(tmp_path / "jax_dev.conll"), "dev", jout)
    monkeypatch.chdir(tmp_path)
    _, results = main(overrides(corpus, layers=2) + [
        f"weights={corpus}/weights.npz", "device=cpu", "name=port"])
    want = (tmp_path / "jax_dev.conll").read_bytes()
    assert want.count(b"\n\n") == len(jpipe.dm.datasets["dev"])
    # ID FORM POS HEAD, no ALIGN column
    assert all(len(line.split(b"\t")) == 4 for line in want.splitlines() if line)
    assert (tmp_path / "port_dev.conll").read_bytes() == want
    for k, v in jres.items():
        np.testing.assert_allclose(results["dev"][k], v, rtol=TOL, atol=TOL, err_msg=k)
    for split in ("train", "test"):
        assert (tmp_path / f"port_{split}.conll").exists()


def test_export_script_and_convert_round_trip(pair, corpus, tmp_path):
    """``scripts/export_jax_params.py`` writes the params of a lang_only
    checkpoint under the flax paths the port reads, LSTM gates and word
    table included, and ``convert`` maps them both ways."""
    import sys

    jpipe, tpipe, flat = pair
    sys.path.insert(0, str(REPO / "scripts"))
    import export_jax_params

    workdir = jpipe.workdir
    jpipe.workdir = str(tmp_path)
    try:
        path = jpipe.save_checkpoint("best", params_only=True)
    finally:
        jpipe.workdir = workdir
    out = tmp_path / "exported.npz"
    export_jax_params.main(overrides(corpus, layers=2) + [
        f"checkpoint={path}", f"out={out}"])
    with np.load(out) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = convert.torch_to_flax(convert.flax_to_torch(flat, tpipe.model))
    assert sorted(back) == sorted(k.split("/", 1)[1] for k in flat)
    key = "encoder/bwd_1/cell/OptimizedLSTMCell_0/ig/kernel"
    np.testing.assert_array_equal(back[key], flat["params/" + key])
    np.testing.assert_array_equal(
        tpipe.model.encoder.bwd_1.cell.OptimizedLSTMCell_0.ig.weight.detach().numpy(),
        flat["params/" + key].T)


def _jax_step(jpipe, x, y, init_phase):
    inputs = {k: jnp.asarray(v) for k, v in x.items()}
    gold = {k: jnp.asarray(v) for k, v in y.items()}
    key = tuple((k, v.shape) for k, v in sorted(x.items()))
    alpha = jnp.asarray(0.5, jnp.float32)
    rng = jax.random.key(1)
    params, opt_state = jax.device_get((jpipe.state.params, jpipe.state.opt_state))
    (loss, aux), grads = jpipe._get_grad_step(key, init_phase)(
        params, inputs, gold, rng, alpha)
    new, _, _, _ = jpipe._get_train_step(key, init_phase)(
        params, opt_state, inputs, gold, rng, alpha)
    flat = lambda t: {"/".join(k[1:]): np.asarray(v)  # noqa: E731
                      for k, v in traverse_util.flatten_dict(jax.device_get(t)).items()}
    return float(loss), {k: float(v) for k, v in aux.items()}, flat(grads), flat(new)


@pytest.mark.parametrize("init_phase", [True, False], ids=["warm-up", "nll"])
def test_one_train_step_matches_jax(corpus, init_phase):
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    ovs = overrides(corpus, layers=2, dropout=False)
    jpipe, flat = _jax_pipeline(corpus, ovs)
    tpipe = _port_pipeline(corpus, ovs, flat)
    split = "train_init" if init_phase else "train"
    jpipe.dm.include_init_rules = tpipe.dm.include_init_rules = init_phase
    x, y = next(jpipe.dm.batches(split, shuffle=False))
    x, y = _pad(x), _pad(y)
    want_loss, want_aux, want_grads, want_params = _jax_step(jpipe, x, y, init_phase)
    tx, ty = next(tpipe.dm.batches(split, shuffle=False))
    tx, ty = pad_batch_pow2(tx)[0], pad_batch_pow2(ty)[0]
    for k in tx:
        np.testing.assert_array_equal(tx[k], x[k], err_msg=k)
    loss, aux = tpipe.grad_step(tx, ty, init_phase, 0.5)
    assert sorted(aux) == sorted(want_aux) == (["enll"] if init_phase else ["nll"])
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    grads = convert.torch_to_flax({
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in tpipe.model.named_parameters()})
    assert sorted(grads) == sorted(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want_grads[k], atol=1e-5, rtol=1e-4, err_msg=k)
    assert np.abs(grads["encoder/fwd_0/cell/OptimizedLSTMCell_0/hi/kernel"]).max() > 0
    assert np.abs(grads["embedding/word_embedding/embedding"]).max() > 0
    tpipe.apply_step()
    before = convert.torch_to_flax(convert.flax_to_torch(flat, tpipe.model))
    for k, p in convert.torch_to_flax(tpipe.model.state_dict()).items():
        sure = np.abs(want_grads[k]) > 1e-4
        np.testing.assert_allclose(p[sure], want_params[k][sure], atol=2e-6, rtol=0,
                                   err_msg=k)
        assert np.all(np.abs(p - before[k]) <= 1.001e-3), k


def test_train_cli_with_gradient_accumulation(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import train

    monkeypatch.chdir(tmp_path)
    pipe, test = train.main(overrides(corpus) + [
        "trainer.max_epochs=2", "trainer.accumulate_grad_batches=2",
        "device=cpu", "workdir=run", "init_seed=0"])
    run = tmp_path / "run"
    for name in ("checkpoint/best.pt", "checkpoint/last.pt", "test.predict.txt",
                 "dev.predict.txt", "metrics.jsonl", "vocab_word.txt"):
        assert (run / name).exists(), name
    assert 0 <= test["uas"] <= 100 and np.isfinite(test["loss"])
    n_batches = len(pipe.dm.sampler("train"))
    n_init = len(pipe.dm.sampler("train_init"))
    # one update per two batches, the odd one out on its own
    assert pipe.step == -(-n_init // 2) + -(-n_batches // 2)
    state = torch.load(run / "checkpoint" / "last.pt", weights_only=True)
    pipe.model.load_state_dict(state["model"], strict=True)
    # the exponential schedule (gamma given as "0.75**(1/2000)") and Adam's eps
    np.testing.assert_allclose(pipe.current_lr(), 1e-3 * 0.75 ** (pipe.step / 2000),
                               rtol=1e-9)
    assert pipe.optimizer.opt.param_groups[0]["eps"] == 1e-12


def test_accumulated_step_is_the_mean_gradient(corpus):
    """Two accumulated batches give the update of the mean of their
    gradients (``accumulate_grad_batches``)."""
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    ovs = overrides(corpus, dropout=False)
    _, flat = _jax_pipeline(corpus, ovs)
    a = _port_pipeline(corpus, ovs, flat)
    b = _port_pipeline(corpus, ovs, flat)
    batches = [tuple(pad_batch_pow2(t)[0] for t in xy)
               for xy in list(a.dm.batches("train", shuffle=False))[:2]]
    for x, y in batches:
        a.grad_step(x, y, False, 0.5)
    want = {n: p.grad.clone() / 2 for n, p in a.model.named_parameters()
            if p.grad is not None}
    a.apply_step(2)
    for n, p in b.model.named_parameters():
        if n in want:
            p.grad = want[n]
    b.apply_step()
    assert a.step == b.step == 1
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        torch.testing.assert_close(p, q, atol=1e-7, rtol=0, msg=n)


def _write_glove(path, vocab, dim, rng):
    """A GloVe text file with vectors for every other vocab word, one word
    the vocab lacks, and one malformed line."""
    lines, have = [], {}
    for w in vocab.idx2word[2::2]:
        vec = rng.standard_normal(dim).astype(np.float32)
        have[w] = vec
        lines.append(" ".join([w.upper()] + [repr(float(v)) for v in vec]))
    lines.append(" ".join(["zzz-absent"] + ["0.5"] * dim))
    lines.append("short 1.0 2.0")
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
    return have


def test_glove_table_and_row_map_match_jax(pair, tmp_path):
    from vlgae_tpu.models.embedding import glove_row_map as j_map
    from vlgae_tpu.models.embedding import load_glove as j_load
    from vlgae_tpu_torch.models.embedding import glove_row_map, load_glove

    jpipe, tpipe, _ = pair
    jv, tv = jpipe.dm.vocabs["word"], tpipe.dm.vocabs["word"]
    have = _write_glove(tmp_path / "glove.txt", tv, 5, np.random.default_rng(7))
    want_table, want_found = j_load(str(tmp_path / "glove.txt"), jv, 5)
    table, found = load_glove(str(tmp_path / "glove.txt"), tv, 5)
    np.testing.assert_array_equal(table, want_table)
    assert found == want_found == set(have)
    for w, vec in have.items():
        np.testing.assert_array_equal(table[tv[w]], vec)
    assert float(np.abs(table[tv.pad_index]).max()) == 0.0
    row_map = glove_row_map(tv, found)
    assert row_map == j_map(jv, want_found)
    # a dev/test-only word without a vector shares the unk row
    tied = [w for w in tv.idx2word if tv.is_no_create(w) and w not in found]
    assert all(row_map[tv[w]] == tv.unk_index for w in tied)
    assert sum(r != i for i, r in enumerate(row_map)) == len(tied)


def test_model_built_with_a_glove_file(corpus, tmp_path):
    """The factory starts the word table from the file, maps the rows, and
    the table is re-whitened at ``begin`` like the tag table."""
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params

    glove = tmp_path / "glove.6B.5d.txt"
    ovs = overrides(corpus) + ["embedding.word_embedding.args.embedding_dim=5",
                               f"embedding.word_embedding.args.model_dir_or_name={glove}"]
    cfg = compose(ovs)
    dm = build_datamodule(cfg)
    have = _write_glove(glove, dm.vocabs["word"], 5, np.random.default_rng(8))
    model = build_model(cfg, dm)
    init_params(model, 0)
    item = model.embedding.word_embedding
    v = dm.vocabs["word"]
    w = next(iter(have))
    np.testing.assert_array_equal(item.embedding[v[w]].detach().numpy(), have[w])
    assert item.row_map is not None and "row_map" not in model.state_dict()
    pipe = Pipeline(model, dm, cfg, device="cpu", workdir=str(tmp_path))
    before = item.embedding.detach().numpy().copy()
    pipe.normalize_embeddings("begin")
    table = item.embedding.detach()
    from vlgae_tpu.models.embedding import normalize_embedding_params

    counts = [v.word_count.get(x, 1) for x in v.idx2word]
    want = normalize_embedding_params({"embedding": jnp.asarray(before)}, ("embedding",),
                                      "mean+std", counts=counts)["embedding"]
    np.testing.assert_allclose(table.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert np.abs(table.numpy() - before).max() > 1e-3
    ids = torch.tensor([[v[x] for x in v.idx2word[2:6]]])
    torch.testing.assert_close(item(ids), table[item.row_map[ids]])


def test_port_sources_name_neither_jax_nor_the_jax_package():
    """No file of the port, nor ``chip_smoke.py``, imports JAX, anything of
    ``vlgae_tpu``, ``transformers``, ``msgpack`` or ``safetensors``
    (comments and docstrings may name their files); ``nltk`` only in the
    stop-word branch of the datamodule, as in the JAX package."""
    import re

    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|transformers|"
                     r"vlgae_tpu|msgpack|safetensors|nltk)\b(?!_)")
    allowed = {("vlgae_tpu_torch/data/datamodule.py", "from nltk.corpus import stopwords")}
    files = sorted((REPO / "vlgae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert REPO / "vlgae_tpu_torch" / "parallel" / "mesh.py" in files
    hits = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if bad.match(line) and (str(f.relative_to(REPO)), line.strip()) not in allowed]
    assert not hits, hits
