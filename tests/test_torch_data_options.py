"""The port's datamodule options against vlgae_tpu's on one synthetic corpus
(tests/synth_data.py): a plain CoNLL corpus through ``DepDataModule``,
``use_char`` (the char vocabulary and the ``[B, L, max_word_len]`` field),
``ignore_stop_word`` (the empty-set branch, and NLTK's list through a
stand-in ``nltk.corpus.stopwords`` module), ``use_img`` (``<split>.npy``
whole-image features) and ``use_gold_scene_graph`` (``gold_feats/`` and
``vlparse_train_sg_raw.json``, written here beside the corpus). Vocabularies
and batches exact; the joint model under ``use_img`` and the gold scene
graph at narrow widths: eval steps (arcs, groundings exact, loss 1e-4) and
byte-identical dev predictions at ``precision=32``, with the weights of
``img_fc`` carried by ``convert.py``."""

import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_data
from test_torch_slice import TOL, _pad, build_pair, overrides

STOP_WORDS = ["the", "a", "on", "under", "is"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("options")
    synth_data.make_corpus(root / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9))
    return root


def _nltk(monkeypatch, branch):
    """``empty``: ``nltk.corpus`` does not import; ``nltk``: a stand-in
    module whose English list is ``STOP_WORDS``."""
    if branch == "empty":
        monkeypatch.setitem(sys.modules, "nltk.corpus", None)
        return
    corpus = types.ModuleType("nltk.corpus")
    corpus.stopwords = types.SimpleNamespace(
        words=lambda lang: list(STOP_WORDS) if lang == "english" else [])
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)


def _same_batches(dm, jdm, splits=("train", "train_init", "dev", "test")):
    n = 0
    for split in splits:
        for (x, y), (jx, jy) in zip(dm.batches(split, shuffle=False),
                                    jdm.batches(split, shuffle=False), strict=True):
            for got, want in ((x, jx), (y, jy)):
                assert sorted(got) == sorted(want), split
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split} {k}")
            n += 1
    return n


def _same_vocabs(dm, jdm):
    assert sorted(dm.vocabs) == sorted(jdm.vocabs)
    for name, v in jdm.vocabs.items():
        assert dm.vocabs[name].idx2word == v.idx2word, name
    assert dm.get_vocab_count() == jdm.get_vocab_count()
    assert list(dm.token2word or []) == list(jdm.token2word or [])
    assert list(dm.token2tag or []) == list(jdm.token2tag or [])


def _dep_kwargs(root, **kw):
    v = root / "vlparse"
    loader = {"batch_size": 8}
    return dict(train_path=str(v / "train.conll"), train_init_path=str(v / "init.conll"),
                dev_path=str(v / "val.conll"), test_path=str(v / "test.conll"),
                train_dataloader=loader, dev_dataloader=loader, test_dataloader=loader, **kw)


@pytest.mark.parametrize("branch", ["empty", "nltk"])
def test_dep_datamodule_stop_words_and_chars_match_jax(corpus, monkeypatch, branch):
    from vlgae_tpu.data import DepDataModule as JDep
    from vlgae_tpu_torch.data import DepDataModule

    _nltk(monkeypatch, branch)
    kw = _dep_kwargs(corpus, num_lex=6, ignore_stop_word=True, use_char=True,
                     max_word_len=4)
    dm, jdm = DepDataModule(**kw).setup(), JDep(**kw).setup()
    assert dm.stop_words_source == branch
    _same_vocabs(dm, jdm)
    assert _same_batches(dm, jdm) >= 4
    lexical = {t.split(":")[0] for t in dm.vocabs["token"].idx2word[2:]} - {"<unk>"}
    plain = DepDataModule(**_dep_kwargs(corpus, num_lex=6)).setup()
    if branch == "nltk":
        assert not lexical & set(STOP_WORDS) and len(lexical) == 6
        assert plain.vocabs["token"].idx2word != dm.vocabs["token"].idx2word
    else:
        assert plain.vocabs["token"].idx2word == dm.vocabs["token"].idx2word
    # chars: 0 pads the word and the sentence; words are cut at max_word_len
    x, _ = next(dm.batches("train", shuffle=False))
    assert x["char"].shape == x["word"].shape + (4,)
    assert dm.get_vocab_count()["n_char"] == len(dm.vocabs["char"]) > 3
    for b, n in enumerate(x["seq_len"]):
        assert (x["char"][b, :n, 0] > 0).all() and not x["char"][b, n:].any()


def test_build_datamodule_dispatches_as_the_jax_clis(corpus):
    from vlgae_tpu_torch.data import DepDataModule, VLParseDataModule
    from vlgae_tpu_torch.predict import build_datamodule, compose

    v = corpus / "vlparse"
    dep = [f"datamodule.{k}_path={v}/{f}.conll" for k, f in
           (("train", "train"), ("train_init", "init"), ("dev", "val"), ("test", "test"))]
    cfg = compose(["exp=lang_only", f"root={corpus}",
                   "datamodule._target_=vlgae_tpu.data.DepDataModule", *dep])
    dm = build_datamodule(cfg)
    assert type(dm) is DepDataModule and not hasattr(dm, "load_vis")
    assert len(dm.datasets["dev"]) == 10  # every caption: no scene graph needed
    cfg = compose(overrides(corpus))
    assert type(build_datamodule(cfg)) is VLParseDataModule


def write_gold(root, rng):
    """``gold_feats/<img_id>.npy`` (one row an object: features and box) for
    every image, and ``vlparse_train_sg_raw.json``: the training images'
    scene graphs with four objects and two relations in place of
    ``vlparse.json``'s three and one."""
    v = Path(root) / "vlparse"
    (v / "gold_feats").mkdir(exist_ok=True)
    sg = {e["coco_id"]: e for e in json.loads((v / "vlparse.json").read_text())}
    train_ids = {int(i) for i in (v / "id_list" / "train.txt").read_text().split()}
    raw = []
    for img_id in sorted(sg):
        entry = sg[img_id]
        if img_id in train_ids:
            objs = [dict(id=k, x=float(10 * k), y=5.0, width=20.0, height=30.0 + k)
                    for k in range(4)]
            entry = dict(entry, obj=objs, rel=[
                dict(id=4, subj=0, obj=1, x=0.0, y=0.0, width=1.0, height=1.0),
                dict(id=5, subj=3, obj=2, x=0.0, y=0.0, width=1.0, height=1.0)])
            entry["txt2sg"] = [{"1": {"type": "OBJ", "preferred": s % 4,
                                      "candidates": [[s % 4, 1.0]]},
                                "2": {"type": "REL", "preferred": 4 + s % 2,
                                      "candidates": [[4, 1.0]]},
                                "0": {"type": "ATTR", "preferred": 3,
                                      "candidates": [[3, 1.0]]}} for s in range(5)]
            raw.append(entry)
        boxes = np.array([[o["x"], o["y"], o["x"] + o["width"], o["y"] + o["height"]]
                          for o in entry["obj"]], np.float32)
        feats = rng.standard_normal((len(boxes), 16)).astype(np.float32)
        np.save(v / "gold_feats" / f"{img_id}.npy", np.concatenate([feats, boxes], 1))
    (v / "vlparse_train_sg_raw.json").write_text(json.dumps(raw))


def write_img_feats(root, rng, dim=16):
    """``<split>.npy``: one whole-image feature row per image of the split."""
    v = Path(root) / "vlparse"
    for split in ("train", "init", "val", "test"):
        n = len((v / "id_list" / f"{split}.txt").read_text().split())
        np.save(v / f"{split}.npy", rng.standard_normal((n, dim)).astype(np.float32))


def _vlparse_kwargs(root, **kw):
    v = Path(root) / "vlparse"
    loader = {"batch_size": 8}
    return dict(train_path=str(v / "train"), train_init_path=str(v / "init"),
                dev_path=str(v / "val"), test_path=str(v / "test"),
                sg_path=str(v / "vlparse.json"), pad_boxes=6, num_lex=0,
                train_dataloader=loader, dev_dataloader=loader, test_dataloader=loader,
                **kw)


@pytest.mark.parametrize("sample_boxes", [0, 3])
def test_gold_scene_graph_and_image_batches_match_jax(corpus, sample_boxes):
    from vlgae_tpu.data import VLParseDataModule as JVLParse
    from vlgae_tpu_torch.data import VLParseDataModule

    rng = np.random.default_rng(5)
    write_gold(corpus, rng)
    write_img_feats(corpus, rng)
    kw = _vlparse_kwargs(corpus, use_gold_scene_graph=True, use_img=True,
                         sample_boxes=sample_boxes)
    dm, jdm = VLParseDataModule(**kw).setup(), JVLParse(**kw).setup()
    _same_vocabs(dm, jdm)
    assert _same_batches(dm, jdm) >= 4
    x, y = next(dm.batches("train", shuffle=False))
    # four gold objects (three when sampled), relations from the gold scene graph
    n_obj = min(4, sample_boxes or 4)
    assert (x["vis_box_mask"].sum(1) == n_obj).all()
    assert x["vis_rel_mask"].any() and x["vis_img"].shape == (len(x["id"]), 16)
    assert (y["sg_type"][:, 0] == 2).all() and (y["sg_type"][:, 2] == 3).all()
    assert set(np.unique(y["sg_box"][:, 1, 0])) <= {0.0, 10.0, 20.0, 30.0}


def test_image_features_need_the_visual_encoder(corpus):
    """As every region feature, ``vis_img`` is read only for a recipe with a
    visual encoder (``load_vis``)."""
    from vlgae_tpu_torch.data import VLParseDataModule

    write_img_feats(corpus, np.random.default_rng(6))
    kw = _vlparse_kwargs(corpus, use_img=True)
    x, _ = next(VLParseDataModule(**kw).setup().batches("dev", shuffle=False))
    assert x["vis_img"].dtype == np.float32
    x, _ = next(VLParseDataModule(load_vis=False, **kw).setup().batches("dev", shuffle=False))
    assert not any(k.startswith("vis") for k in x)


GOLD_IMG = ["datamodule.use_gold_scene_graph=true", "datamodule.use_img=true",
            "vis_encoder.use_img=true", "datamodule.sample_boxes=3"]


@pytest.fixture(scope="module")
def gold_pair(tmp_path_factory):
    """(root, JAX pipeline, port pipeline, flat params) of ``exp=vlgae`` at
    narrow widths with the gold scene graph and ``use_img``."""
    root = tmp_path_factory.mktemp("gold")
    synth_data.make_corpus(root / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9))
    rng = np.random.default_rng(7)
    write_gold(root, rng)
    write_img_feats(root, rng)
    return (root,) + build_pair(root, GOLD_IMG)


def test_gold_and_image_eval_steps_match_jax(gold_pair):
    _, jpipe, tpipe, flat = gold_pair
    assert "params/vis_encoder/img_fc/Dense_0/kernel" in flat
    img_fc = tpipe.model.vis_encoder.img_fc.linear.weight.detach().numpy()
    np.testing.assert_array_equal(img_fc, flat["params/vis_encoder/img_fc/Dense_0/kernel"].T)
    params = jpipe.state.params
    alpha = jnp.asarray(0.5, jnp.float32)
    n = 0
    for (x, y), (tx, _) in zip(jpipe.dm.batches("dev", shuffle=False),
                               tpipe.dm.batches("dev", shuffle=False), strict=True):
        xp, yp = _pad(x), _pad(y)
        assert "vis_img" in xp and (xp["vis_box_mask"].sum(1) == 3).all()
        fn = jpipe._get_eval_step(tuple((k, v.shape) for k, v in sorted(xp.items())))
        want = jax.device_get(fn(params, {k: jnp.asarray(v) for k, v in xp.items()},
                                 {k: jnp.asarray(v) for k, v in yp.items()}, alpha))
        got = tpipe.eval_step(_pad(tx))
        for key in ("arc", "txt_to_factor_idx", "txt_to_img", "txt_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
        jvis = jpipe.model.apply(params, {k: jnp.asarray(v) for k, v in xp.items()},
                                 method=lambda m, inp: m.vis_encoder(inp))
        with torch.no_grad():
            tvis = tpipe.model.vis_encoder({k: torch.as_tensor(v) for k, v in xp.items()})
        assert sorted(tvis) == sorted(jvis) == ["attr", "box", "img", "rel"]
        for k in jvis:
            np.testing.assert_allclose(tvis[k].numpy(), np.asarray(jvis[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        n += 1
    assert n >= 1


def test_gold_and_image_prediction_files_identical(gold_pair, tmp_path, monkeypatch):
    root, jpipe, _, _ = gold_pair
    from vlgae_tpu_torch.predict import main

    jres, jout = jpipe.evaluate("dev")
    jpipe.write_predictions(str(tmp_path / "jax_dev.conll"), "dev", jout)
    monkeypatch.chdir(tmp_path)
    _, results = main(overrides(root) + GOLD_IMG + [
        f"weights={root}/weights.npz", "device=cpu", "name=port"])
    want = (tmp_path / "jax_dev.conll").read_bytes()
    assert want.count(b"\n\n") == len(jpipe.dm.datasets["dev"])
    assert (tmp_path / "port_dev.conll").read_bytes() == want
    for k, v in jres.items():
        np.testing.assert_allclose(results["dev"][k], v, rtol=TOL, atol=TOL, err_msg=k)
