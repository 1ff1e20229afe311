"""The parser's context and variational modes, the variational embedding
items and the BiLSTM's options in the port, against vlgae_tpu.

* The module tests of tests/test_variational.py on the port's parser
  (sentence VAE, IB with the tag context, the embedding-level VAE), and
  the same forward in both packages on carried parameters: eval (posterior
  means) within 1e-5, and training with the same numpy noise on both sides
  (``jax.random.normal`` is replaced by a function returning it, the port
  module's ``noise`` by the same arrays) within 1e-5.
* One ``exp=lang_only`` NLL train step at narrow widths and precision 32 per
  mode, every dropout 0 and the same noise: loss within 1e-4 relative,
  gradients within 1e-4 + 1e-3 |x|. The modes: ``all:vae``, ``tag:ib``,
  ``context_mode=max``; ``token`` context with ``tag:vae``, a VAE word
  embedding and the BiLSTM's ``reproject_emb``/``reproject_out``/``mix``/
  ``cat_emb`` (``output_layers=-2``); ``passthrough`` with ``all:ib``, an IB
  word embedding and the concatenated layers.
* ``vlgae_tpu_torch.train`` then ``.predict`` under those options, and an
  ``init_method`` that is a path: in both packages it turns the warm-up
  epochs off.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import synth_data
from test_models import N_TAG, N_TOKEN, N_WORD, make_inputs
from test_torch_lang_only import _jax_pipeline, _jax_step, _pad, _port_pipeline, overrides
from vlgae_tpu_torch import convert

Z, OUT = 6, 8
MODES = {
    "all_vae": ["model.variational_mode=all:vae", f"model.z_dim={Z}"],
    "tag_ib": ["model.variational_mode=tag:ib", f"model.z_dim={Z}"],
    "max": ["model.context_mode=max"],
    "token_tag_vae_rnn_mix": [
        "model.context_mode=token", "model.variational_mode=tag:vae", "model.z_dim=5",
        "embedding.word_embedding.adaptor_args.mode=vae",
        f"embedding.word_embedding.adaptor_args.out_dim={OUT}",
        "encoder.output_layers=-2", "encoder.mix=true", "encoder.reproject_emb=8",
        "encoder.reproject_out=12", "encoder.cat_emb=true"],
    "passthrough_all_ib_concat": [
        "model.context_mode=passthrough", "model.variational_mode=all:ib",
        f"model.z_dim={Z}", "embedding.word_embedding.adaptor_args.mode=ib",
        f"embedding.word_embedding.adaptor_args.out_dim={OUT}",
        "encoder.output_layers=-2"],
}


def _eps(shape, seed=0):
    return np.random.default_rng([seed, *shape]).standard_normal(shape).astype(np.float32)


def _feed_noise(monkeypatch):
    """``jax.random.normal`` returns the test's noise for its shape."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                            _eps(tuple(shape)), dtype))


def _port_noise(model):
    """Every drawing module of the port model takes the same noise."""
    from vlgae_tpu_torch.models.nn import Dropping

    for m in model.modules():
        if isinstance(m, Dropping):
            m.noise = lambda shape, like: torch.from_numpy(_eps(tuple(shape))).to(like)


# -- the module tests of tests/test_variational.py, on both packages ------------------


def _build_pair(variational_mode, emb_mode="basic"):
    """The JAX parser of tests/test_variational.py::build (without dropout)
    and the port's on its parameters."""
    from vlgae_tpu import models as jm
    from vlgae_tpu.models.embedding import EmbeddingItemCfg as JItem
    from vlgae_tpu_torch.models.embedding import CompositeEmbedding, EmbeddingItemCfg
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV, LDNDMVConfig
    from vlgae_tpu_torch.models.text_encoder import MLPEncoder

    items = [("word_embedding", "word", "static", dict(n_vocab=N_WORD, embedding_dim=16,
                                                       mode=emb_mode, out_dim=OUT)),
             ("tag_embedding", "tag", "static", dict(n_vocab=N_TAG, embedding_dim=8))]
    kw = dict(context_mode="mean", variational_mode=variational_mode, z_dim=Z,
              hidden_size=24, attach_rank=4, dec_rank=4, root_rank=4, root_emb_dim=6,
              dec_emb_dim=6, ff_dropout=0.0)  # the noise is the only draw
    t2w = tuple(i % N_WORD for i in range(N_TOKEN))
    t2t = tuple(i % N_TAG for i in range(N_TOKEN))
    jmodel = jm.DiscriminativeNDMV(
        cfg=jm.LDNDMVConfig(**kw, n_token=N_TOKEN, n_tag=N_TAG),
        embedding=jm.CompositeEmbedding(items=tuple(JItem(*a, **k) for *a, k in items)),
        encoder=jm.MLPEncoder(n_hidden=24), token2word=t2w, token2tag=t2t)
    emb = CompositeEmbedding(tuple(EmbeddingItemCfg(*a, **k) for *a, k in items))
    tmodel = DiscriminativeNDMV(LDNDMVConfig(**kw), emb,
                                MLPEncoder(emb.embed_size, 24), 24,
                                token2word=t2w, token2tag=t2t)
    inputs = make_inputs(np.random.default_rng(0))
    params = jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1),
                          "sample": jax.random.key(2)}, inputs)
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params["params"])).items()}
    tmodel.load_state_dict(convert.flax_to_torch(flat, tmodel), strict=True)
    tinputs = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    return jmodel, params, inputs, tmodel, tinputs


@pytest.mark.parametrize("vmode,emb_mode", [("all:vae", "basic"), ("tag:ib", "basic"),
                                            ("none", "vae"), ("all:ib", "ib")])
def test_forward_matches_jax_in_eval_and_training(vmode, emb_mode, monkeypatch):
    from vlgae_tpu.models import loss_nll as jloss
    from vlgae_tpu_torch.models.ldndmv import loss_nll
    from vlgae_tpu_torch.models.nn import set_dropout_generator

    jmodel, params, inputs, tmodel, tinputs = _build_pair(vmode, emb_mode)
    keys = ["attach", "dec", "root", "kl", "emb_kl"]
    for train in (False, True):
        if train:
            _feed_noise(monkeypatch)
            _port_noise(tmodel)
            set_dropout_generator(tmodel, torch.Generator().manual_seed(0))
        want = jmodel.apply(params, inputs, deterministic=not train,
                            rngs={"dropout": jax.random.key(3),
                                  "sample": jax.random.key(4)} if train else {})
        with torch.no_grad():
            got = tmodel.train(train)(tinputs)
        for k in keys:
            if want.get(k) is None:
                assert got.get(k) is None, k
                continue
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{k} train={train}")
        jt, jaux = jloss(want, inputs["seq_len"], viterbi=False)
        tt, taux = loss_nll(got, tinputs["seq_len"], viterbi=False)
        assert sorted(taux) == sorted(jaux)
        np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)


def test_sentence_vae():
    from vlgae_tpu_torch.models.ldndmv import loss_nll
    from vlgae_tpu_torch.models.nn import set_dropout_generator

    *_, model, inputs = _build_pair("all:vae")
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    out = model.train()(inputs)
    assert out["kl"] is not None and np.isfinite(out["kl"].item())
    total, aux = loss_nll(out, inputs["seq_len"], viterbi=False)
    assert "lstm_kl" in aux and np.isfinite(total.item())
    # sampling is active in training: two draws give different scores
    o2 = model(inputs)
    assert not torch.allclose(out["attach"], o2["attach"])
    # eval uses the mean, and needs no generator
    set_dropout_generator(model, None)
    model.eval()
    torch.testing.assert_close(model(inputs)["attach"], model(inputs)["attach"],
                               rtol=0, atol=0)


def test_sentence_ib_with_tag_context():
    from vlgae_tpu_torch.models.ldndmv import loss_nll
    from vlgae_tpu_torch.models.nn import set_dropout_generator

    *_, model, inputs = _build_pair("tag:ib")
    set_dropout_generator(model, torch.Generator().manual_seed(1))
    out = model.train()(inputs)
    assert np.isfinite(out["kl"].item())
    total, _ = loss_nll(out, inputs["seq_len"], viterbi=False)
    total.backward()
    # the bottleneck's prior takes a gradient
    assert torch.isfinite(model.target_mean.grad).all()
    assert float(model.target_mean.grad.abs().max()) > 0


def test_embedding_level_vae():
    from vlgae_tpu_torch.models.ldndmv import loss_nll
    from vlgae_tpu_torch.models.nn import set_dropout_generator

    *_, model, inputs = _build_pair("none", emb_mode="vae")
    set_dropout_generator(model, torch.Generator().manual_seed(2))
    out = model.train()(inputs)
    assert out.get("emb_kl") is not None
    total, aux = loss_nll(out, inputs["seq_len"], viterbi=False)
    assert "emb_kl" in aux and "lstm_kl" not in aux and np.isfinite(total.item())


def test_max_context_zeroes_rows_without_words():
    """A row of padding alone (seq_len 0) has a max context of 0, not -inf,
    so no NaN reaches the gradient."""
    from vlgae_tpu_torch.models.embedding import CompositeEmbedding, EmbeddingItemCfg
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV, LDNDMVConfig

    emb = CompositeEmbedding((EmbeddingItemCfg("word_embedding", "word", "static",
                                               n_vocab=5, embedding_dim=4),))
    dep = DiscriminativeNDMV(LDNDMVConfig(context_mode="max"), emb, None, 3,
                             token2word=(0,))
    x = torch.randn(2, 4, 3, requires_grad=True)
    mask = torch.tensor([[True, True, False, False], [False] * 4])
    ctx, kl = dep.extract_sent_repr({"x": x}, mask)
    assert kl is None and ctx[1].abs().max().item() == 0.0
    ctx.sum().backward()
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(ctx[0, 0], x[0, :2].amax(0))


# -- one exp=lang_only train step per mode ------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("variational")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=8, n_box=8,
                           len_range=(3, 9))
    return root


@pytest.mark.parametrize("mode", list(MODES))
def test_one_nll_step_matches_jax(corpus, mode, monkeypatch):
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    ovs = overrides(corpus, layers=2, dropout=False) + MODES[mode]
    jpipe, flat = _jax_pipeline(corpus, ovs)
    tpipe = _port_pipeline(corpus, ovs, flat)
    x, y = next(jpipe.dm.batches("train", shuffle=False))
    x, y = _pad(x), _pad(y)
    _feed_noise(monkeypatch)
    want_loss, want_aux, want_grads, _ = _jax_step(jpipe, x, y, False)
    tx, ty = next(tpipe.dm.batches("train", shuffle=False))
    tx, ty = pad_batch_pow2(tx)[0], pad_batch_pow2(ty)[0]
    _port_noise(tpipe.model)
    loss, aux = tpipe.grad_step(tx, ty, False, 0.5)
    assert sorted(aux) == sorted(want_aux)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), want_aux[k], rtol=1e-4, atol=1e-6, err_msg=k)
    grads = convert.torch_to_flax({
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in tpipe.model.named_parameters()})
    assert sorted(grads) == sorted(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want_grads[k], atol=1e-4, rtol=1e-3, err_msg=k)
    if "variational_mode=none" not in " ".join(MODES[mode]) and "z_dim" in " ".join(
            MODES[mode]):
        assert "lstm_kl" in aux
        assert np.abs(grads["variational_enc/kernel"]).max() > 0


def test_cli_trains_and_predicts_under_the_options(corpus, tmp_path, monkeypatch):
    from vlgae_tpu_torch import predict, train

    monkeypatch.chdir(tmp_path)
    ovs = overrides(corpus) + MODES["token_tag_vae_rnn_mix"]
    pipe, test = train.main(ovs + ["trainer.max_epochs=2", "device=cpu", "workdir=run",
                                   "init_seed=0"])
    assert 0 <= test["uas"] <= 100 and np.isfinite(test["loss"])
    assert pipe.model.encoder.ScalarMix_0.weights.shape == (1,)
    _, results = predict.main(ovs + ["checkpoint=run/checkpoint/last.pt", "device=cpu",
                                     "name=again"])
    np.testing.assert_allclose(results["test"]["uas"], test["uas"], rtol=0, atol=1e-9)
    assert (tmp_path / "again_dev.conll").exists()


def test_init_method_path_skips_the_warm_up_in_both_packages(corpus, tmp_path):
    """``init_method`` a path (a pretrained DMV in the reference): the
    warm-up phase is off from the first epoch, and nothing is loaded."""
    ovs = overrides(corpus, dropout=False) + [
        f"model.init_method={tmp_path / 'pretrained_dmv.pt'}", "trainer.fast_dev_run=1"]
    jpipe, flat = _jax_pipeline(corpus, ovs)
    tpipe = _port_pipeline(corpus, ovs, flat)
    jstats = jpipe.train_epoch(0)
    tstats = tpipe.train_epoch(0)
    assert tpipe.dep_cfg.init_epoch == 1
    assert jstats["train/init_phase"] is False and tstats["train/init_phase"] is False
    assert "train/nll" in tstats and "train/enll" not in tstats
