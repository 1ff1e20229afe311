"""The port's ``BlankEncoder``, ``MultiEncoder``, char-CNN item and BERT read
from a local directory against vlgae_tpu on the same numpy-seeded inputs,
with weights carried by ``vlgae_tpu_torch.convert``. f32 forwards: 1e-5
relative and absolute (different summation orders); shapes, names and
dimensions exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vlgae_tpu_torch import convert

TOL = 1e-5


def _flat(params):
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params["params"]).items()}


def _perturbed(flat, rng):
    """Every leaf moved off its init (biases are 0 there)."""
    return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})}


def test_blank_encoder_is_the_embedding_with_dropout():
    from vlgae_tpu.models import BlankEncoder as JBlank
    from vlgae_tpu_torch.models.nn import set_dropout_generator
    from vlgae_tpu_torch.models.text_encoder import BlankEncoder
    from vlgae_tpu_torch.training.factory import build_encoder

    emb = np.random.default_rng(0).standard_normal((2, 5, 6)).astype(np.float32)
    want = JBlank(n_in=6, dropout=0.5).apply({}, jnp.asarray(emb), None)["x"]
    enc, n_enc = build_encoder({"_target_": "SomeOtherEncoder", "dropout": 0.5}, 6)
    assert isinstance(enc, BlankEncoder) and n_enc == enc.get_dim("x") == 6
    assert JBlank(n_in=6).get_dim("x") == 6 and not list(enc.parameters())
    x = torch.as_tensor(emb)
    np.testing.assert_array_equal(enc.eval()(x, None)["x"].numpy(), np.asarray(want))
    set_dropout_generator(enc, torch.Generator().manual_seed(0))
    kept = enc.train()(x, None)["x"]
    assert set(np.unique(np.round(kept.numpy() / emb, 5))) <= {0.0, 2.0}
    assert 0 < int((kept == 0).sum()) < kept.numel()


def test_multi_encoder_matches_flax():
    from vlgae_tpu.models import BlankEncoder as JBlank
    from vlgae_tpu.models import MLPEncoder as JMLP
    from vlgae_tpu.models import MultiEncoder as JMulti
    from vlgae_tpu_torch.models.text_encoder import BlankEncoder, MLPEncoder, MultiEncoder

    rng = np.random.default_rng(1)
    B, L, D = 2, 4, 6
    emb = rng.standard_normal((B, L, D)).astype(np.float32)
    mapping = (("x", ("a.x", "b.x", "c.x")), ("y", ("b.x",)), ("z", ("c.x",)))
    jenc = JMulti(encoders=(("a", JMLP(n_hidden=5)), ("b", JBlank(n_in=D)),
                            ("c", JMLP(n_hidden=3))), mapping=mapping)
    flat = _perturbed(_flat(jenc.init(jax.random.key(0), jnp.asarray(emb),
                                      jnp.ones((B, L), bool))), rng)
    assert sorted(flat) == ["encoders_0_1/Dense_0/bias", "encoders_0_1/Dense_0/kernel",
                            "encoders_2_1/Dense_0/bias", "encoders_2_1/Dense_0/kernel"]
    want = jenc.apply(_tree(flat), jnp.asarray(emb), jnp.ones((B, L), bool))
    enc = MultiEncoder((("a", MLPEncoder(D, 5)), ("b", BlankEncoder(D)),
                        ("c", MLPEncoder(D, 3))), mapping)
    enc.load_state_dict(convert.flax_to_torch(flat, enc))
    assert sorted(convert.torch_to_flax(enc.state_dict())) == sorted(flat)
    got = enc.eval()(torch.as_tensor(emb), torch.ones(B, L, dtype=torch.bool))
    assert sorted(got) == sorted(want) == ["x", "y", "z"]
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
        assert enc.get_dim(k) == jenc.get_dim(k) == got[k].shape[-1]
    with pytest.raises(KeyError):
        enc.get_dim("w")


@pytest.mark.parametrize("kernel_sizes,filter_nums", [((1, 3, 5), (4, 5, 6)),
                                                      ((2, 4), (3, 5))],
                         ids=["odd", "even"])
def test_char_item_matches_flax(kernel_sizes, filter_nums):
    """Flax's "SAME" padding puts the larger half on the right for an even
    width; padding characters are masked out of the max, and a word of
    padding only embeds to exactly 0."""
    from vlgae_tpu.models.embedding import CharItem as JChar
    from vlgae_tpu.models.embedding import EmbeddingItemCfg as JCfg
    from vlgae_tpu_torch.models.embedding import CharItem, EmbeddingItemCfg

    dims = dict(n_vocab=13, embedding_dim=7, char_dim=5, kernel_sizes=kernel_sizes,
                filter_nums=filter_nums)
    rng = np.random.default_rng(2)
    chars = rng.integers(1, 13, (3, 4, 6)).astype(np.int32)
    chars[0, 3] = 0  # a padding word
    chars[1, 1, 2:] = 0  # a two-letter word
    chars[2, 0, 1:] = 0  # a one-letter word
    jitem = JChar(JCfg("char", "char", "char", **dims))
    flat = _perturbed(_flat(jitem.init(jax.random.key(0), jnp.asarray(chars))), rng)
    want = np.asarray(jitem.apply(_tree(flat), jnp.asarray(chars))[0])
    item = CharItem(EmbeddingItemCfg("char", "char", "char", **dims))
    item.load_state_dict(convert.flax_to_torch(flat, item))
    k = kernel_sizes[-1]
    np.testing.assert_array_equal(getattr(item, f"conv{k}").weight.detach().numpy(),
                                  flat[f"conv{k}/kernel"].transpose(2, 1, 0))
    got = item(torch.as_tensor(chars)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[0, 3] == 0).all() and not (got[1, 1] == 0).all()
    back = convert.torch_to_flax(item.state_dict())
    for key, v in flat.items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)


BERT_DIR = dict(model_type="bert", vocab_size=50, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=96, max_position_embeddings=40,
                type_vocab_size=2, layer_norm_eps=1e-7, hidden_act="gelu",
                hidden_dropout_prob=0.1)


def _bert_dir(tmp_path, **fields):
    d = tmp_path / "bert"
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps(dict(BERT_DIR, **fields)))
    return str(d)


def test_bert_config_from_dir_matches_autoconfig(tmp_path):
    from transformers import AutoConfig

    from vlgae_tpu.training.factory import _bert_config
    from vlgae_tpu_torch.models.embedding import BertConfig

    path = _bert_dir(tmp_path)
    ours, ref = BertConfig.from_dir(path), AutoConfig.from_pretrained(path)
    for f in BertConfig.__dataclass_fields__:
        assert getattr(ours, f) == getattr(ref, f), f
    assert _bert_config(path)[1] == ours.hidden_size
    # fields the file leaves out take transformers' defaults
    (tmp_path / "bert" / "config.json").write_text(json.dumps({"model_type": "bert"}))
    ours, ref = BertConfig.from_dir(path), AutoConfig.from_pretrained(path)
    assert all(getattr(ours, f) == getattr(ref, f) for f in BertConfig.__dataclass_fields__)
    for field, value in (("hidden_act", "gelu_new"), ("position_embedding_type", "relative_key"),
                         ("model_type", "roberta"), ("num_attention_heads", 5)):
        _bert_dir(tmp_path, **{field: value})
        with pytest.raises(ValueError, match=field if field != "num_attention_heads"
                           else "not a multiple"):
            BertConfig.from_dir(path)


def test_bert_item_from_a_directory_matches_flax(tmp_path):
    """The factory builds the BERT at the width of the directory's
    ``config.json`` (random-init), and the port's BERT at that width
    computes flax's ``FlaxBertModule`` (2 layers x 64, its layer-norm eps)."""
    from transformers import AutoConfig

    from vlgae_tpu.models.embedding import EmbeddingItemCfg as JCfg
    from vlgae_tpu.models.embedding import TransformerItem as JItem
    from vlgae_tpu_torch.models.embedding import (BertConfig, EmbeddingItemCfg,
                                                  TransformerItem)
    from vlgae_tpu_torch.training.factory import build_embedding

    path = _bert_dir(tmp_path)
    dm = type("DM", (), {"vocabs": {"tag": list(range(5))}})()
    emb = build_embedding({"use_word": False, "use_subword": True,
                           "transformer": {"args": {"model": path}}}, dm)
    assert emb.transformer.bert.config == BertConfig.from_dir(path)
    assert emb.embed_size == 64 + 100
    rng = np.random.default_rng(3)
    B, S, L = 2, 12, 5
    sub = rng.integers(0, 50, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, 9:] = False
    first = np.array([[1, 2, 4, 5, 8], [1, 3, 4, 6, 7]], np.int32)
    last = np.array([[1, 3, 4, 7, 9], [2, 3, 5, 6, 8]], np.int32)
    jitem = JItem(JCfg("transformer", "subword", "transformer", embedding_dim=64),
                  bert_config=AutoConfig.from_pretrained(path))
    flat = _perturbed(_flat(jitem.init(jax.random.key(0), sub, mask, first, last)), rng)
    want = jitem.apply(_tree(flat), sub, mask, first, last)[0]
    item = TransformerItem(EmbeddingItemCfg("transformer", "subword", "transformer",
                                            embedding_dim=64), BertConfig.from_dir(path))
    item.load_state_dict(convert.flax_to_torch(flat, item))
    with torch.no_grad():
        got = item(*(torch.as_tensor(a) for a in (sub, mask, first, last)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
