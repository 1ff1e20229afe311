"""The port's modules against their flax twins on the same inputs and
weights (carried through vlgae_tpu_torch.convert): the composite
embedding with the BERT item, the text and visual encoders, and
DiscriminativeNDMV. f32 throughout; tolerance rtol 1e-5 / atol 1e-5
(different summation orders), masked cells compared at their fill."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_slice import build_pair
from vlgae_tpu_torch import convert

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jpipe, tpipe, _ = build_pair(tmp_path_factory.mktemp("modules"))
    x, _ = next(jpipe.dm.batches("dev", shuffle=False))
    return jpipe, tpipe, x


def _apply(jpipe, fn, *args):
    return jpipe.model.apply(jpipe.state.params, *args, method=fn)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _inputs(x):
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def test_embedding_and_encoder(pair):
    jpipe, tpipe, x = pair
    jx, tx = _inputs(x)
    jemb, _ = _apply(jpipe, lambda m, i: m.dependency.embedding(i, deterministic=True), jx)
    with torch.no_grad():
        temb, taux = tpipe.model.dependency.embedding(tx)
    assert temb.shape == jemb.shape and "transformer" in taux
    _close(temb, jemb)
    mask = jnp.arange(jx["token"].shape[1])[None] < jx["seq_len"][:, None]
    jenc = _apply(jpipe, lambda m, e, k: m.dependency.encoder(e, k, deterministic=True),
                  jemb, mask)
    with torch.no_grad():
        tenc = tpipe.model.dependency.encoder(temb, torch.as_tensor(np.array(mask)))
    _close(tenc["x"], jenc["x"])


def test_vis_encoder(pair):
    jpipe, tpipe, x = pair
    jx, tx = _inputs(x)
    want = _apply(jpipe, lambda m, i: m.vis_encoder(i, deterministic=True), jx)
    with torch.no_grad():
        got = tpipe.model.vis_encoder(tx)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_discriminative_ndmv(pair):
    jpipe, tpipe, x = pair
    jx, tx = _inputs(x)

    def jax_fn(m, i):
        emb, aux = m.dependency.embedding(i, deterministic=True)
        mask = jnp.arange(i["token"].shape[1])[None] < i["seq_len"][:, None]
        enc = m.dependency.encoder(emb, mask, deterministic=True)
        return m.dependency(i, encoded=enc, emb_aux=(emb, aux), deterministic=True)

    want = _apply(jpipe, jax_fn, jx)
    dep = tpipe.model.dependency
    with torch.no_grad():
        emb, aux = dep.embedding(tx)
        mask = torch.arange(tx["token"].shape[1])[None] < tx["seq_len"][:, None]
        got = dep(tx, dep.encoder(emb, mask), (emb, aux))
    for k in ("dec", "attach", "root", "merged_dec", "merged_attach"):
        _close(got[k], want[k])


@pytest.mark.parametrize("pooling", ["mean", "first", "last"])
def test_bert_item_stride_windows_and_scalar_mix(pooling):
    """Inputs longer than the position limit go through stride windows;
    two mixed layers exercise ScalarMix."""
    from transformers import BertConfig as HFBertConfig

    from vlgae_tpu.models.embedding import EmbeddingItemCfg as JCfg
    from vlgae_tpu.models.embedding import TransformerItem as JItem
    from vlgae_tpu_torch.models.embedding import (BertConfig, EmbeddingItemCfg,
                                                  TransformerItem)

    dims = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=16)
    kw = dict(embedding_dim=32, n_layers=2, stride=8, pooling=pooling)
    jitem = JItem(JCfg("transformer", "subword", "transformer", **kw),
                  bert_config=HFBertConfig(**dims))
    rng = np.random.default_rng(0)
    B, S, L = 2, 40, 12
    sub = rng.integers(3, 100, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, 30:] = False
    first = np.sort(rng.choice(np.arange(1, 29), (B, L), replace=False), 1)
    last = np.minimum(first + rng.integers(0, 2, (B, L)), 29).astype(np.int32)
    first = first.astype(np.int32)
    params = jitem.init(jax.random.key(0), sub, mask, first, last)
    flat = traverse_util.flatten_dict(params)
    flat[("params", "scalar_mix", "weights")] = np.asarray([0.3, -0.2], np.float32)
    params = traverse_util.unflatten_dict(flat)
    want = jitem.apply(params, sub, mask, first, last)[0]
    titem = TransformerItem(EmbeddingItemCfg("transformer", "subword", "transformer",
                                             **kw), BertConfig(**dims))
    titem.load_state_dict(convert.flax_to_torch(
        {"/".join(k): np.asarray(v) for k, v in flat.items()}, titem))
    with torch.no_grad():
        got = titem(*(torch.as_tensor(a) for a in (sub, mask, first, last)))
    _close(got, want)


def test_leaky_relu_value_and_derivative_match_jax_at_zero():
    """``jax.nn.leaky_relu`` is ``where(x >= 0, x, 0.01 x)``: its derivative
    at exactly 0 is 1, where ``F.leaky_relu``'s is 0.01. In bf16 the
    relation factor's pairwise mean hits exact zeros (two projections that
    are each other's negatives), which moved one feature's gradient of
    ``rel_fc`` by 3e-3 in an ``exp=vlgae_vit`` step."""
    from vlgae_tpu_torch.models.nn import leaky_relu

    xs = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0], np.float32)
    x = torch.tensor(xs, requires_grad=True)
    y = leaky_relu(x)
    y.sum().backward()
    want = np.asarray(jax.nn.leaky_relu(jnp.asarray(xs)))
    np.testing.assert_array_equal(y.detach().numpy(), want)
    np.testing.assert_array_equal(np.signbit(y.detach().numpy()), np.signbit(want))
    np.testing.assert_array_equal(
        x.grad.numpy(), np.asarray(jax.vmap(jax.grad(jax.nn.leaky_relu))(jnp.asarray(xs))))
