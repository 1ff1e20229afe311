"""The port against the reference goldens of tests/golden/: ``dmv_ref.npz``
and ``deptree_ref.npz`` (the reference torch-struct fork's DMV and
Eisner CRF outputs on fixed potentials), ``init_ref.npz`` (the
reference km_init/good_init tables), with the tolerances of
tests/test_golden_ref.py and tests/test_host_golden.py: merge exact;
totals 2e-5 relative; marginals and indicators 1e-4 relative + 1e-5
absolute; matrix-tree partition 1e-4 relative; init tables 1e-10
relative + 1e-12 absolute. Then ``nn_ref.npz`` (the reference's layers),
``model_ref.npz`` (its composed parser and joint model, the classic DMV's
EM cycle, the warm-up rule counts, the BiLSTM, embedding re-whitening)
and ``trajectory_ref.npz`` (ten optimizer steps) with the tolerances of
tests/test_nn_golden.py, test_model_golden.py and
test_trajectory_golden.py. The reference's torch weights are copied into
the port's modules by name.

The DMV goldens go through the plain DP and through the dispatch
(``DMV1o``); the Eisner goldens through the plain fill and through
``DependencyCRF``'s route over the DMV DP. The file imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from vlgae_tpu_torch.models.dmv_init import good_init, km_init
from vlgae_tpu_torch.struct import (DependencyCRF, DMV1o, deptree_marginals,
                                    deptree_nonproj_marginals, deptree_nonproj_partition,
                                    deptree_partition, dmv_merge, dmv_total,
                                    dmv_value_and_grads_plain)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _load(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def dmv_ref():
    d = _load("dmv_ref.npz")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    t["lengths"] = t["lengths"].int()
    return d, t


@pytest.fixture(scope="module")
def deptree_ref():
    d = _load("deptree_ref.npz")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    t["lengths"] = t["lengths"].int()
    return d, t


def test_dmv_merge_matches_reference(dmv_ref):
    d, t = dmv_ref
    mdec, mattach = dmv_merge(t["dec"], t["attach"], t["root"])
    np.testing.assert_array_equal(mdec.numpy(), d["merged_dec"])
    np.testing.assert_array_equal(mattach.numpy(), d["merged_attach"])


@pytest.mark.parametrize("kind", ["log", "max"])
def test_dmv_totals_and_tables_match_reference(dmv_ref, kind):
    d, t = dmv_ref
    total_key, table_key = ("partition", "marginals") if kind == "log" else ("max", "argmax")
    md, ma, lens = t["merged_dec"], t["merged_attach"], t["lengths"]
    np.testing.assert_allclose(dmv_total(md, ma, lens, kind).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    _, _, ga = dmv_value_and_grads_plain(md, ma, lens, kind)
    np.testing.assert_allclose(ga.numpy(), d[table_key], rtol=1e-4, atol=1e-5)
    dist = DMV1o((md, ma), lens)
    np.testing.assert_allclose((dist.partition if kind == "log" else dist.max).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    np.testing.assert_allclose((dist.marginals if kind == "log" else dist.argmax).numpy(),
                               d[table_key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["log", "max"])
def test_deptree_matches_reference(deptree_ref, kind):
    d, t = deptree_ref
    total_key, table_key = ("partition", "marginals") if kind == "log" else ("max", "argmax")
    arc, lens = t["arc"], t["lengths"]
    np.testing.assert_allclose(deptree_partition(arc, lens, kind).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    np.testing.assert_allclose(deptree_marginals(arc, lens, kind).numpy(), d[table_key],
                               rtol=1e-4, atol=1e-5)
    crf = DependencyCRF(arc, lens)
    np.testing.assert_allclose((crf.partition if kind == "log" else crf.max).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    np.testing.assert_allclose((crf.marginals if kind == "log" else crf.argmax).numpy(),
                               d[table_key], rtol=1e-4, atol=1e-5)


def test_matrix_tree_matches_reference(deptree_ref):
    d, t = deptree_ref
    np.testing.assert_allclose(deptree_nonproj_partition(t["mtt_arc"]).numpy(),
                               d["mtt_partition"], rtol=1e-4)
    np.testing.assert_allclose(deptree_nonproj_marginals(t["mtt_arc"]).numpy(),
                               d["mtt_marginals"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["km", "good"])
def test_init_tables_match_reference(method):
    ref = _load("init_ref.npz")
    seq_len = ref["seq_len"]
    tokens = [ref["tokens"][i, :n].tolist() for i, n in enumerate(seq_len)]
    heads = [ref["heads"][i, :n].tolist() for i, n in enumerate(seq_len)]
    n_token, smooth = int(ref["n_token"]), float(ref["smooth"])
    if method == "km":
        tables = km_init(tokens, n_token, smooth)
    else:
        tables = good_init(tokens, heads, n_token, smooth)
    for got, name in zip(tables, ("dec", "trans", "root")):
        np.testing.assert_allclose(got, ref[f"{method}_{name}"], rtol=1e-10, atol=1e-12,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# nn_ref.npz: the reference's torch layers in eval mode (tolerances of
# tests/test_nn_golden.py: 1e-5 relative + 1e-6 absolute; the visual
# encoder 1e-4 + 1e-5; the KL 1e-5 relative)
# ---------------------------------------------------------------------------

def _sub(ref, prefix):
    p = prefix + "/"
    return {k[len(p):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(p) and v.dtype.kind in "fiub"}


def _set_linear(layer, d, key):
    """Copy the reference's ``<key>.weight`` (and ``.bias``) into a Linear."""
    with torch.no_grad():
        layer.weight.copy_(d[f"{key}.weight"])
        if layer.bias is not None:
            layer.bias.copy_(d[f"{key}.bias"])


@pytest.fixture(scope="module")
def nn_ref():
    return _load("nn_ref.npz")


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("tag,activate", [("mlp", True), ("mlp_noact", False)])
def test_nn_mlp(nn_ref, tag, activate):
    from vlgae_tpu_torch.models.nn import MLP

    d = _sub(nn_ref, tag)
    m = MLP(12, 8, activate=activate).eval()
    _set_linear(m.linear, d, "param/linear")
    np.testing.assert_allclose(_np(m(d["in/x"])), d["out/y"].numpy(), rtol=1e-5, atol=1e-6)


def test_nn_res_layer(nn_ref):
    from vlgae_tpu_torch.models.nn import ResLayer

    d = _sub(nn_ref, "res_layer")
    m = ResLayer(10)
    _set_linear(m.linear1, d, "param/linear.0")
    _set_linear(m.linear2, d, "param/linear.2")
    np.testing.assert_allclose(_np(m(d["in/x"])), d["out/y"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tag,n_bottleneck,n_mid", [("skip_enc", 0, 0),
                                                    ("skip_enc_bn", 4, 12)])
def test_nn_dmv_skip_connect_encoder(nn_ref, tag, n_bottleneck, n_mid):
    from vlgae_tpu_torch.models.nn import DMVSkipConnectEncoder

    d = _sub(nn_ref, tag)
    m = DMVSkipConnectEncoder(16, n_bottleneck, n_mid).eval()
    for name in ("HASCHILD", "NOCHILD", "LEFT", "RIGHT"):
        if n_bottleneck == 0:
            _set_linear(getattr(m, name), d, f"param/{name}_linear")
        else:
            for i in (0, 1):
                _set_linear(getattr(m, name)[i], d, f"param/{name}_linear.{i}")
    _set_linear(m.valence, d, "param/valence_linear")
    _set_linear(m.direction, d, "param/direction_linear")
    _set_linear(m.mid1, d, "param/linear1")
    _set_linear(m.mid2, d, "param/linear2")
    # the reference stacks [no_child, has_child] on the valence axis, the
    # port [has_child, no_child] (HASCHILD = 0 in its DP): a flipped axis
    np.testing.assert_allclose(_np(m(d["in/x"])), d["out/y"].numpy()[..., ::-1, :],
                               rtol=1e-5, atol=1e-6)


def test_nn_factorized_bilinear(nn_ref):
    from vlgae_tpu_torch.models.nn import DMVFactorizedBilinear

    d = _sub(nn_ref, "fact_bilinear")
    m = DMVFactorizedBilinear(16, 4)
    _set_linear(m.project1, d, "param/project1")
    _set_linear(m.project2, d, "param/project2")
    want = d["out/y"].numpy()
    np.testing.assert_allclose(_np(m(d["in/x1"], d["in/x2"])), want, rtol=1e-5, atol=1e-6)
    got_tl = _np(m(d["in/x1"], d["in/x2"], tokens_last=True))
    np.testing.assert_allclose(np.moveaxis(got_tl, -1, 2), want, rtol=1e-5, atol=1e-6)


def test_nn_biaffine(nn_ref):
    from vlgae_tpu_torch.models.nn import Biaffine

    d = _sub(nn_ref, "biaffine")
    m = Biaffine(7, 7, n_out=2)
    with torch.no_grad():
        m.weight.copy_(d["param/weight"])
    np.testing.assert_allclose(_np(m(d["in/x"], d["in/y"])), d["out/s"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_nn_biaffine_scorer(nn_ref):
    from vlgae_tpu_torch.models.nn import BiaffineScorer

    d = _sub(nn_ref, "biaffine_scorer")
    m = BiaffineScorer(12, hidden_dim=8, out_dim=2).eval()
    _set_linear(m.mlp1.linear, d, "param/mlp1.linear")
    _set_linear(m.mlp2.linear, d, "param/mlp2.linear")
    with torch.no_grad():
        m.affine.weight.copy_(d["param/affine.weight"])
    np.testing.assert_allclose(_np(m(d["in/x"], d["in/y"])), d["out/s"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_nn_scalar_mix(nn_ref):
    from vlgae_tpu_torch.models.nn import ScalarMix

    d = _sub(nn_ref, "scalar_mix")
    m = ScalarMix(3).eval()
    with torch.no_grad():
        m.weights.copy_(d["param/weights"])
        m.gamma.copy_(d["param/gamma"])
    got = m([d[f"in/t{i}"] for i in range(3)])
    np.testing.assert_allclose(_np(got), d["out/y"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_nn_multivariate_kl(nn_ref, reduction):
    from vlgae_tpu_torch.models.nn import multivariate_kl

    d = _sub(nn_ref, "mkl")
    got = multivariate_kl(d["in/mu1"], d["in/mu2"], d["in/lv1"], d["in/lv2"], reduction)
    np.testing.assert_allclose(_np(got), nn_ref[f"mkl_{reduction}/out/kl"], rtol=1e-5)


def test_nn_vis_box_rel_encoder(nn_ref):
    """The port factorizes the pairwise-mean relation MLP (the linear layer
    distributes over the mean), as vlgae_tpu does; the image group
    (``use_img``) is ``img_fc`` over the mean box feature."""
    from vlgae_tpu_torch.models.vis_encoder import VisBoxRelSimpleEncoder

    d = _sub(nn_ref, "vis_box_rel")
    m = VisBoxRelSimpleEncoder(16, 8, use_attr=True, use_img=True, img_feat=True).eval()
    _set_linear(m.box_fc.linear, d, "param/box_fc.linear")
    _set_linear(m.attr_fc.linear, d, "param/attr_fc.linear")
    _set_linear(m.img_fc.linear, d, "param/img_fc.linear")
    with torch.no_grad():
        m.rel_fc.weight.copy_(d["param/rel_fc.linear.weight"])
        m.rel_fc_bias.copy_(d["param/rel_fc.linear.bias"])
    got = m({"vis_box_feat": d["in/feat"]})
    for key in ("box", "rel", "attr", "img"):
        np.testing.assert_allclose(_np(got[key]), d[f"out/{key}"].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def _set_lstm(enc, d, prefix):
    """The reference's ``LSTMCell`` weights (gates i, f, g, o; two biases
    that add) into the port's flax-named gate projections."""
    with torch.no_grad():
        for i in range(enc.num_layers):
            for side, ref_side in (("fwd", "f_cells"), ("bwd", "b_cells")):
                gates = getattr(enc, f"{side}_{i}").cell.OptimizedLSTMCell_0
                key = f"{prefix}{ref_side}.{i}"
                w_ih, w_hh = d[f"{key}.weight_ih"], d[f"{key}.weight_hh"]
                b = d[f"{key}.bias_ih"] + d[f"{key}.bias_hh"]
                H = w_hh.shape[1]
                for g, gate in enumerate("ifgo"):
                    sl = slice(g * H, (g + 1) * H)
                    getattr(gates, f"i{gate}").weight.copy_(w_ih[sl])
                    getattr(gates, f"h{gate}").weight.copy_(w_hh[sl])
                    getattr(gates, f"h{gate}").bias.copy_(b[sl])


def test_nn_variational_lstm(nn_ref):
    from vlgae_tpu_torch.models.text_encoder import RNNEncoder

    d = _sub(nn_ref, "vlstm")
    x, lengths = d["in/x"], d["in/lengths"]
    enc = RNNEncoder(5, hidden_size=4, num_layers=2, lstm_dropout=0.0).eval()
    _set_lstm(enc, d, "param/")
    mask = torch.arange(x.shape[1])[None] < lengths[:, None]
    np.testing.assert_allclose(_np(enc(x, mask)["x"]), d["out/y"].numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# model_ref.npz: the reference's composed DiscriminativeNDMV and
# DependencyBoxRel (tolerances of tests/test_model_golden.py; mask fills
# differ by convention, so values both below a threshold count as equal)
# ---------------------------------------------------------------------------

def masked_close(got, want, rtol=1e-5, atol=1e-5, msg="", thresh=-1e8):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    both = (got < thresh) & (want < thresh)
    np.testing.assert_allclose(np.where(both, 0.0, got), np.where(both, 0.0, want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def model_ref():
    return _load("model_ref.npz")


def _ldndmv(d, extended_valence=True, strict_pad_context=False, n_enc=12):
    """The golden's DiscriminativeNDMV with its weights. The reference's
    valence branches cross-map: its NOCHILD_linear fills the HASCHILD slot
    (valence 0) of the port's stacking, and the other way round."""
    from vlgae_tpu_torch.models.embedding import CompositeEmbedding, EmbeddingItemCfg
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV, LDNDMVConfig

    t = {k: torch.from_numpy(v) for k, v in d.items() if v.dtype.kind in "fiub"}
    emb = CompositeEmbedding(items=(
        EmbeddingItemCfg("word_embedding", "word", "static", n_vocab=9, embedding_dim=8),
        EmbeddingItemCfg("tag_embedding", "tag", "static", n_vocab=6, embedding_dim=4)))
    cfg = LDNDMVConfig(context_mode="mean", hidden_size=16, attach_rank=3, dec_rank=3,
                       root_rank=3, root_emb_dim=6, dec_emb_dim=5, ff_dropout=0.0,
                       extended_valence=extended_valence, function_mask=True,
                       strict_pad_context=strict_pad_context)
    model = DiscriminativeNDMV(
        cfg, emb, None, n_enc,
        token2word=tuple(int(i) for i in d["in/token2word"]),
        token2tag=tuple(int(i) for i in d["in/token2tag"]),
        function_mask_ids=tuple(int(i) for i in d["ldndmv/in/function_mask"])).eval()
    p = "ldndmv/param/"
    with torch.no_grad():
        emb.word_embedding.embedding.copy_(t["in/word_table"])
        emb.tag_embedding.embedding.copy_(t["in/tag_table"])
        model.root_emb.copy_(t[p + "root_emb"])
        model.dec_emb.copy_(t[p + "dec_emb"])
    for name in ("head_ff", "child_ff", "root_ff", "dec_ff"):
        _set_linear(getattr(model, name).linear, t, p + f"{name}.linear")
    for port, ref in (("HASCHILD", "NOCHILD_linear"), ("NOCHILD", "HASCHILD_linear"),
                      ("LEFT", "LEFT_linear"), ("RIGHT", "RIGHT_linear"),
                      ("valence", "valence_linear"), ("direction", "direction_linear"),
                      ("mid1", "linear1"), ("mid2", "linear2")):
        _set_linear(getattr(model.mid_ff, port), t, p + f"mid_ff.{ref}")
    for name in ("attach_scorer", "dec_scorer", "root_scorer"):
        for proj in ("project1", "project2"):
            _set_linear(getattr(getattr(model, name), proj), t, p + f"{name}.{proj}")
    return model, t


def _ldndmv_inputs(t, seq_len=None):
    return {"token": t["in/tokens"].long(), "tag": t["in/tags"].long(),
            "word": t["in/token2word"][t["in/tokens"].long()].long(),
            "seq_len": (t["in/seq_len"] if seq_len is None else seq_len).int()}


@pytest.mark.parametrize("tag,extended", [("ldndmv", True), ("ldndmv_nev", False)])
def test_model_ldndmv_forward(model_ref, tag, extended):
    model, t = _ldndmv(model_ref, extended)
    with torch.no_grad():
        out = model(_ldndmv_inputs(t), encoded={"x": t["in/x_enc"]})
    np.testing.assert_allclose(_np(out["emb"]), model_ref["in/emb"], rtol=1e-6, atol=1e-7)
    masked_close(_np(out["attach"]), model_ref[f"{tag}/out/attach"], msg="attach")
    for key in ("dec", "root", "root_rule", "attach_rule"):
        np.testing.assert_allclose(_np(out[key]), model_ref[f"{tag}/out/{key}"],
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    for key in ("merged_dec", "merged_attach"):
        masked_close(_np(out[key]), model_ref[f"{tag}/out/{key}"], msg=key)


def test_model_ldndmv_ragged_strict_context(model_ref):
    """On a ragged batch the reference's sentence context is the unmasked
    mean over padding; ``strict_pad_context`` reproduces its tables."""
    lengths = torch.from_numpy(model_ref["ldndmv_ragged/in/lengths"])
    model, t = _ldndmv(model_ref, True, strict_pad_context=True)
    with torch.no_grad():
        out = model(_ldndmv_inputs(t, lengths), encoded={"x": t["in/x_enc"]})
    for key in ("attach", "dec", "root", "merged_dec", "merged_attach"):
        masked_close(_np(out[key]), model_ref[f"ldndmv_ragged/out/{key}"], msg=key)


def test_model_generate_rule_1o(model_ref):
    from vlgae_tpu_torch.models.dmv_init import generate_rule_1o

    ci = 0
    while f"rule1o_{ci}/in/heads" in model_ref:
        heads = [int(h) for h in model_ref[f"rule1o_{ci}/in/heads"]]
        got = generate_rule_1o(heads)
        for key in ("dec_rule", "attach_rule", "root_rule"):
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          model_ref[f"rule1o_{ci}/out/{key}"],
                                          err_msg=f"case {ci} {key}")
        ci += 1
    assert ci >= 5


def test_model_rnn_last_and_hx_context(model_ref):
    """The BiLSTM's last layer (``output_layers=-1``) and its final states
    (the reference's ``hx[-2:]``), and ``context_mode='hx'`` built from
    them."""
    from vlgae_tpu_torch.models.embedding import CompositeEmbedding, EmbeddingItemCfg
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV, LDNDMVConfig
    from vlgae_tpu_torch.models.text_encoder import RNNEncoder

    d = _sub(model_ref, "rnn_last")
    x, lengths = torch.from_numpy(model_ref["rnn/in/x"]), torch.from_numpy(
        model_ref["rnn/in/lengths"])
    mask = torch.arange(x.shape[1])[None] < lengths[:, None]
    enc = RNNEncoder(12, hidden_size=4, num_layers=2, lstm_dropout=0.0,
                     init_version="biased").eval()
    _set_lstm(enc, d, "param/lstm.")
    got = enc(x, mask)
    np.testing.assert_allclose(_np(got["x"]), d["out/x"].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got["hiddens"]), d["out/hiddens"].numpy()[-2:],
                               rtol=1e-4, atol=1e-5)
    emb = CompositeEmbedding(items=(
        EmbeddingItemCfg("word_embedding", "word", "static", n_vocab=9, embedding_dim=8),))
    dep = DiscriminativeNDMV(LDNDMVConfig(context_mode="hx", hidden_size=16,
                                          ff_dropout=0.0), emb, None, 8, token2word=(0,))
    ctx, kl = dep.extract_sent_repr({"x": d["out/x"], "hiddens": d["out/hiddens"][-2:]},
                                    mask)
    assert kl is None
    np.testing.assert_allclose(_np(ctx), d["out/hx_context"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tag,kw", [("rnn_concat", dict(output_layers=-2)),
                                    ("rnn_mix", dict(output_layers=-2, mix=True))])
def test_model_rnn_concat_and_mix(model_ref, tag, kw):
    """``output_layers=-2``: both layers' outputs concatenated, or their
    ScalarMix; the final states stay the last layer's."""
    from vlgae_tpu_torch.models.text_encoder import RNNEncoder

    d = _sub(model_ref, tag)
    x, lengths = torch.from_numpy(model_ref["rnn/in/x"]), torch.from_numpy(
        model_ref["rnn/in/lengths"])
    mask = torch.arange(x.shape[1])[None] < lengths[:, None]
    enc = RNNEncoder(12, hidden_size=4, num_layers=2, lstm_dropout=0.0,
                     init_version="biased", **kw).eval()
    _set_lstm(enc, d, "param/lstm.")
    if kw.get("mix"):
        with torch.no_grad():
            enc.ScalarMix_0.weights.copy_(d["param/mix.weights"])
            enc.ScalarMix_0.gamma.copy_(d["param/mix.gamma"])
    got = enc(x, mask)
    assert got["x"].shape[-1] == enc.n_hidden
    np.testing.assert_allclose(_np(got["x"]), d["out/x"].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got["hiddens"]), d["out/hiddens"].numpy()[-2:],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tag,mode", [("ldndmv_vae", "all:vae"), ("ldndmv_ib", "all:ib")])
def test_model_variational_context(model_ref, tag, mode):
    """The variational sentence context at eval: the posterior mean of the
    mean context, and the VAE's / the bottleneck's KL."""
    from vlgae_tpu_torch.models.embedding import CompositeEmbedding, EmbeddingItemCfg
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV, LDNDMVConfig

    d = _sub(model_ref, tag)
    x = torch.from_numpy(model_ref["in/x_enc"])
    B, L, n_enc = x.shape
    emb = CompositeEmbedding(items=(
        EmbeddingItemCfg("word_embedding", "word", "static", n_vocab=9, embedding_dim=8),))
    dep = DiscriminativeNDMV(LDNDMVConfig(context_mode="mean", variational_mode=mode,
                                          z_dim=3, hidden_size=16, ff_dropout=0.0),
                             emb, None, n_enc, token2word=(0,)).eval()
    _set_linear(dep.variational_enc, d, "param/variational_enc")
    if mode.endswith("ib"):
        with torch.no_grad():
            dep.target_mean.copy_(d["param/target_mean"])
            dep.target_lvar.copy_(d["param/target_lvar"])
    ctx, kl = dep.extract_sent_repr({"x": x}, torch.ones(B, L, dtype=torch.bool))
    np.testing.assert_allclose(_np(ctx), d["out/context"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(kl), d["out/kl"].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("vmode", ["vae", "ib"])
def test_model_variational_embedding_adaptor(model_ref, vmode):
    """The variational embedding item at eval: ``z`` the posterior mean, and
    its VAE / bottleneck KL."""
    from vlgae_tpu_torch.models.embedding import EmbeddingItemCfg, StaticItem

    d = _sub(model_ref, f"embvar_{vmode}")
    item = StaticItem(EmbeddingItemCfg("w", "word", "static", n_vocab=9, embedding_dim=8,
                                       mode=vmode, out_dim=3)).eval()
    with torch.no_grad():
        item.embedding.copy_(d["param/emb.weight"])
        if vmode == "ib":
            item.target_mean.copy_(d["param/target_mean"])
            item.target_lvar.copy_(d["param/target_lvar"])
    _set_linear(item.enc, d, "param/enc")
    words = torch.from_numpy(model_ref["in/token2word"][model_ref["in/tokens"]]).long()
    z, kl = item.embed(words)
    np.testing.assert_allclose(_np(z), d["out/z"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(kl), d["out/kl"].numpy(), rtol=1e-4, atol=1e-5)


def test_model_embedding_normalize(model_ref):
    """Re-whitening: the count-weighted scalar branch and the per-dimension
    branch (Bessel-corrected, padding row 0 kept), all three methods."""
    from vlgae_tpu_torch.models.embedding import normalize_embedding_

    table = torch.from_numpy(model_ref["embnorm/in/table"])
    counts = model_ref["embnorm/in/counts"]
    for method in ("mean", "std", "mean+std"):
        key = method.replace("+", "_")
        got = table.clone()
        normalize_embedding_(got, method, counts)
        np.testing.assert_allclose(_np(got), model_ref[f"embnorm/out/counted_{key}"],
                                   rtol=1e-5, atol=1e-6, err_msg=f"counted {method}")
        got = table.clone()
        normalize_embedding_(got, method)
        np.testing.assert_allclose(_np(got), model_ref[f"embnorm/out/perdim_{key}"],
                                   rtol=1e-4, atol=1e-6, err_msg=f"perdim {method}")


def test_model_classic_dmv_em(model_ref):
    """The classic tabular DMV: the gathers, the marginal NLL and one EM
    cycle (E-step counts, M-step normalisation)."""
    from vlgae_tpu_torch.models import dmv_model

    params = {"root_param": torch.from_numpy(model_ref["dmv/param/root"]),
              "trans_param": torch.from_numpy(model_ref["dmv/param/trans"]),
              "dec_param": torch.from_numpy(model_ref["dmv/param/dec"])}
    token = torch.from_numpy(model_ref["dmv/in/tokens"]).long()
    lengths = torch.from_numpy(model_ref["dmv/in/lengths"]).int()
    mdec, mattach = dmv_model.forward(params, token)
    masked_close(_np(mdec), model_ref["dmv/out/merged_dec"], msg="merged_dec")
    masked_close(_np(mattach), model_ref["dmv/out/merged_attach"], msg="merged_attach")
    nll, _ = dmv_model.loss(params, token, lengths, viterbi=False)
    np.testing.assert_allclose(_np(nll), model_ref["dmv/out/nll"], rtol=1e-5)
    em = dmv_model.EMAccumulator(smooth=0.1)
    em.accumulate(dmv_model.expected_counts(params, token, lengths))
    new = em.apply(params)
    for key, ref_key in (("root_param", "em_root"), ("dec_param", "em_dec"),
                         ("trans_param", "em_trans")):
        np.testing.assert_allclose(_np(new[key]), model_ref[f"dmv/out/{ref_key}"],
                                   rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def joint(model_ref):
    """(model_simple, model_reduced, inputs, vis_encoded, mask, tensors): the
    golden's DependencyBoxRel (no image group, match width 8, POS priors as
    the generator's tag groups) with its weights, in eval mode; the
    reduced-map twin shares every module."""
    from vlgae_tpu_torch.models.joint import DependencyBoxRel, DependencyBoxRelConfig

    dep, t = _ldndmv(model_ref, True)
    kw = dict(add_rel=True, add_attr=True, add_image=False, add_marginal=True,
              language_factor_mode="word+maxdep", match_hidden=8,
              feat_fuse_mode="attention", fuse_aug_with_matching=True,
              loss_grounding_mode="factor|ce", loss_use_pos_prior=True, loss_vis2txt=1.0,
              word_encoder_dropout=0.0, bf16_matmul=False, compact_rel_train=False,
              grounding_interpolation=0.3)
    pos = dict(pos_for_obj=(0, 1), pos_for_rel=(2,), pos_for_attr=(4,))
    model = DependencyBoxRel(DependencyBoxRelConfig(gather_logit_mode="simple", **kw),
                             dep.cfg, dep, None, 12, 12, **pos).eval()
    p = "joint/param/"
    for name in ("word_encoder", "child_encoder", "parent_encoder"):
        _set_linear(getattr(model, name).linear, t, p + f"{name}.linear")
    with torch.no_grad():
        for name in ("arc_encoder_w1", "arc_encoder_w2", "arc_encoder_b"):
            getattr(model, name).copy_(t[p + name])
        model.vis_mlp_pre_matching.weight.copy_(t[p + "vis_mlp_pre_matching.weight"])
        model.feat_layernorm.weight.copy_(t[p + "feat_layernorm.weight"])
        model.feat_layernorm.bias.copy_(t[p + "feat_layernorm.bias"])
    red = DependencyBoxRel(DependencyBoxRelConfig(
        gather_logit_mode="reduced", decode_grounding_mode="on_img", **kw),
        dep.cfg, dep, None, 12, 12, **pos).eval()
    red.load_state_dict(model.state_dict())
    inputs = _ldndmv_inputs(t)
    B = inputs["token"].shape[0]
    inputs.update({"vis_box_mask": t["joint/in/box_mask"].bool(),
                   "vis_available": torch.ones(B, dtype=torch.bool)})
    vis_encoded = {"box": t["joint/in/box_feat"], "rel": t["joint/in/rel_feat"],
                   "attr": t["joint/in/attr_feat"]}
    L = inputs["token"].shape[1]
    mask = torch.arange(L)[None] < inputs["seq_len"][:, None]
    return model, red, inputs, vis_encoded, mask, t


def _lang_score(t):
    return {"merged_dec": t["ldndmv/out/merged_dec"],
            "merged_attach": t["ldndmv/out/merged_attach"]}


def test_model_joint_vis_feat(model_ref, joint):
    model, _, inputs, vis_encoded, _, _ = joint
    with torch.no_grad():
        vis = model.vis_feat(inputs, vis_encoded)
    np.testing.assert_allclose(_np(vis[0]), model_ref["joint/out/vis_feat"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(vis[1]), model_ref["joint/out/vis_mask"])
    np.testing.assert_array_equal(np.asarray(vis[2]), model_ref["joint/out/vis_split"])


def test_model_joint_lang_feat_word(model_ref, joint):
    model, _, inputs, _, mask, t = joint
    with torch.no_grad():
        txt = model.lang_feat_word_only(inputs, {"x": t["in/x_enc"]}, None, mask)
    np.testing.assert_allclose(_np(txt[0]), model_ref["joint/out/word_repr"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(txt[1]), model_ref["joint/out/word_mask"])
    np.testing.assert_array_equal(_np(txt[2]), model_ref["joint/out/word_marginal"])
    assert txt[3] is None


def test_model_joint_lang_feat_max_tree(model_ref, joint):
    """Viterbi heads -> the reversed-arc marginal gather -> the root-mean
    prepend -> the arc bilinear -> [word; arc] packing."""
    model, _, inputs, _, mask, t = joint
    with torch.no_grad():
        txt = model.lang_feat_max_tree(inputs, {"x": t["in/x_enc"]}, _lang_score(t), mask)
    np.testing.assert_array_equal(_np(txt[1]), model_ref["joint/out/maxdep_mask"])
    np.testing.assert_allclose(_np(txt[2]), model_ref["joint/out/maxdep_marginal"],
                               rtol=1e-4, atol=1e-5, err_msg="txt_marginal")
    np.testing.assert_allclose(_np(txt[0]), model_ref["joint/out/maxdep_txt"],
                               rtol=1e-4, atol=1e-5, err_msg="txt factors")


def _vis_and_word(joint):
    model, _, inputs, vis_encoded, mask, t = joint
    vis = model.vis_feat(inputs, vis_encoded)
    return vis, model.lang_feat_word_only(inputs, {"x": t["in/x_enc"]}, None, mask)


def _matched(model, vis, txt):
    """The matching entries of the forward under ``simple`` + factor CE:
    the reduced maxes of :meth:`gather_logit_train`."""
    reduced = model.gather_logit_train(vis, txt)
    return {"match_reduced": reduced, "match_logit": reduced[0], "vis_packed": vis,
            "txt_packed": txt}


def test_model_joint_gather_logit(model_ref, joint):
    """The reference's full map against its own einsum of the port's
    factors; the port's reduced maxes against its maxes over factors and
    over words; the caption logits of ``reduced``."""
    model, red = joint[:2]
    attmap = model_ref["joint/out/attmap"]
    with torch.no_grad():
        vis, txt = _vis_and_word(joint)
        full = torch.einsum("avd,bqd->baqv", vis[0], txt[0])
        full = torch.where(vis[1][None, :, None, :] & txt[1][:, None, :, None], full, -1e9)
        masked_close(_np(full), attmap, rtol=1e-4, atol=1e-5, msg="attmap")
        logit, logit_v = model.gather_logit_train(vis, txt)
        masked_close(_np(logit), attmap.max(-1), rtol=1e-4, atol=1e-5, msg="max over v")
        masked_close(_np(logit_v), attmap.max(-2), rtol=1e-4, atol=1e-5, msg="max over q")
        np.testing.assert_allclose(_np(red.gather_logit(vis, txt)),
                                   model_ref["joint/out/logit_reduced"], rtol=1e-4, atol=1e-5)


def test_model_joint_factor_ce_loss_grads(model_ref, joint):
    """The self-normalised value is degenerate; the chain is pinned
    through the input gradients."""
    model, _, inputs, _, mask, t = joint
    loss_inputs = {"tag": inputs["tag"], "seq_len": inputs["seq_len"]}
    args = [t["joint/in/box_feat"].clone().requires_grad_(),
            t["joint/in/rel_feat"].clone().requires_grad_(),
            t["joint/in/attr_feat"].clone().requires_grad_(),
            t["in/x_enc"].clone().requires_grad_()]
    box, rel, attr, x = args
    vis = model.vis_feat(inputs, {"box": box, "rel": rel, "attr": attr})
    txt = model.lang_feat_word_only(inputs, {"x": x}, None, mask)
    loss, _ = model.loss_grounding_factor_ce(_matched(model, vis, txt), loss_inputs)
    np.testing.assert_allclose(_np(loss), model_ref["joint/out/factor_ce_loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, args)
    for got, key in zip(grads, ("box", "rel", "attr", "x")):
        np.testing.assert_allclose(_np(got), model_ref[f"joint/out/factor_ce_grad_{key}"],
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_model_joint_cap_img_loss(model_ref, joint):
    red, inputs = joint[1], joint[2]
    with torch.no_grad():
        vis, txt = _vis_and_word(joint)
        loss, aux = red.loss_grounding_cap_img({"match_logit": red.gather_logit(vis, txt)},
                                               inputs)
    np.testing.assert_allclose(_np(loss), model_ref["joint/out/cap_img_loss"], rtol=1e-5)
    assert sorted(aux) == ["mt"]


def test_model_joint_fusion(model_ref, joint):
    model, _, inputs, vis_encoded, mask, t = joint
    with torch.no_grad():
        fused = model.fuse_with_matching(inputs, vis_encoded, {"x": t["in/x_enc"]}, mask)
    np.testing.assert_allclose(_np(fused["x"]), model_ref["joint/out/fused_x"],
                               rtol=1e-4, atol=1e-5)


def test_model_joint_decode_grounding(model_ref, joint):
    """on_factor: the edited decode logits, the top-5 values at every rank
    and the indices wherever a rank's value is unique in its row (the
    -1e10 edits collapse onto exact f32 plateaus), the index formatter on
    the reference's own indices, each word's image; on_img: the best image
    of each caption."""
    import json

    model, red, inputs, vis_encoded, mask, t = joint
    with torch.no_grad():
        vis = model.vis_feat(inputs, vis_encoded)
        txt = model.lang_feat_max_tree(inputs, {"x": t["in/x_enc"]}, _lang_score(t), mask)
        out = _matched(model, vis, txt)
        masked_close(_np(out["match_logit"]), model_ref["joint/out/attmap_maxdep"].max(-1),
                     rtol=1e-4, atol=1e-5, msg="attmap_maxdep")
        dec = model.decode_grounding_device(out, inputs)
        our_logit = model.decode_grounding_logits(out, inputs)
    ref_logit = model_ref["joint/out/decode_logit"]
    masked_close(_np(our_logit), ref_logit, rtol=1e-4, atol=1e-4, thresh=-1e19,
                 msg="decode logits")
    ref_idx = model_ref["joint/out/decode_top5_idx"]
    got_idx = _np(dec["txt_to_factor_idx"])
    ref_vals = np.take_along_axis(ref_logit, ref_idx, axis=-1)
    got_vals = np.take_along_axis(ref_logit, got_idx, axis=-1)
    np.testing.assert_allclose(got_vals, ref_vals, rtol=1e-4, err_msg="top-5 values")
    B, Q, K = got_idx.shape
    for b in range(B):
        for q in range(Q):
            for k in range(K):
                if np.isclose(ref_logit[b, q], ref_vals[b, q, k], rtol=1e-3).sum() == 1:
                    assert got_idx[b, q, k] == ref_idx[b, q, k], (b, q, k)
    got_factor = model.format_grounding(ref_idx, vis[2], _np(inputs["seq_len"]),
                                        model_ref["joint/in/box_index"], _np(txt[1]))
    want_factor = json.loads(str(model_ref["joint/out/decode_factor_json"]))
    assert json.loads(json.dumps(got_factor)) == want_factor
    got_img = [[int(v) for v, m in zip(row, mrow) if m]
               for row, mrow in zip(_np(dec["txt_to_img"]), _np(txt[1]))]
    assert got_img == json.loads(str(model_ref["joint/out/decode_img_json"]))
    with torch.no_grad():
        vis, txt_w = _vis_and_word(joint)
        on_img = red.decode_grounding_device(
            {"match_logit": red.gather_logit(vis, txt_w), "vis_packed": vis}, inputs)
    assert sorted(on_img) == ["txt_to_img"]
    np.testing.assert_array_equal(_np(on_img["txt_to_img"]),
                                  model_ref["joint/out/decode_on_img"])


@pytest.mark.parametrize("mode", ["on_factor", "on_img"])
def test_model_prediction_writer(model_ref, tmp_path, mode):
    """``Pipeline.write_predictions`` on the reference's decode output: its
    full prediction text byte for byte (on_factor), and the ``X\\tX``
    placeholder in every ALIGN column under on_img."""
    import json
    import types

    from vlgae_tpu_torch.training.pipeline import Pipeline

    factors = json.loads(str(model_ref["joint/out/decode_factor_json"]))
    B, L = model_ref["in/tokens"].shape
    insts = [{"id": b, "seq_len": int(model_ref["in/seq_len"][b]),
              "raw_word": [f"w{b}{i}" for i in range(L)],
              "tag": [f"TAG{t}" for t in model_ref["in/tags"][b]]} for b in range(B)]
    outputs = {b: {"arc": [int(h) for h in model_ref["joint/in/pred_heads"][b]]}
               for b in range(B)}
    if mode == "on_factor":
        for b in range(B):
            outputs[b]["txt_to_factor"] = [
                [(k, tuple(x) if isinstance(x, list) else x) for k, x in row]
                for row in factors[b]]
    fake = types.SimpleNamespace(
        dm=types.SimpleNamespace(datasets={"dev": insts}), is_joint=True,
        model=types.SimpleNamespace(cfg=types.SimpleNamespace(
            decode_grounding_mode=mode, language_factor_mode="word+maxdep")),
        _format_factor=Pipeline._format_factor)
    path = tmp_path / "dev.conll"
    Pipeline.write_predictions(fake, str(path), "dev", outputs)
    got = path.read_text()
    if mode == "on_factor":
        assert got == str(model_ref["joint/out/predict_text"])
    else:
        rows = [r for r in got.split("\n") if r]
        assert len(rows) == int(model_ref["in/seq_len"].sum())
        assert all(r.split("\t")[4:] == ["X", "X"] for r in rows)


# ---------------------------------------------------------------------------
# trajectory_ref.npz: 10 steps of the reference's optimizer stack (torch
# Adam, eps 1e-12; exponential, linear-warmup and plateau schedules; regex
# groups) on a tiny regression, through the port's ``Optimizer``; losses
# 2e-4 relative, learning rates 1e-6 relative, final params 2e-5 absolute
# (tests/test_trajectory_golden.py)
# ---------------------------------------------------------------------------

OPT_ARGS = {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.0, "eps": 1e-12}
TRAJECTORIES = {
    "plain": (None, None, None),
    "exp": ({"interval": "step", "frequency": 1, "args": {
        "_target_": "src.utility.scheduler.get_exponential_lr_scheduler",
        "gamma": "0.75**(1/20)"}}, None, None),
    "groups": (None, [{"pattern": "dependency.embedding.transformer", "lr": 1e-5}], None),
    "warmup": ({"interval": "step", "frequency": 1, "args": {
        "_target_": "transformers.get_linear_schedule_with_warmup",
        "num_warmup_steps": "2 epoch", "num_training_steps": "10 epoch"}}, None, None),
    "plateau": ({"interval": "epoch", "frequency": 1, "args": {
        "_target_": "torch.optim.lr_scheduler.ReduceLROnPlateau",
        "mode": "min", "factor": 0.5, "patience": 1}}, None, [5.0] * 5),
}


class _Regression(torch.nn.Module):
    """``tanh(x W1 + b1) W2 + b2`` with the golden's parameter names."""

    def __init__(self, ref):
        super().__init__()
        self.dependency = torch.nn.Module()
        self.dependency.embedding = torch.nn.Module()
        self.dependency.embedding.transformer = torch.nn.Linear(4, 8)
        self.head = torch.nn.Linear(8, 1)
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.from_numpy(ref[f"init.{name}"]))

    def forward(self, x):
        return self.head(torch.tanh(self.dependency.embedding.transformer(x)))


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_trajectory_matches_reference(name):
    from vlgae_tpu_torch.training.optim import Optimizer

    ref = _load("trajectory_ref.npz")
    sched, groups, monitor = TRAJECTORIES[name]
    model = _Regression(ref)
    opt_cfg = {"args": dict(OPT_ARGS)}
    if groups:
        opt_cfg["groups"] = groups
    opt = Optimizer(model, opt_cfg, sched, steps_per_epoch=int(ref["n_batches"]))
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"])
    losses, lrs = [], []
    for step in range(int(ref["steps"])):
        lrs.append(opt.lr_at(step))
        loss = ((model(x) - y) ** 2).mean()
        losses.append(float(loss.detach()))
        loss.backward()
        opt.step(step)
        opt.zero_grad()
        if monitor is not None and (step + 1) % 2 == 0:  # an epoch is 2 steps
            opt.plateau.step(monitor[(step + 1) // 2 - 1], opt.base_lr)
    np.testing.assert_allclose(losses, ref[f"{name}.losses"], rtol=2e-4)
    if name != "groups":  # its column records the 1e-5 group's rate
        np.testing.assert_allclose(lrs, ref[f"{name}.lrs"], rtol=1e-6)
    for pname, p in model.named_parameters():
        if pname.endswith("weight"):
            np.testing.assert_allclose(_np(p), ref[f"{name}.final.{pname}"], atol=2e-5,
                                       err_msg=pname)
