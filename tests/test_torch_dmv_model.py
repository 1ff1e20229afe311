"""The port's classic tabular DMV (vlgae_tpu_torch.models.dmv_model and the
initialisers of models/dmv_init.py) against vlgae_tpu.

The initialisers are host NumPy copies: tables equal. The gathered
potentials are equal; log-likelihoods and E-step counts within 1e-5
(absolute and relative: f32 DP sums in other orders); two EM epochs of the
flow of tests/test_e2e.py::test_classic_dmv_e2e on the synthetic corpus
give tables within 1e-4 of vlgae_tpu's, and dev heads (MBR and Viterbi)
equal where the best tree wins by at least 1e-3 (test_torch_deptree's
``tree_margins``), and the same UAS. MBR heads form projective trees
everywhere. Viterbi heads do where the tree wins by the margin: on an exact
tie (repeated tags, as "4 4 4") the argmax over a column that the tie
splits or doubly marks can pick arcs of two best trees, a non-tree, in
vlgae_tpu as in the port.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_data
from test_torch_deptree import MARGIN, assert_trees, eisner_margins, tree_margins
from vlgae_tpu.models import dmv_init as jinit
from vlgae_tpu.models import dmv_model as J
from vlgae_tpu_torch.models import dmv_init
from vlgae_tpu_torch.models import dmv_model as T
from vlgae_tpu_torch.struct import NEGINF, DMV1o, dmv_total
from vlgae_tpu_torch.struct import distributions as tdist

TOL = 1e-5
EM_TOL = 1e-4


def _tokens(seed=0, B=6, L=7, n_token=8):
    rng = np.random.default_rng(seed)
    token = rng.integers(0, n_token, (B, L))
    lengths = np.array([L, 3, 0, 1, L - 1, 5][:B])
    seqs = [token[b, :n].tolist() for b, n in enumerate(lengths) if n]
    heads = [rng.integers(0, n + 1, n).tolist() for n in lengths if n]
    return token, lengths, seqs, heads, n_token


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def dmv_margins(mdec, mattach, lengths, heads):
    """``tree_margins`` of the DMV on merged potentials (plain version)."""
    rows = torch.arange(mattach.shape[0])

    def without(h, k):
        a = mattach.clone()
        a[rows, torch.as_tensor(np.array(h)).long(), k] = NEGINF
        return dmv_total(mdec, a, lengths, "max").numpy()

    return tree_margins(without, heads, lengths.numpy(),
                        dmv_total(mdec, mattach, lengths, "max"))


@pytest.mark.parametrize("method", ["km", "good", "random"])
def test_init_params_match_jax(method):
    token, lengths, seqs, heads, n = _tokens()
    cfg = dict(init_method=method, n_token=n, smooth=0.1)
    want = _np(J.init_params(J.DMVConfig(**cfg), seqs, heads, seed=3))
    got = T.init_params(T.DMVConfig(**cfg), seqs, heads, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_recovery_valences_match_jax():
    _, _, _, heads, _ = _tokens(seed=1)
    for h in heads:
        for got, want in zip(dmv_init.recovery_valences(h), jinit.recovery_valences(h)):
            np.testing.assert_array_equal(got, want)


def test_init_params_default_to_the_card():
    """Without ``device`` the tables go to the card; with no card the call
    raises instead of building them on the CPU."""
    _, _, seqs, _, n = _tokens()
    cfg = T.DMVConfig(n_token=n)
    if torch.cuda.is_available():
        assert all(v.is_cuda for v in T.init_params(cfg, seqs).values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_params(cfg, seqs)


def test_forward_and_loss_match_jax():
    token, lengths, seqs, _, n = _tokens(seed=2)
    cfg = dict(init_method="km", n_token=n, smooth=0.1)
    jp = J.init_params(J.DMVConfig(**cfg), seqs)
    tp = T.init_params(T.DMVConfig(**cfg), seqs, device="cpu")
    for got, want in zip(T.forward(tp, torch.tensor(token)),
                         J.forward(jp, jnp.asarray(token))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for viterbi in (False, True):
        got, _ = T.loss(tp, torch.tensor(token), torch.tensor(lengths), viterbi)
        want, _ = J.loss(jp, jnp.asarray(token), jnp.asarray(lengths), viterbi)
        np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("viterbi", [False, True])
@pytest.mark.parametrize("method", ["km", "random"])
def test_expected_counts_match_jax(method, viterbi):
    token, lengths, seqs, _, n = _tokens(seed=3)
    cfg = dict(init_method=method, n_token=n, smooth=0.1)
    jp = J.init_params(J.DMVConfig(**cfg), seqs, seed=4)
    tp = T.init_params(T.DMVConfig(**cfg), seqs, seed=4, device="cpu")
    want = J.expected_counts(jp, jnp.asarray(token), jnp.asarray(lengths), viterbi)
    got = T.expected_counts(tp, torch.tensor(token), torch.tensor(lengths), viterbi)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_em_accumulator_matches_jax():
    rng = np.random.default_rng(5)
    shapes = {"root_param": (8,), "trans_param": (8, 8, 2, 2), "dec_param": (8, 2, 2, 2)}
    batches = [{k: rng.random(s).astype(np.float32) * 3 for k, s in shapes.items()}
               for _ in range(3)]
    jem, tem = J.EMAccumulator(0.1), T.EMAccumulator(0.1)
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    assert T.EMAccumulator(0.1).apply(params) is params
    for c in batches:
        jem.accumulate({k: jnp.asarray(v) for k, v in c.items()})
        tem.accumulate({k: torch.tensor(v) for k, v in c.items()})
    want, got = jem.apply(params), tem.apply(params)
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    assert tem.counts is None


def test_the_e_step_and_decodes_take_the_dmv_dispatch(monkeypatch):
    """E-step: the chart-saving pair (``DMVTotalFn``: K3a + K3b on the card);
    MBR decode: one fused pass in log, then one in max on the Eisner
    potentials; Viterbi decode: one fused pass in max (K1 on the card)."""
    calls = []
    real_apply, real_vg = tdist.DMVTotalFn.apply, tdist.dmv_value_and_grads
    monkeypatch.setattr(tdist.DMVTotalFn, "apply",
                        lambda *a: calls.append(("pair", a[3])) or real_apply(*a))
    monkeypatch.setattr(tdist, "dmv_value_and_grads",
                        lambda *a: calls.append(("fused", a[3])) or real_vg(*a))
    token, lengths, seqs, _, n = _tokens(seed=6)
    tp = T.init_params(T.DMVConfig(n_token=n), seqs, device="cpu")
    tok, lens = torch.tensor(token), torch.tensor(lengths)
    T.expected_counts(tp, tok, lens)
    T.expected_counts(tp, tok, lens, viterbi=True)
    assert calls == [("pair", "log"), ("pair", "max")]
    calls.clear()
    T.decode(tp, tok, lens, mbr=True)
    assert calls == [("fused", "log"), ("fused", "max")]
    calls.clear()
    T.decode(tp, tok, lens, mbr=False)
    assert calls == [("fused", "max")]


@pytest.fixture(scope="module")
def em_run(tmp_path_factory):
    """Two EM epochs of test_classic_dmv_e2e's flow in both packages."""
    from vlgae_tpu.data import DepDataModule as JaxDM
    from vlgae_tpu_torch.data.datamodule import DepDataModule

    root = Path(tmp_path_factory.mktemp("classic_dmv"))
    synth_data.make_corpus(root, n_imgs=4, feat_dim=8, n_box=4, len_range=(3, 9))
    kw = dict(train_path=str(root / "train.conll"), dev_path=str(root / "val.conll"),
              test_path=str(root / "test.conll"), num_lex=0,
              **{f"{s}_dataloader": {"batch_size": 16, "num_bucket": 1}
                 for s in ("train", "dev", "test")})
    jdm, tdm = JaxDM(**kw).setup(), DepDataModule(**kw).setup()
    seqs = [[tdm.vocabs["token"][t] for t in inst["token"]]
            for inst in tdm.datasets["train"]]
    n_token = len(tdm.vocabs["token"])
    jp = J.init_params(J.DMVConfig(init_method="km", n_token=n_token, smooth=0.1),
                       token_seqs=seqs)
    tp = T.init_params(T.DMVConfig(init_method="km", n_token=n_token, smooth=0.1),
                       token_seqs=seqs, device="cpu")
    jem, tem = J.EMAccumulator(0.1), T.EMAccumulator(0.1)
    for _ in range(2):
        for (x, _), (tx, _) in zip(jdm.batches("train", shuffle=False),
                                   tdm.batches("train", shuffle=False)):
            jem.accumulate(J.expected_counts(jp, jnp.asarray(x["token"]),
                                             jnp.asarray(x["seq_len"])))
            tem.accumulate(T.expected_counts(tp, torch.as_tensor(tx["token"]),
                                             torch.as_tensor(tx["seq_len"])))
        jp, tp = jem.apply(jp), tem.apply(tp)
    return jdm, tdm, jp, tp


def test_em_epochs_match_jax(em_run):
    _, _, jp, tp = em_run
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=EM_TOL,
                                   atol=EM_TOL, err_msg=k)


@pytest.mark.parametrize("mbr", [True, False])
def test_em_dev_heads_and_uas_match_jax(em_run, mbr):
    from vlgae_tpu.training.metrics import DependencyParsingMetric as JaxMetric
    from vlgae_tpu_torch.training.metrics import DependencyParsingMetric

    jdm, tdm, jp, tp = em_run
    jmetric, tmetric = JaxMetric(), DependencyParsingMetric()
    n_won = n_sent = 0
    for (x, y), (tx, ty) in zip(jdm.batches("dev", shuffle=False),
                                tdm.batches("dev", shuffle=False)):
        tok, lens = torch.as_tensor(tx["token"]), torch.as_tensor(tx["seq_len"])
        want = np.asarray(J.decode(jp, jnp.asarray(x["token"]), jnp.asarray(x["seq_len"]),
                                   mbr=mbr))
        got = T.decode(tp, tok, lens, mbr=mbr).numpy()
        md, ma = T.forward(tp, tok)
        if mbr:
            arc = DMV1o((md, ma), lens).marginals.sum(-1)
            won = eisner_margins(arc.numpy(), tx["seq_len"], want) >= MARGIN
        else:
            won = dmv_margins(md, ma, lens, want) >= MARGIN
        np.testing.assert_array_equal(got[won], want[won])
        keep = slice(None) if mbr else won
        assert_trees(got[keep], tx["seq_len"][keep])
        n_won, n_sent = n_won + int(won.sum()), n_sent + len(won)
        mask = np.arange(x["token"].shape[1])[None, :] < np.asarray(x["seq_len"])[:, None]
        jmetric.update({"arc": want}, {"arc": y["arc"]}, mask)
        tmetric.update({"arc": got}, {"arc": ty["arc"]}, mask)
    assert n_won >= n_sent - 2
    want, got = jmetric.compute(), tmetric.compute()
    assert 0 <= got["uas"] <= 100
    np.testing.assert_allclose(got["uas"], want["uas"], rtol=0, atol=1e-9)
