"""The port's tensor parallelism (``trainer.model_parallel``) against one
process and against vlgae_tpu.

``exp=vlgae`` at the narrow widths of ``tests/test_torch_train.py`` on its
synthetic corpus, the JAX model's params carried over; the ``(data,
model)`` grids ``(1, 2)`` and ``(2, 2)`` run under ``torchrun`` on gloo
(``tests/test_torch_parallel_jobs.py``). The visual factor heads are
column-parallel and ``vis_mlp_pre_matching`` row-parallel, so the
row-parallel product sums two partial products where one process sums one:
the results differ from one process's by f32 round-off. Held to the
data-parallel tolerances of ``tests/test_torch_parallel_pipeline.py``: one
joint step's loss 1e-5 relative, every gradient 1e-3 relative + 1e-5, the
dev evaluation's metrics and predictions equal (the prediction file
byte-identical), one joint epoch's loss 1e-4; under bf16 the gradients
within ``2^-7`` relative plus ``2^-7`` of the largest entry. The step is
also held to the JAX package's Pipeline with ``trainer.model_parallel=2`` on
a 2- and a 4-device mesh (f32, the same tolerances). With dropout on, a
model rank draws the full-width masks and keeps its columns, so the step
is one process's. At ``(2, 2)`` FSDP shards only the leaves no
tensor-parallel rule takes, and the checkpoint, whole, resumes at world 1
on the same trajectory. A trainable ViT backbone's gradient, summed over the
model group at the column-parallel head's input, is one process's.
"""


import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_pipeline as tpp
import test_torch_train as tt
from test_torch_parallel import REPO, run_job
from test_torch_parallel_pipeline import setup  # noqa: F401  (the module fixture)
from vlgae_tpu_torch import convert

MP2 = ["trainer.model_parallel=2"]
FSDP = ["trainer.fsdp=true", "trainer.fsdp_min_size=64"]


def _ovs(root, precision="32", dropout=False):
    return tt.overrides(root, precision=precision, dropout=dropout) + MP2


@pytest.fixture(scope="module")
def grid12(setup, tmp_path_factory):  # noqa: F811
    """The slice job on the (1, 2) grid: f32 (eval, epoch), bf16, and f32
    with dropout."""
    root, _, _, weights = setup
    out = tmp_path_factory.mktemp("g12")
    args = {"weights": weights, "precisions": ["32", "bf16", "drop"],
            "overrides": {"32": _ovs(root), "bf16": _ovs(root, "bf16"),
                          "drop": _ovs(root, dropout=True)}}
    return run_job("slice", args, 2, out), out


@pytest.fixture(scope="module")
def grid22(setup, tmp_path_factory):  # noqa: F811
    """The slice job on the (2, 2) grid: f32 with FSDP (eval, epoch, a
    checkpoint and a second epoch), bf16 with dropout."""
    root, _, _, weights = setup
    out = tmp_path_factory.mktemp("g22")
    args = {"weights": weights, "precisions": ["32", "bf16"], "checkpoint": True,
            "overrides": {"32": _ovs(root) + FSDP,
                          "bf16": _ovs(root, "bf16", dropout=True)}}
    return run_job("slice", args, 4, out), out


def _jax_mesh_step(setup, n):
    """The JAX Pipeline with trainer.model_parallel=2 on ``n`` of the 8
    virtual devices: the first training batch's loss and gradients."""
    from flax import traverse_util

    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HashSubwordTokenizer, attach_subwords
    from vlgae_tpu.training import Pipeline, build_model
    from vlgae_tpu.utils.config import ConfigComposer, resolve

    root, _, flat, _ = setup
    cfg = resolve(ConfigComposer(str(REPO / "configs")).compose("config_train", _ovs(root)))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    dm = VLParseDataModule(**dm_cfg).setup()
    attach_subwords(dm, HashSubwordTokenizer())
    jpipe = Pipeline(build_model(cfg, dm), dm, cfg, workdir=str(root),
                     devices=jax.devices()[:n])
    assert jpipe.mesh.shape == {"data": n // 2, "model": 2}
    jpipe.init_state(next(dm.batches("train", shuffle=False)), seed=0)
    jpipe.state.params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    jpipe.state.opt_state = jpipe.tx.init(jpipe.state.params)
    x, y = tt._batch(dm, "train", False)
    loss, aux, grads, _ = tt._jax_step(jpipe, x, y, False)
    return loss, aux, grads


def _check_tp_leaves(got, one):
    """The rules' leaves are sliced over the 2 model ranks (the visual
    heads on their output features, vis_mlp_pre_matching on its input
    features), no other."""
    from vlgae_tpu_torch.parallel import param_spec

    whole = {n: p for n, p in one.model.named_parameters()}
    want = {n for n in whole if param_spec(n) is not None}
    assert set(got["tp"]) == want
    assert {part for n in want for part in n.split(".")} >= {
        "rel_fc", "rel_fc_bias", "box_fc", "attr_fc", "vis_mlp_pre_matching"}
    for n, (axis, local_numel) in got["tp"].items():
        assert axis == param_spec(n) and local_numel * 2 == whole[n].numel(), n
    assert got["groups"]["model"][1] == 2


def test_grid_1x2_step_eval_and_epoch_match_one_process_and_jax(setup, grid12, tmp_path):  # noqa: F811
    ranks, out = grid12
    assert [r["groups"] for r in ranks] == [{"data": (0, 1), "model": (0, 2)},
                                            {"data": (0, 1), "model": (1, 2)}]
    one = tpp._check_slice(setup, ranks[0], out, tmp_path)
    _check_tp_leaves(ranks[0], one)
    # both model ranks hold the same whole results
    for k in ("loss", "grads"):
        assert str(ranks[1]["32"][k]) == str(ranks[0]["32"][k]), k
    want_loss, want_aux, want_grads = _jax_mesh_step(setup, 2)
    got = ranks[0]["32"]
    assert got["loss"]["loss"] == pytest.approx(want_loss, rel=tpp.LOSS_RTOL)
    for k, v in want_aux.items():
        assert got["loss"][k] == pytest.approx(v, rel=tpp.LOSS_RTOL), k
    tpp._check_grads(got["grads"], want_grads, tpp.GRAD_RTOL, tpp.GRAD_ATOL, "vs JAX (1, 2)")


def test_grid_1x2_bf16_and_dropout_steps_match_one_process(setup, grid12):  # noqa: F811
    """bf16: the plain K5/K6 versions on the whole image axis; dropout:
    every mask of a model rank is its columns of one process's."""
    root, _, _, weights = setup
    tpp._check_bf16(setup, grid12[0][0]["bf16"])
    loss1, grads1 = tpp._step(tpp._port(root, tt.overrides(root, dropout=True), weights))
    got = grid12[0][0]["drop"]
    for k, v in loss1.items():
        assert got["loss"][k] == pytest.approx(v, rel=tpp.LOSS_RTOL), k
    tpp._check_grads(got["grads"], grads1, tpp.GRAD_RTOL, tpp.GRAD_ATOL, "dropout")


def test_grid_2x2_step_eval_epoch_fsdp_and_checkpoint(setup, grid22, tmp_path):  # noqa: F811
    root, _, _, weights = setup
    ranks, out = grid22
    assert [r["groups"] for r in ranks] == [
        {"data": (d, 2), "model": (m, 2)} for d in (0, 1) for m in (0, 1)]
    r0 = ranks[0]
    # FSDP shards what the JAX rule shards over the data group of 2, but
    # never a tensor-parallel leaf ("TP rules win")
    from vlgae_tpu_torch.parallel import fsdp_leaf_spec, param_spec

    one = tpp._port(root, tt.overrides(root), weights)
    _check_tp_leaves(r0, one)
    for n, p in one.model.named_parameters():
        fsdp = param_spec(n) is None and fsdp_leaf_spec(p.shape, 2, 64) is not None
        assert r0["sharded"][n][0] == fsdp, n
    assert sum(s for s, _, _ in r0["sharded"].values()) >= 10
    # the step, eval and the epoch against one process, the step against JAX
    loss1, grads1 = tpp._step(one)
    for k, v in loss1.items():
        assert r0["32"]["loss"][k] == pytest.approx(v, rel=tpp.LOSS_RTOL), k
    tpp._check_grads(r0["32"]["grads"], grads1, tpp.GRAD_RTOL, tpp.GRAD_ATOL, "vs one")
    want_loss, _, want_grads = _jax_mesh_step(setup, 4)
    assert r0["32"]["loss"]["loss"] == pytest.approx(want_loss, rel=tpp.LOSS_RTOL)
    tpp._check_grads(r0["32"]["grads"], want_grads, tpp.GRAD_RTOL, tpp.GRAD_ATOL,
                     "vs JAX (2, 2)")
    val1, out1 = one.evaluate("dev")
    tpp._check_eval(r0["eval"], val1, r0["outputs"], out1)
    one.write_predictions(str(tmp_path / "dev.predict.txt"), "dev", out1)
    assert (out / "dev.predict.txt").read_bytes() == (tmp_path / "dev.predict.txt").read_bytes()
    epoch1 = one.train_epoch(1)
    for k in ("train/loss", "train/nll", "train/txt2vis", "train/mt_vis2txt"):
        assert r0["epoch1"][k] == pytest.approx(epoch1[k], rel=tpp.EPOCH_RTOL), k
    # the checkpoint is whole (one process's dict) and resumes at world 1
    one.workdir = str(tmp_path)
    ref = torch.load(one.save_checkpoint("last"), weights_only=True)
    ckpt = torch.load(r0["checkpoint"], weights_only=True)
    assert ckpt["model"].keys() == ref["model"].keys() and ckpt["step"] == ref["step"] > 0
    tpp._close_params(ckpt["model"], ref["model"], ckpt["step"], 2e-5, "checkpoint")
    for i, st in ref["optimizer"]["adam"]["state"].items():
        for k, v in st.items():
            assert ckpt["optimizer"]["adam"]["state"][i][k].shape == v.shape, (i, k)
    resumed = tpp._port(root, tt.overrides(root), weights)
    resumed.load_checkpoint(r0["checkpoint"], load_training_state=True)
    epoch2 = resumed.train_epoch(2)
    for k in ("train/loss", "train/nll"):
        assert r0["epoch2"][k] == pytest.approx(epoch2[k], rel=tpp.EPOCH_RTOL), k
    tpp._close_params(r0["params"], {n: p.detach() for n, p in resumed.model.named_parameters()},
                      resumed.step - ckpt["step"], 2e-5, "resumed")


def test_grid_2x2_bf16_with_dropout_matches_one_process(setup, grid22):  # noqa: F811
    """Rows over the data group and columns over the model group of every
    dropout mask, under bf16."""
    root, _, _, weights = setup
    loss1, grads1 = tpp._step(tpp._port(root, tt.overrides(root, "bf16", dropout=True),
                                        weights))
    got = grid22[0][0]["bf16"]
    for k, v in loss1.items():
        assert got["loss"][k] == pytest.approx(v, rel=tpp.LOSS_RTOL), k
    for k, g in grads1.items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=tpp.BF16_RTOL,
                                   atol=tpp.BF16_RTOL * np.abs(g).max() + tpp.GRAD_ATOL,
                                   err_msg=k)


def test_trainable_vit_backbone_gradient_is_summed_over_the_model_group(tmp_path):
    """``exp=vlgae_vit`` with a trainable backbone on the (1, 2) grid: the
    head is column-parallel, so each model rank's backbone gradient is a
    part until the head's input sums them; every gradient, the backbone's
    included, is one process's."""
    import synth_data
    import test_torch_vit as tv
    from vlgae_tpu_torch.predict import build_pipeline

    synth_data.make_corpus(tmp_path / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9), image_size=32)
    ovs = tv.overrides(tmp_path) + ["vis_encoder.requires_grad=true"]
    one = build_pipeline(ovs, device="cpu", init_seed=0)
    weights = str(tmp_path / "weights.pt")
    torch.save(one.model.state_dict(), weights)
    one.setup_optimizer()
    loss1, grads1 = tpp._step(one)
    assert any(k.startswith("vis_encoder/vit/") and np.abs(v).max() > 0
               for k, v in grads1.items())
    job = run_job("slice", {"weights": weights, "precisions": ["32"],
                            "overrides": {"32": ovs + MP2}}, 2, tmp_path / "job")
    got = job[0]["32"]
    assert {n for n in job[0]["tp"] if ".vit." in n} == set()
    assert any(n.startswith("vis_encoder.head.") for n in job[0]["tp"])
    for k, v in loss1.items():
        assert got["loss"][k] == pytest.approx(v, rel=tpp.LOSS_RTOL), k
    tpp._check_grads(got["grads"], grads1, tpp.GRAD_RTOL, tpp.GRAD_ATOL, "vit")


# -- no processes ------------------------------------------------------------------
def test_rules_name_the_jax_rules_leaves(setup):  # noqa: F811
    """On every parameter of the joint model and of the ViT encoder, the
    port's rule shards exactly the leaves the JAX package's
    DEFAULT_MODEL_RULES shard, on the same features (a flax kernel is the
    transposed torch weight)."""
    from jax.sharding import PartitionSpec as P

    from vlgae_tpu.parallel.mesh import DEFAULT_MODEL_RULES as JRULES
    from vlgae_tpu.parallel.mesh import param_spec as jspec
    from vlgae_tpu_torch.models.joint import DependencyBoxRel
    from vlgae_tpu_torch.models.vis_encoder import ViTConfig, VisViTPatchEncoder
    from vlgae_tpu_torch.parallel import param_spec

    root, _, _, weights = setup
    model = tpp._port(root, tt.overrides(root), weights).model
    vit = VisViTPatchEncoder(8, ViTConfig(16, 1, 2, 32, 32, 16), use_img=True)
    named = [*model.named_parameters(), *(("vis_encoder." + n, p)
                                          for n, p in vit.named_parameters())]
    assert isinstance(model, DependencyBoxRel)
    seen = set()
    for name, p in named:
        want = jspec("params/" + convert.torch_to_flax_key(name, p.dim()), JRULES)
        axis = param_spec(name)
        if want == P():
            assert axis is None, name
            continue
        seen.add(name.rsplit(".", 1)[0])
        # JAX: kernel [in, out] on "model" = torch [out, in] on the other axis
        torch_axis = {P(None, "model"): 0, P("model"): 0, P("model", None): 1}[want]
        assert axis == torch_axis, (name, want, axis)
    assert "vis_encoder.head.img_fc.linear" in seen and "vis_mlp_pre_matching" in seen


def test_a_world_the_model_axis_does_not_divide_raises():
    from vlgae_tpu.parallel import data_parallel_mesh as jmesh
    from vlgae_tpu_torch.parallel import DataGroup, split_mesh

    with pytest.raises(ValueError) as want:
        jmesh(jax.devices()[:3], model=2)
    with pytest.raises(ValueError) as got:
        split_mesh(DataGroup(0, 3), 2)
    assert str(got.value) == str(want.value) == "3 devices not divisible by model=2"
    dp, mp, mesh = split_mesh(DataGroup(0, 3), 1)
    assert dp == DataGroup(0, 3) and not mp.sharded and mesh is None


def test_a_model_rank_draws_its_columns_of_the_full_width_mask():
    """With ``feature_cols`` set, a draw is the full-width draw cut to this
    rank's columns (and, with ``batch_rows``, to its rows too)."""
    from vlgae_tpu_torch.models.nn import MLP, set_batch_rows, set_dropout_generator

    x = torch.randn(8, 3, 5)
    m = MLP(5, 6, dropout=0.5).train()
    full = {}
    for rows in (None, (0, 4, 8), (4, 8, 8)):
        for cols in (None, (0, 3, 6), (3, 6, 6)):
            set_dropout_generator(m, torch.Generator().manual_seed(3))
            set_batch_rows(m, rows)
            m.feature_cols = cols
            keep = m.keep_mask((8 if rows is None else 4, 1, 3 if cols else 6), 0.5, x)
            full[rows, cols] = keep
    whole = full[None, None]
    for rows in (None, (0, 4, 8), (4, 8, 8)):
        r = slice(None) if rows is None else slice(rows[0], rows[1])
        for cols in ((0, 3, 6), (3, 6, 6)):
            torch.testing.assert_close(full[rows, cols], whole[r][..., cols[0]:cols[1]],
                                       rtol=0, atol=0)
