"""The ``vlgae_granite`` family (``vlgae-granite4hsmall``) on the CPU at a
tiny size: the weights' shapes equal the port's model, the program's first
steps against the reference with the routing handed over (``input_diff``
and ``route_sel`` 0), the tie counts on standard error, the faults of
``test_perfbench_control`` judged by this cell's limits (each limit with a
reading, so that none is not correct for a number it lacks), K7's bound and
the step's operations by hand, and the two readers on fixed contexts. On
the card (marked ``cuda``): the half-batch fault at the cell's own size."""

import gc
import json
import os

import numpy as np
import pytest
import torch

from perfbench.core import compare, harness, manifest, program
from perfbench.families import vlgae_granite as fam
from perfbench.flops import granite as count
from perfbench.flops.bounds import PEAK_BYTES_PER_S, PEAK_FLOPS
from perfbench.metrics import encoder_idle_ms, moe_roofline

from .test_perfbench_control import altered_input, half_batch, no_update
from .tiny import TRAFFIC, config as bert_config

CELL = "vlgae-granite4hsmall.train"


def config():
    with open(os.path.join(manifest.BENCH, "configs", "vlgae-granite4hsmall.json")) as f:
        c = json.load(f)
    tiny = bert_config()
    c.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=2, mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16,
             num_local_experts=8, num_experts_per_tok=3, experts_held=4,
             intermediate_size=32, shared_intermediate_size=48, vocab_size=120,
             layer_types=["mamba", "attention", "mamba", "mamba"],
             widths=tiny["widths"], max_len_train=tiny["max_len_train"],
             overrides=tiny["overrides"], vision=tiny["vision"])
    return c


def test_the_cell_and_its_metrics_are_declared():
    cell = manifest.cell(manifest.load(), CELL)
    assert cell["config"]["family"] == "vlgae_granite"
    names = {m["name"] for m in cell["per_layer"]}
    assert {"moe_roofline.train", "encoder_idle_ms.train", "mfu.train"} <= names
    assert set(cell["limits"]) == {"loss1_rel", "grad_gap", "change_gap", "input_diff",
                                   "route_sel"}
    g = fam.granite(cell["config"])
    assert g["model_type"] == "granitemoehybrid" and g["num_hidden_layers"] == 10
    assert len(g["layer_types"]) == 40 and "recipe" not in g


def test_first_steps_against_the_program_on_the_cpu(tmp_path, capsys):
    c = config()
    seed = 2**31 + 77
    fam.write_inputs(c, TRAFFIC, seed, str(tmp_path))
    pipe = program.build(c, seed, str(tmp_path), device="cpu")
    enc = pipe.model.dependency.embedding.transformer.bert
    assert enc.embed_tokens.weight.dtype == torch.bfloat16
    shapes = {n: tuple(p.shape) for n, p in pipe.model.named_parameters()}
    assert shapes == fam.param_shapes(c, len(program.tag_names(pipe)))
    first = program.train_first_steps(pipe, program.epochs(pipe, "train"), 0.5, program.nospan)
    first["extra"] = harness.program_extra(fam, pipe, first)
    assert fam.HANDED and len(fam.HANDED["sel"]) == 3
    ref = harness.reference_train(torch, {"config": c, "traffic": TRAFFIC}, seed, first,
                                  str(tmp_path), device="cpu")
    assert not fam.HANDED  # taken by the reference's first steps
    r = compare.train_readings(first, ref)
    assert r["input_diff"] == 0 and r["route_sel"] == 0
    assert r["encoder_gap"] < 1e-2 and r["loss1_rel"] < 1e-3
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("granite routing")]
    stats = json.loads(line[-1].split(": ", 1)[1])
    assert len(stats["ties"]) == len(stats["near_ties"]) == 3 and max(stats["logit_gap"]) < fam.TAU


def fault_readings(c, traffic, seed, workdir, fault, device):
    """The program's first steps with ``fault`` planted and its first
    batch's routing handed over, as ``harness.main`` runs them, against the
    reference: the readings."""
    fam.write_inputs(c, traffic, seed, workdir)
    pipe = program.build(c, seed, workdir, device=device)
    fault(pipe)
    first = program.train_first_steps(pipe, program.epochs(pipe, traffic["split"]),
                                      float(traffic["alpha"]), program.nospan)
    first["extra"] = harness.program_extra(fam, pipe, first)
    del pipe
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference_train(torch, {"config": c, "traffic": traffic}, seed, first,
                                  workdir, device=device)
    return compare.train_readings(first, ref)


def judged(r):
    """``(correct, checks)`` by the cell's limits, every limit read."""
    ok, checks = compare.judge(r, manifest.cell(manifest.load(), CELL)["limits"])
    assert all(v["value"] is not None for v in checks.values()), checks
    return ok, checks


@pytest.mark.parametrize("fault", [no_update, half_batch, altered_input])
def test_training_faults_fail_the_cells_limits(tmp_path, fault):
    r = fault_readings(config(), TRAFFIC, 2**31 + 101, str(tmp_path), fault, "cpu")
    ok, checks = judged(r)
    assert r["route_sel"] == 0 and not ok, checks
    failed = {k for k, v in checks.items() if v["value"] > v["limit"]}
    if fault is altered_input:
        assert "input_diff" in failed
    else:
        assert r["input_diff"] == 0 and failed & {"loss1_rel", "grad_gap", "change_gap"}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3250000401, 3250000402, 3250000403])
def test_half_batch_fails_at_the_cells_size_on_the_card(card, tmp_path, seed):
    cell = manifest.cell(manifest.load(), CELL)
    r = fault_readings(cell["config"], cell["traffic"], seed, str(tmp_path), half_batch,
                       "cuda")
    ok, checks = judged(r)
    print("half batch", seed, json.dumps({k: v for k, v in r.items()
                                          if not k.startswith("_")}))
    assert r["input_diff"] == 0 and r["route_sel"] == 0 and not ok, checks


def test_k7_bound_and_step_ops_by_hand():
    H, inter = 4096, 768
    # 9 experts hit, 2,000 pairs, 1,600 rows in, 1,600 live rows of 10 choices
    s = count.k7_bound(H, inter, pairs=2000, experts=9, rows=1600, live=1600, k=10)
    n_bytes = 9 * 3 * H * inter * 2 + 1600 * H * 2 + 1600 * H * 4 + 1600 * 10 * 12
    assert s == pytest.approx(max(n_bytes / PEAK_BYTES_PER_S,
                                  2 * 3 * H * inter * 2000 / PEAK_FLOPS["bf16"]))
    assert 45e-6 < s < 70e-6  # bytes: 170 MB of weights, 39 MB of rows
    g = fam.granite(manifest.cell(manifest.load(), CELL)["config"])
    S = 10
    ops = count.caption_ops(g, S)
    pairs = S * (S + 1) // 2
    inner, N, E = 8192, 128, 72
    mamba = 9 * (2 * S * H * (2 * inner + 2 * N + 128) + 2 * S * inner * H)
    attn = 2 * S * H * (2 * H + 2 * 1024) + 2 * 2 * pairs * H
    shared = 10 * (2 * S * H * 3072 + 2 * S * 1536 * H)
    assert ops["bf16"] == mamba + attn + shared
    assert ops["f32"] == 9 * (2 * pairs * N + 2 * pairs * inner) + 10 * 2 * S * H * E
    step = count.encoder_ops(g, [S, S], [5] * 10)
    assert step["bf16"] == 2 * ops["bf16"] + 10 * 2 * 3 * H * inter * 5
    w = fam.widths(manifest.cell(manifest.load(), CELL)["config"], 8)
    rec = {"seq_len": [4], "subword_len": [S], "boxes": [6]}
    launches = {"k5": [(6, 10, 128)], "k6": [100], "k7": [5] * 10}
    got = fam.step_ops(w, [rec], launches, True)[0]
    base = fam.vlgae.step_ops(w, [rec], launches, True)[0]
    assert got["bf16"] == base["bf16"] + ops["bf16"] + 10 * 2 * 3 * H * inter * 5
    assert got["f32"] == base["f32"] + ops["f32"]


def test_the_readers_on_fixed_contexts():
    ctx = {"loop": "train",
           "timeline": {"kernel_s": {"k7::moe_gemm": 0.003, "k7::moe_route": 0.001,
                                     "sm90_xmma_gemm": 0.5}},
           "bounds": {"k7_s": 0.0008},
           "program": {"idle_ms": {"vlgae.forward.text": 1.5, "vlgae.forward.text.moe": 2.0,
                                   "vlgae.forward.text.mamba": 0.5, "vlgae.forward.dmv": 7.0,
                                   "vlgae.backward": 9.0}}}
    assert moe_roofline.read(ctx, "train") == pytest.approx(20.0)
    assert encoder_idle_ms.read(ctx, "train") == pytest.approx(4.0)
    assert moe_roofline.read(dict(ctx, bounds={}), "train") is None
    assert encoder_idle_ms.read(dict(ctx, program=None), "train") is None
    assert encoder_idle_ms.read(dict(ctx, program={"idle_ms": {"vlgae.backward": 1.0}}),
                                "train") is None
    assert moe_roofline.read(dict(ctx, loop="eval"), "train") is None


def test_tie_rule_counts():
    logits = torch.tensor(np.array([[3.0, 2.0, 1.0, 0.999], [3.0, 2.0, 1.0, 0.5]]))
    own = logits.topk(3, -1).indices
    prog = torch.tensor([[0, 1, 3], [0, 1, 3]])
    sel, ties = fam.follow_ties(logits, own, prog, 0.01)
    assert ties == 1 and sel[0].sort().values.tolist() == [0, 1, 3]
    assert sel[1].sort().values.tolist() == [0, 1, 2]


def test_the_granite_reference_loads_nothing_of_the_port_or_transformers():
    from .test_perfbench_imports import modules_after
    from perfbench.core import guard

    mods = modules_after("from perfbench.reference import granite_hybrid")
    tops = {m.split(".", 1)[0] for m in mods}
    assert not tops & {"vlgae_tpu_torch", "transformers"} and not guard.forbidden_loaded(mods)
    mods = modules_after("import perfbench.families.vlgae_granite, perfbench.flops.granite\n"
                         "import perfbench.metrics.moe_roofline\n"
                         "import perfbench.metrics.encoder_idle_ms\n"
                         "from vlgae_tpu_torch.models import granite_hybrid\n"
                         "from vlgae_tpu_torch.ops import moe")
    assert not guard.forbidden_loaded(mods) and "transformers" not in {
        m.split(".", 1)[0] for m in mods}
