"""The harness reaches a model only through the configuration's family.

A stub family added as a module of its own runs the CPU path (the program
built, the reference's first steps, the judgement) with no other file
touched, and its further number reaches ``correct``; a limit with no
reading, or a configuration with no family, is refused. The ``vlgae``
family gives what the harness computed itself before the families: the
overrides, the weights' shapes, the step sizes, the operation count and
the kernels' bounds."""

import json
import sys

import numpy as np
import pytest
import torch

from perfbench import families
from perfbench.core import compare, harness, manifest, program, record
from perfbench.families import vlgae
from perfbench.flops import bounds
from perfbench.flops import model as count
from perfbench.reference import model

from . import stub_family
from .tiny import TRAFFIC, config

MAN = manifest.load()
LIMITS = manifest.cell(MAN, "vlgae-bertbase.train")["limits"]


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "perfbench.families.stub", stub_family)
    stub_family.CALLS.clear()
    return stub_family


def _stub_run(tmp_path, fault=None):
    c = dict(config(), family="stub")
    seed = 2**31 + 41
    fam = families.load(c)
    fam.write_inputs(c, TRAFFIC, seed, str(tmp_path))
    pipe = program.build(c, seed, str(tmp_path), device="cpu")
    if fault is not None:
        fault(pipe)
    first = program.train_first_steps(pipe, program.epochs(pipe, "train"), 0.5, program.nospan)
    first["extra"] = harness.program_extra(fam, pipe, first)
    ref = harness.reference_train(torch, {"config": c, "traffic": TRAFFIC}, seed, first,
                                  str(tmp_path), device="cpu")
    return compare.judge(compare.train_readings(first, ref), dict(LIMITS, first_seq_len=0))


def test_a_new_family_is_reached_by_its_name_alone(tmp_path, stub):
    ok, checks = _stub_run(tmp_path)
    assert ok, checks
    assert checks["first_seq_len"]["value"] == 0.0
    assert stub.CALLS == ["write_inputs", "overrides", "param_shapes", "program_extra",
                          "reference_inputs", "param_shapes", "first_steps"]
    assert not (tmp_path / "vlparse").exists() and not (tmp_path / "bert").exists()


def test_a_familys_number_fails_a_run_that_departs(tmp_path, stub):
    """Captions of the first batch cut short where the data module collates
    them: the stub's number reads a gap, and the run is not correct."""
    def shortened(pipe):
        collate = pipe.dm.collate

        def cut(name, insts, pad_len):
            x, y = collate(name, insts, pad_len)
            x["seq_len"][0] -= 1
            return x, y

        pipe.dm.collate = cut

    ok, checks = _stub_run(tmp_path, shortened)
    assert not ok and checks["first_seq_len"]["value"] > 0


def test_a_limit_with_no_reading_is_not_correct():
    ok, checks = compare.judge({"loss1_rel": 0.0}, {"loss1_rel": 1.0, "first_seq_len": 0})
    assert not ok and checks["first_seq_len"]["value"] is None
    assert harness.program_extra(object(), None, {"batches": [{}]}) == {}
    assert compare.extra_readings({}, {"first_seq_len": 3}) == {}
    assert compare.extra_readings({"a": [1.0, 2.0]}, {"a": [1.0, 4.0]}) == {"a": 0.5}
    assert compare.extra_readings({"a": [1.0]}, {"a": [1.0, 4.0]}) == {"a": float("inf")}


def test_a_configuration_without_a_family_is_refused(tmp_path):
    with pytest.raises(ValueError, match="family"):
        families.load({"recipe": "exp=vlgae"})
    c = {k: v for k, v in config().items() if k != "family"}
    path = tmp_path / "nofamily.json"
    path.write_text(json.dumps(c))
    man = dict(MAN, configs=[dict(MAN["configs"][0], file=str(path))])
    with pytest.raises(ValueError, match="family"):
        manifest.cell(man, "vlgae-bertbase.train")


def _parent_overrides(c, workdir, bert_dir):
    """``program.compose_overrides`` as it was before the families."""
    root = f"{workdir}/vlparse"
    return [c["recipe"], f"root={workdir}",
            f"datamodule.train_path={root}/train",
            f"datamodule.train_init_path={root}/init",
            f"datamodule.dev_path={root}/val",
            f"datamodule.test_path={root}/test",
            f"datamodule.sg_path={root}/vlparse.json",
            f"embedding.transformer.args.model={bert_dir}",
            *c["overrides"]]


def _parent_step_sizes(x, n):
    """``program.step_sizes`` as it was before the families."""
    return {"seq_len": [int(v) for v in x["seq_len"][:n]],
            "subword_len": [int(v) for v in np.asarray(x["subword_mask"])[:n].sum(1)],
            "boxes": [int(v) for v in np.asarray(x["vis_box_mask"])[:n].sum(1)]}


def _parent_rule(name, shape):
    """``core.weights.rule`` as it was before the families."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.endswith("_bias") or leaf == "weights":
        return "zero", 0.0
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return "one", 1.0
    if ".bert." in f".{name}":
        return "normal", 0.02
    if leaf in ("embedding", "root_emb", "dec_emb"):
        return "normal", 1.0
    fan_in = shape[-1] if len(shape) == 2 else shape[0]
    return "normal", fan_in ** -0.5


def test_the_vlgae_family_gives_what_the_harness_gave(tmp_path):
    c = config()
    assert families.load(c) is vlgae
    assert vlgae.overrides(c, str(tmp_path)) == _parent_overrides(
        c, str(tmp_path), f"{tmp_path}/bert")
    shapes = vlgae.param_shapes(c, 9)
    assert shapes == model.param_shapes(c, 9)
    assert all(vlgae.weight_rule(n, s) == _parent_rule(n, s) for n, s in shapes.items())
    rng = np.random.default_rng(3)
    x = {"seq_len": np.array([3, 5, 2, 0]),
         "subword_mask": rng.random((4, 9)) < 0.5, "vis_box_mask": rng.random((4, 6)) < 0.7}
    assert vlgae.step_sizes(x, 3) == _parent_step_sizes(x, 3)
    w = vlgae.widths(c, 9)
    assert w == dict(c["widths"], bert=c["bert"], n_token=9)
    steps = [vlgae.step_sizes(x, 3), vlgae.step_sizes(x, 2)]
    launches = {"k5": [(10, 12, 16), (8, 9, 16)], "k6": [30, 20]}
    want = [count.step_ops(w, dict(rec, k5_live=launches["k5"][i:i + 1],
                                   k6_cells=launches["k6"][i:i + 1], D=w["match_hidden"]), True)
            for i, rec in enumerate(steps)]
    assert vlgae.step_ops(w, steps, launches, True) == want


def test_the_vlgae_kernels_bound_as_the_recorder_did():
    A, V, B, Q, D = 2, 5, 3, 4, 8
    vb = torch.zeros(A, V)
    vb[0, 3:] = -1e9
    tb = torch.zeros(B, Q)
    tb[1, 2:] = -1e9
    gen = torch.Generator().manual_seed(1)
    li = torch.randint(0, V, (B, A, Q), dtype=torch.int32, generator=gen)
    lvi = torch.randint(0, Q, (B, A, V), dtype=torch.int32, generator=gen)
    lengths = torch.tensor([3, 0, 5])
    rec = {"k1": [(6, lengths)], "k5": [(vb, tb, D)], "k6": [(li, lvi, D)]}
    got = record.bounds(vlgae.KERNELS, rec)
    cells = bounds.k6_cells(li, lvi)
    assert got == {"k1_s": bounds.dmv_bound([3, 0, 5], 6, "fused"), "k1": [None],
                   "k5_s": bounds.k5_bound(A, V, B, Q, D, 8, 10), "k5": [(8, 10, D)],
                   "k6_s": bounds.k6_bound(A, V, B, Q, D, cells), "k6": [cells]}


def entry(a, b=1):
    return a + b


def test_the_recorder_wraps_and_restores_an_entry_point():
    k = record.Kernel("e", __name__, "entry", lambda a, b=1: (a, b),
                      lambda kept: (float(sum(kept)), kept[0]))
    orig = sys.modules[__name__].entry
    with record.launches([k]) as rec:
        assert sys.modules[__name__].entry(2) == 3
        assert sys.modules[__name__].entry(4, b=5) == 9
    assert sys.modules[__name__].entry is orig
    assert rec == {"e": [(2, 1), (4, 5)]}
    assert record.bounds([k], rec) == {"e_s": 12.0, "e": [2, 4]}
