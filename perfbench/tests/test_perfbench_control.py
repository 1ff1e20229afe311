"""The control and the faults come out as not correct.

``test_control_fails_on_the_card`` (marked ``cuda``) reads the control at
the cell's own size: the reference with TF32 on in the program's place. The
fault tests drive the rest of a run on the CPU at a small size with the
timed path broken underneath: a step that leaves its state unchanged, half
of the batch left out (the mean taken over the rest), an input altered
where the data path produces it; each is judged by the cell's limits."""

import numpy as np
import pytest
import torch

from perfbench import families
from perfbench.core import compare, harness, manifest, program

from .tiny import TRAFFIC, config

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
SEEDS = [2147483659, 3000000019, 4000000007]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell, seed):
    r = harness.control_readings(cell, seed)
    ok, checks = compare.judge(r, manifest.cell(MAN, cell)["limits"])
    print(cell, seed, {k: v["value"] for k, v in checks.items()})
    assert not ok, checks


def halve(x):
    """Half of the batch left out: its rows get no words, so the losses,
    normalised by the real tokens, are the mean over the rest."""
    x = dict(x, seq_len=np.array(x["seq_len"]))
    x["seq_len"][len(x["seq_len"]) // 2:] = 0
    return x


def _train_readings(tmp_path, fault):
    c = config()
    seed = 2**31 + 101
    families.load(c).write_inputs(c, TRAFFIC, seed, str(tmp_path))
    pipe = program.build(c, seed, str(tmp_path), device="cpu")
    fault(pipe)
    first = program.train_first_steps(pipe, program.epochs(pipe, "train"), 0.5, program.nospan)
    ref = harness.reference_train(torch, {"config": c, "traffic": TRAFFIC}, seed, first,
                                  str(tmp_path), device="cpu")
    return compare.train_readings(first, ref)


def no_update(pipe):
    pipe.apply_step = lambda n_accumulated=1: pipe.optimizer.zero_grad()


def half_batch(pipe):
    step = pipe.train_step
    pipe.train_step = lambda x, y, init, alpha: step(halve(x), y, init, alpha)


def altered_input(pipe):
    """One region feature of each batch altered where the data module
    collates it."""
    collate = pipe.dm.collate

    def altered(name, insts, pad_len):
        x, y = collate(name, insts, pad_len)
        x["vis_box_feat"][0, 0, 0] += 1.0
        return x, y

    pipe.dm.collate = altered


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [no_update, half_batch, altered_input])
def test_training_faults_are_not_correct(tmp_path, cell, fault):
    r = _train_readings(tmp_path, fault)
    ok, checks = compare.judge(r, manifest.cell(MAN, cell)["limits"])
    assert not ok, checks
