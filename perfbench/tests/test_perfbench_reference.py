"""The plain reference against the port's CPU path at tiny widths: the
first three training steps of the joint recipe (dropout on), each step's
loss, the first gradient and the change of every leaf, the reference on
its own inputs read from the corpus files."""

import numpy as np
import torch

from perfbench import families
from perfbench.core import compare, harness, program
from perfbench.reference import inputs, train

from .tiny import TRAFFIC, config


def test_reference_follows_the_port_on_cpu(tmp_path):
    c = config()
    seed = 2**31 + 17
    families.load(c).write_inputs(c, TRAFFIC, seed, str(tmp_path))
    pipe = program.build(c, seed, str(tmp_path), device="cpu")
    first = program.train_first_steps(pipe, program.epochs(pipe, "train"), 0.5, program.nospan)
    assert [pipe.optimizer.lr_at(k) for k in range(3)] == [train.lr_at(k) for k in range(3)]
    ref = harness.reference_train(torch, {"config": c, "traffic": TRAFFIC}, seed, first,
                                  str(tmp_path), device="cpu")
    r = compare.train_readings(first, ref)
    assert r["input_diff"] == 0
    assert abs(first["loss"][0] - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    assert r["loss_rel"] < 1e-4, (first["loss"], ref["loss"])
    # bf16 matching gradients and Adam's first moves (about lr times a sign)
    assert r["grad_gap"] < 1e-2, r
    assert r["change_gap"] < 5e-2, r


def test_reference_inputs_are_the_programs_batches(tmp_path):
    """Every batch of an epoch, read anew from the files, equals the one
    the port's data path packed; an altered feature does not."""
    c = config()
    seed = 2**31 + 29
    families.load(c).write_inputs(c, TRAFFIC, seed, str(tmp_path))
    pipe = program.build(c, seed, str(tmp_path), device="cpu")
    corpus = inputs.Corpus(str(tmp_path / "vlparse"), str(tmp_path / "bert"), "train",
                           c["vision"])
    assert corpus.tag_names == program.tag_names(pipe)
    it = program.epochs(pipe, "train")
    for _ in range(program.epoch_len(pipe, "train")):
        x, _, real = program.next_batch(it, program.nospan)
        x = program.host_copy(x)
        assert corpus.batch(x, real)[1] == 0
    x["vis_box_feat"][0, 0, 0] += 1.0
    assert corpus.batch(x, real)[1] > 0
    assert np.array_equal(corpus.batch(x, real)[0]["seq_len"], x["seq_len"])
