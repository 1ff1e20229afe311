"""A family for the dispatch tests, reached as ``perfbench.families.stub``.

It has what the CPU path reaches (no traced stretch runs there): the
``exp=vlgae`` model through the frozen corpus writer and reference, with
its inputs written under directory names of its own (``corpus/``,
``text/``), so a harness that reached another family's functions would not
find them, and its weights filled by a rule of its own. Each function logs
its name in ``CALLS``. It adds one number to ``correct``: the first
batch's caption lengths, the program's against the reference's
(``first_seq_len``)."""

from __future__ import annotations

import os

from perfbench.core import corpus
from perfbench.reference import inputs, model, train

CALLS = []


def _root(workdir):
    return os.path.join(workdir, "corpus")


def write_inputs(c, traffic, seed, workdir):
    CALLS.append("write_inputs")
    corpus.make_corpus(_root(workdir), seed, traffic["images"], traffic["length"],
                       int(c["max_len_train"]), c["vision"])
    corpus.write_bert_dir(os.path.join(workdir, "text"), corpus.corpus_words(_root(workdir)),
                          c["bert"])


def overrides(c, workdir):
    CALLS.append("overrides")
    root = _root(workdir)
    return [c["recipe"], f"root={workdir}",
            f"datamodule.train_path={root}/train",
            f"datamodule.train_init_path={root}/init",
            f"datamodule.dev_path={root}/val",
            f"datamodule.test_path={root}/test",
            f"datamodule.sg_path={root}/vlparse.json",
            f"embedding.transformer.args.model={os.path.join(workdir, 'text')}",
            *c["overrides"]]


def param_shapes(c, n_tag):
    CALLS.append("param_shapes")
    return model.param_shapes(c, n_tag)


def weight_rule(name, shape):
    """Biases 0, norm scales 1, every other leaf N(0, 0.05)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.endswith("_bias") or leaf == "weights":
        return "zero", 0.0
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return "one", 1.0
    return "normal", 0.05


def reference_inputs(c, workdir, split):
    CALLS.append("reference_inputs")
    return inputs.Corpus(_root(workdir), os.path.join(workdir, "text"), split, c["vision"])


def first_steps(W, c, batches, tag_names, seed, alpha):
    CALLS.append("first_steps")
    out = train.first_steps(W, c, batches, tag_names, seed, alpha)
    out["extra"] = {"first_seq_len": batches[0]["seq_len"].cpu().numpy()}
    return out


def program_extra(pipe, batch):
    CALLS.append("program_extra")
    return {"first_seq_len": batch["seq_len"]}

