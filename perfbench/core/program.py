"""The system under test: the port's ``Pipeline`` of a configuration, on the
inputs its family wrote from the seed, with the weights made from the seed,
and the loops that drive it."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import families
from .weights import make_weights


def build(c: dict, seed: int, workdir: str, device="cuda"):
    """The pipeline of configuration ``c`` on the card, on the inputs its
    family wrote under ``workdir``, with the seed's weights and Adam set
    up."""
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline

    family = families.load(c)
    cfg = compose(family.overrides(c, workdir))
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = family.param_shapes(c, len(dm.vocabs["tag"]))
    if shapes != want:
        diff = sorted(set(shapes.items()) ^ set(want.items()))[:8]
        raise RuntimeError(f"the program's weights differ from the configuration's: {diff}")
    pipe = Pipeline(model, dm, cfg, device=device, workdir=workdir, seed=seed)
    W = make_weights(want.items(), seed, pipe.device, family.weight_rule)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(W[n])
    del W
    pipe.setup_optimizer()
    return pipe


def tag_names(pipe) -> list:
    return list(pipe.dm.vocabs["tag"].idx2word)


def nospan(name):
    """No span (the untraced runs)."""
    return contextlib.nullcontext()


def epochs(pipe, split):
    """The split's batches, epoch after epoch (training shuffles by epoch)."""
    shuffle = None if split == "train" else False
    while True:
        yield from pipe.dm.batches(split, shuffle)


def epoch_len(pipe, split) -> int:
    return len(pipe.dm.sampler(split, None if split == "train" else False))


def next_batch(it, span):
    """The next batch, padded to a power of two as ``train_epoch`` pads it,
    inside the ``bench.batch_wait`` span; ``(x, y, real rows)``."""
    from vlgae_tpu_torch.parallel.mesh import pad_batch_to_devices

    with span("bench.batch_wait"):
        x, y = next(it)
        real = len(x["seq_len"])
        x, _ = pad_batch_to_devices(x, 1, pow2=True)
        y, _ = pad_batch_to_devices(y, 1, pow2=True)
    return x, y, real


def host_copy(x: dict) -> dict:
    return {k: np.array(v) for k, v in x.items()}


def train_first_steps(pipe, it, alpha, span):
    """The first three steps through ``Pipeline.train_step`` on three
    batches: the program's readings (each step's loss, the first gradient
    as Adam holds it, each leaf's change), the batches as the program fed
    them and their real rows."""
    params = dict(pipe.model.named_parameters())
    opt = pipe.optimizer
    held = {id(p) for p in opt.params}
    names = [n for n in sorted(params) if id(params[n]) in held]
    before = {n: params[n].detach().clone() for n in names}
    out = {"loss": [], "batches": [], "real": []}
    beta1 = opt.opt.param_groups[0]["betas"][0]
    for k in range(3):
        x, y, real = next_batch(it, span)
        out["batches"].append(host_copy(x))
        out["real"].append(real)
        loss, _ = pipe.train_step(x, y, False, alpha)
        out["loss"].append(float(loss))
        if k == 0:
            state = opt.opt.state
            out["grad"] = {n: (float(state[params[n]]["exp_avg"].norm()) / (1 - beta1)
                               if params[n] in state else 0.0) for n in names}
    out["change"] = {n: float((params[n].detach() - before[n]).norm()) for n in names}
    return out

