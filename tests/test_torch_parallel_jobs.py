"""Multi-process jobs of the data-parallel tests (no tests here).

Run by ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_pipeline.py`` under ``torchrun`` on gloo:

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        tests/test_torch_parallel_jobs.py <job> <args.json> <out dir>

Each rank writes ``<out dir>/rank<r>.pt``. Imports torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch


def job_match(args, dp, out):
    """match_maxes_sharded on this rank's rows (values, indices and the
    gradients of a weighted sum), then metric states and predictions
    summed and merged across the ranks."""
    from vlgae_tpu_torch.ops.match import match_maxes_sharded
    from vlgae_tpu_torch.parallel.mesh import gather_predictions, sum_across_processes
    from vlgae_tpu_torch.training.metrics import (DependencyParsingMetric,
                                                  FactorImageMatchingMetric, MultiMetric)

    res = {}
    for dtype in ("f32", "bf16"):
        x = match_inputs(args["seed"], *args["shape"])
        A, B = args["shape"][0], args["shape"][2]
        a0, a1 = dp.rows(A)
        b0, b1 = dp.rows(B)
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        vis = torch.tensor(x["vis"][a0:a1], dtype=dt).requires_grad_(True)
        txt = torch.tensor(x["txt"][b0:b1], dtype=dt).requires_grad_(True)
        vb = torch.tensor(x["vb"][a0:a1], dtype=torch.float32)
        tb = torch.tensor(x["tb"][b0:b1], dtype=torch.float32)
        logit, li, logit_v, lvi = match_maxes_sharded(vis, txt, vb, tb, dp)
        loss = ((logit * torch.from_numpy(x["wm"][b0:b1])).sum()
                + (logit_v * torch.from_numpy(x["wmv"][b0:b1])).sum())
        loss.backward()
        res[dtype] = {"logit": logit.detach(), "logit_idx": li, "logit_v": logit_v.detach(),
                      "logit_v_idx": lvi, "dvis": vis.grad.float(), "dtxt": txt.grad.float()}
    # metrics and predictions: this rank holds sentences rank, rank + world, ...
    data = metric_inputs(args["seed"])
    mine = list(range(dp.rank, len(data["arc"]), dp.world))
    metric = MultiMetric(DependencyParsingMetric(), img=FactorImageMatchingMetric())
    update_metric(metric, data, mine)
    metric.sync(lambda vec: sum_across_processes(vec, dp))
    res["scores"] = metric.compute()
    res["merged"] = gather_predictions(predictions(data, mine), dp)
    return res


def match_inputs(seed, A, V, B, Q, D):
    """Quarter-integer operands (every product and sum exact in f32), -1e9
    masks and quarter-integer cotangents."""
    rng = np.random.default_rng(seed)
    quarter = lambda *shape: (rng.integers(-8, 9, shape) * 0.25).astype(np.float32)  # noqa: E731
    return {"vis": quarter(A, V, D), "txt": quarter(B, Q, D),
            "vb": np.where(rng.random((A, V)) < 0.2, -1e9, 0.0).astype(np.float32),
            "tb": np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0).astype(np.float32),
            "wm": quarter(B, A, Q), "wmv": quarter(B, A, V)}


def metric_inputs(seed, n=11, L=7):
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(1, L + 1, n)
    return {"arc": rng.integers(0, L, (n, L)), "gold": rng.integers(0, L, (n, L)),
            "lengths": lengths, "img": [rng.integers(0, n, int(k)) for k in lengths]}


def update_metric(metric, data, rows):
    """One update a sentence, as an eval batch of one row would."""
    for i in rows:
        mask = np.arange(data["arc"].shape[1])[None] < data["lengths"][i]
        metric.update({"arc": data["arc"][i:i + 1], "txt_to_img": [data["img"][i] - i]},
                      {"arc": data["gold"][i:i + 1]}, mask)


def predictions(data, rows):
    return {int(i): {"arc": data["arc"][i, :data["lengths"][i]].tolist()} for i in rows}


def job_slice(args, dp, out):
    """``exp=vlgae`` on this rank's rows: one joint step's loss and summed
    gradients for each precision (a key of ``args["overrides"]``); at the
    first, the dev evaluation (rank 0 writes the prediction file) and one
    joint epoch. Under ``trainer.model_parallel`` the rows are those of the
    rank's data group and the tensor-parallel leaves come back whole."""
    from vlgae_tpu_torch import convert
    from vlgae_tpu_torch.parallel.mesh import full_tensor, is_sharded, local, tp_spec

    res = {}
    for precision in args["precisions"]:
        pipe = build(args, precision)
        x, y = first_batch(pipe, dp)
        loss, aux = pipe.grad_step(x, y, False, 0.5)
        res[precision] = {"loss": pipe._host_sums({"loss": loss, **aux}),
                          "grads": summed_grads(pipe, convert)}
        if precision == args["precisions"][0]:
            res["sharded"] = {n: (is_sharded(p), local(p).numel(), p.numel())
                              for n, p in pipe.model.named_parameters()}
            res["tp"] = {n: (tp_spec(p)[0], p.numel()) for n, p in pipe.model.named_parameters()
                         if tp_spec(p) is not None}
            res["groups"] = {"data": (pipe.dp.rank, pipe.dp.world),
                             "model": (pipe.mp.rank, pipe.mp.size)}
            res["eval"], res["outputs"] = pipe.evaluate("dev")
            if dp.rank == 0:
                pipe.write_predictions(os.path.join(out, "dev.predict.txt"), "dev",
                                       res["outputs"])
            if args.get("watch"):
                res["watched"] = watch(pipe, dp)
            res["epoch1"] = pipe.train_epoch(1)
            if args.get("watch"):
                res["watched"] = res["watched"][:1]  # the epoch's first update
            # (Adam's first moment of each parameter here, numel of the whole)
            state = pipe.optimizer.opt.state
            held = pipe.optimizer._held
            stepped = {id(p) for p in pipe.optimizer.params}
            res["moments"] = {n: (state[held[id(p)]]["exp_avg"].numel(), p.numel())
                              for n, p in pipe.model.named_parameters() if id(p) in stepped}
            if args.get("checkpoint"):
                pipe.workdir = out
                res["checkpoint"] = pipe.save_checkpoint("last")
                res["epoch2"] = pipe.train_epoch(2)
            res["params"] = {n: full_tensor(p.detach(), p).clone()
                             for n, p in pipe.model.named_parameters()}
    return res


def watch(pipe, dp):
    """A wandb watcher of every parameter and gradient at every update, on
    every rank, logging (rank 0's) into the returned list through a
    stand-in ``wandb`` module whose histograms are the arrays themselves."""
    import types

    from vlgae_tpu_torch.utils.logger import WandbWatcher

    logged = []
    sys.modules["wandb"] = types.SimpleNamespace(
        run=types.SimpleNamespace(), Histogram=lambda a: a.copy(),
        log=lambda payload, step=None: logged.append((step, payload)))
    pipe.watcher = WandbWatcher(log="all", log_freq=1, writer=dp.rank == 0)
    return logged


def build(args, precision):
    """The port's pipeline of ``args["overrides"][precision]`` with the
    weights of ``args["weights"]`` (the JAX package's params), on the CPU."""
    from vlgae_tpu_torch.predict import build_pipeline

    pipe = build_pipeline(args["overrides"][precision], device="cpu", weights=args["weights"])
    pipe.setup_optimizer()
    return pipe


def first_batch(pipe, dp):
    from vlgae_tpu_torch.parallel.mesh import pad_batch_to_devices

    pipe.dm.include_init_rules = False
    x, y = next(pipe.dm.batches("train", shuffle=False))
    return (pad_batch_to_devices(x, dp.world, pow2=True)[0],
            pad_batch_to_devices(y, dp.world, pow2=True)[0])


def summed_grads(pipe, convert):
    """Every gradient summed over the data group (whole), by flax path;
    clears them."""
    from vlgae_tpu_torch.parallel.mesh import all_reduce_grads, full_tensor

    params = [p for _, p in pipe.model.named_parameters()]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_grads(params, pipe.dp)
    grads = convert.torch_to_flax({n: full_tensor(p.grad, p).detach().clone()
                                   for n, p in pipe.model.named_parameters()})
    for p in params:
        p.grad = None
    return grads


JOBS = {"match": job_match, "slice": job_slice}


def main(argv):
    from vlgae_tpu_torch.parallel.mesh import init_distributed, shutdown

    job, args_path, out = argv
    with open(args_path) as f:
        args = json.load(f)
    dp = init_distributed(torch.device("cpu"))
    try:
        res = JOBS[job](args, dp, out)
        torch.save(res, os.path.join(out, f"rank{dp.rank}.pt"))
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
