"""Training entry point of the port (counterpart of ``train.py``).

    python -m vlgae_tpu_torch.train exp=vlgae root=<data> [overrides...] \\
        [init_seed=<int> | weights=<jax params .npz>] [device=cuda|cpu]

Composes ``configs/config_train`` with the overrides, builds the data and
the model, draws the weights from ``init_seed`` (default: the config's
``seed``, else 0) or carries the JAX package's params over from
``weights``, then warm-starts (``pipeline.load_from_checkpoint``) or
resumes (``trainer.resume_from_checkpoint``), runs the epochs (the
``init_epoch`` warm-up epochs, then the joint ones) with validation every
``trainer.val_check_interval`` of an epoch, keeps ``checkpoint/best.pt``
(the watched metric) and ``checkpoint/last.pt``, and ends with the test
split evaluated with the best weights. The run directory (``workdir``, by
default ``outputs/<name>/<time>``) holds ``config.json``,
``overrides.json``, the vocabularies, ``metrics.jsonl`` (also printed as
JSON lines), ``dev.predict.txt`` and ``test.predict.txt``. ``device``
defaults to ``cuda`` and raises without a card.

``-m`` (or ``--multirun``) sweeps comma lists (``optimizer.args.lr=1e-3,2e-3``)
over their cartesian product, one run each in ``outputs/multirun/<time>/<i>``,
with one line a run in that directory's ``results.jsonl``; Hydra's sweep
functions (``range(...)`` and the like) raise. ``VLGAE_SEARCH_PARAMS`` (a
JSON object) adds its items as overrides, and ``VLGAE_SEARCH_RESULT`` names
a file that receives ``{"best", "test"}`` at the end. ``wandb=true`` logs to
wandb as well when the package is importable (and goes inert without it);
``profile=true`` writes a ``torch.profiler`` trace of updates 3-5 to
``<workdir>/profile/``: a Chrome trace whose host rows carry the port's
``vlgae.*`` spans (:mod:`vlgae_tpu_torch.utils.trace`: the upload, the
forward and its stages, the loss, the backward, the optimizer, the
wait for a batch and the padding; the collate and the feature loader of
an epoch's first batch, the others being collated on the data module's
producer thread, which the profiler does not record) above the card's
stream; a gap in the stream belongs to the innermost span the host was in
at the time (the backward's work is on autograd's own thread, inside
``vlgae.backward``).

Data-parallel over N devices, one process each, unchanged otherwise:

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m vlgae_tpu_torch.train exp=vlgae ... [device=cuda|cpu]

(NCCL on ``cuda:LOCAL_RANK``, gloo with ``device=cpu``). Each rank steps on
its rows of the same global batches; rank 0 writes the run directory,
the checkpoints, the predictions and the metric lines.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from .parallel.mesh import init_distributed, rank0_value, shutdown
from .predict import build_datamodule, compose, setup_device
from .training.factory import build_model
from .training.pipeline import Pipeline, init_params
from .utils.logger import MetricLogger, WandbWatcher

_OPTIONS = ("init_seed", "weights", "device")
# Hydra's sweep functions, which a comma split would misread as choices
_SWEEP_FUNCTIONS = ("range(", "glob(", "interval(", "shuffle(", "sort(", "tag(")


def _sweep_axes(overrides):
    """``(fixed overrides, [(key, choices)])``: a value with a comma is a
    choice sweep unless bracketed, braced or quoted (a coefficient
    schedule ``"[0@0, 0.5@100]"`` keeps its commas)."""
    fixed, axes = [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if val.strip().startswith(_SWEEP_FUNCTIONS):
            raise ValueError(
                f"multirun: the Hydra sweep function in {ov!r} is not supported; "
                "only comma-list choice sweeps (key=a,b,c) are")
        if "," in val and val[:1] not in "[{'\"" and not val.endswith("]"):
            axes.append((key, val.split(",")))
        else:
            fixed.append(ov)
    return fixed, axes


def multirun(overrides):
    """Every combination of the choice sweeps, one run each under
    ``outputs/multirun/<time>/<job>`` (with a ``multirun.json``), and one
    JSON line a run in ``results.jsonl``. The runs share a 4-character
    group id, exported as ``MULTIRUN_ID`` while they run."""
    import contextlib
    import itertools
    import random
    import string

    fixed, axes = _sweep_axes(overrides)
    # under torchrun every rank runs the same jobs in rank 0's directories
    dp = init_distributed(setup_device(_split_options(fixed)[0]["device"]))
    prior = os.environ.get("MULTIRUN_ID")
    group = prior or "".join(random.choice(string.ascii_letters + string.digits)
                             for _ in range(4))
    os.environ["MULTIRUN_ID"] = group
    group, sweep_dir = rank0_value(
        (group, os.path.join("outputs", "multirun", time.strftime("%Y-%m-%d_%H-%M-%S"))), dp)
    writer = dp.rank == 0
    if writer:
        os.makedirs(sweep_dir, exist_ok=True)
    results = []
    try:
        with (open(os.path.join(sweep_dir, "results.jsonl"), "w") if writer
              else contextlib.nullcontext()) as rf:
            for job, combo in enumerate(itertools.product(*(v for _, v in axes))):
                swept = [f"{k}={v}" for (k, _), v in zip(axes, combo)]
                workdir = os.path.join(sweep_dir, str(job))
                pipe, test = main(fixed + swept + [f"workdir={workdir}"])
                line = {"group": group, "job": job, "overrides": swept,
                        "best": pipe.best, "test": test}
                if writer:
                    with open(os.path.join(workdir, "multirun.json"), "w") as f:
                        json.dump({"group": group, "job": job, "overrides": fixed + swept}, f)
                    rf.write(json.dumps(line, default=float) + "\n")
                    rf.flush()
                results.append(line)
    finally:
        if prior is None:
            os.environ.pop("MULTIRUN_ID", None)
    return results


def _profiler(workdir, device):
    """A ``torch.profiler`` stepped once an update: the first update
    skipped, the second a warm-up, updates 3-5 recorded and exported as a
    Chrome trace into ``<workdir>/profile``."""
    import torch

    folder = os.path.join(workdir, "profile")
    os.makedirs(folder, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    def export(prof):
        prof.export_chrome_trace(os.path.join(folder, f"trace_step{prof.step_num}.json"))

    return torch.profiler.profile(
        activities=activities, on_trace_ready=export,
        schedule=torch.profiler.schedule(wait=1, warmup=1, active=3, repeat=1))


def _split_options(args):
    opts = {"init_seed": None, "weights": None, "device": "cuda"}
    rest = []
    for ov in args:
        key, sep, value = ov.partition("=")
        if sep and key in _OPTIONS:
            opts[key] = value
        else:
            rest.append(ov)
    return opts, rest


def main(argv=None):
    args = list(argv if argv is not None else sys.argv[1:])
    if "-m" in args or "--multirun" in args:
        return multirun([a for a in args if a not in ("-m", "--multirun")])
    search_params = os.environ.get("VLGAE_SEARCH_PARAMS")
    if search_params:
        args += [f"{k}={v}" for k, v in json.loads(search_params).items()]
    opts, overrides = _split_options(args)
    # reuse a previous run's overrides
    pre = []
    for ov in list(overrides):
        if ov.startswith("load_cfg_from_checkpoint="):
            saved = os.path.join(ov.split("=", 1)[1], "overrides.json")
            if os.path.exists(saved):
                with open(saved) as f:
                    pre = json.load(f)
            overrides.remove(ov)
    overrides = pre + overrides
    cfg = compose(overrides)

    seed = cfg.get("seed") or 0
    np.random.seed(seed)
    device = setup_device(opts["device"])
    # under torchrun: this rank's device; rank 0 writes the run directory
    dp = init_distributed(device)
    writer = dp.rank == 0
    workdir = rank0_value(cfg.get("workdir") or os.path.join(
        "outputs", str(cfg.get("name", "run")), time.strftime("%Y-%m-%d_%H-%M-%S")), dp)
    if writer:
        os.makedirs(os.path.join(workdir, "checkpoint"), exist_ok=True)
        with open(os.path.join(workdir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        with open(os.path.join(workdir, "overrides.json"), "w") as f:
            json.dump(overrides, f)
        latest = os.path.join("outputs", "0_latest_run")
        try:
            if os.path.islink(latest):
                os.unlink(latest)
            os.makedirs("outputs", exist_ok=True)
            os.symlink(os.path.abspath(workdir), latest)
        except OSError:
            pass

    dm = build_datamodule(cfg)
    if writer:
        for vname, vocab in dm.vocabs.items():
            vocab.save(os.path.join(workdir, f"vocab_{vname}.txt"))
    model = build_model(cfg, dm)
    init_params(model, int(opts["init_seed"]) if opts["init_seed"] is not None else seed)
    pipe = Pipeline(model, dm, cfg, device=device, workdir=workdir, seed=seed)
    if opts["weights"]:
        pipe.load_weights(opts["weights"])
    pipe.setup_optimizer()
    trainer_cfg = cfg.get("trainer", {})

    warm = cfg.get("pipeline", {}).get("load_from_checkpoint")
    resume = trainer_cfg.get("resume_from_checkpoint")
    start_epoch = 0
    if warm:
        pipe.load_checkpoint(warm)  # weights only
    elif resume:
        pipe.load_checkpoint(resume, load_training_state=True)
        start_epoch = pipe.epoch + 1

    max_epochs = int(trainer_cfg.get("max_epochs", 50))
    max_steps = int(trainer_cfg.get("max_steps", -1) or -1)
    mlog = MetricLogger(workdir if writer else None,
                        use_wandb=writer and bool(cfg.get("wandb")),
                        project=str(cfg.get("project", "vlgae_tpu")),
                        name=str(cfg.get("name", "run")), config=cfg, quiet=not writer)
    if cfg.get("wandb") and cfg.get("watch_model") is not None:
        pipe.watcher = WandbWatcher(**dict(cfg.get("watch_model") or {}), writer=writer)
    if writer and cfg.get("profile"):
        pipe.profiler = _profiler(workdir, device)
        pipe.profiler.start()
    pipe.normalize_embeddings("begin")
    min_lr_stop = float(trainer_cfg.get("min_lr_stop", 0.0) or 0.0)
    val_check = float(trainer_cfg.get("val_check_interval", 1.0) or 1.0)
    start_patience = int(trainer_cfg.get("start_patience", 0) or 0)

    def run_validation(epoch, mid_epoch=False):
        val, val_out = pipe.evaluate("dev")
        watch = val.get(pipe.watch_field.split("/", 1)[-1], val.get("loss"))
        if epoch >= start_patience and pipe.is_better(watch):
            pipe.best = watch
            pipe.save_checkpoint("best")
            if writer:
                pipe.write_predictions(os.path.join(workdir, "dev.predict.txt"),
                                       "dev", val_out)
        if mid_epoch:
            mlog.log({**pipe.window_train_terms,
                      **{f"val/{k}": v for k, v in val.items()},
                      "epoch": epoch, "mid_epoch": True}, step=pipe.step)
        pipe.plateau_step(watch)
        return val

    for epoch in range(start_epoch, max_epochs):
        pipe.normalize_embeddings("epoch")
        stats = pipe.train_epoch(
            epoch, val_fn=lambda e=epoch: run_validation(e, mid_epoch=True),
            val_check_interval=val_check)
        val = run_validation(epoch)
        mlog.log({**stats, **{f"val/{k}": v for k, v in val.items()},
                  "epoch": epoch}, step=pipe.step)
        pipe.save_checkpoint("last")
        if 0 < max_steps <= pipe.step:
            break
        if min_lr_stop > 0 and pipe.current_lr() < min_lr_stop:
            if writer:
                print(json.dumps({"early_stop": "lr below min", "epoch": epoch}))
            break

    if pipe.profiler is not None:
        pipe.profiler.stop()
        pipe.profiler = None

    best_path = os.path.join(workdir, "checkpoint", "best.pt")
    if os.path.exists(best_path):
        pipe.load_checkpoint(best_path)
    test, test_out = pipe.evaluate("test", metric_idx=1)
    mlog.log({f"test/{k}": v for k, v in test.items()}, step=pipe.step)
    if writer:
        pipe.write_predictions(os.path.join(workdir, "test.predict.txt"), "test", test_out)
    result_path = os.environ.get("VLGAE_SEARCH_RESULT")
    if result_path and writer:
        with open(result_path, "w") as f:
            json.dump({"best": pipe.best, "test": test}, f, default=float)
    return pipe, test


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
