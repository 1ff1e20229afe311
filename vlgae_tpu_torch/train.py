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

Not ported (each raises ``NotImplementedError``): multirun (``-m``), wandb,
the hyperparameter-search bridge (``VLGAE_SEARCH_PARAMS``) and the
profiler trace (``profile``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from .predict import build_datamodule, compose, setup_device
from .training.factory import build_model
from .training.pipeline import Pipeline, init_params

_OPTIONS = ("init_seed", "weights", "device")


class MetricLogger:
    """JSON lines on stdout and in ``<workdir>/metrics.jsonl``."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "metrics.jsonl")

    def log(self, metrics: dict, step=None):
        rec = {"time": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        line = json.dumps(rec, default=float)
        print(line, flush=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")


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
        raise NotImplementedError("multirun (-m) is not ported")
    if os.environ.get("VLGAE_SEARCH_PARAMS"):
        raise NotImplementedError("the hyperparameter-search bridge is not ported")
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
    if cfg.get("wandb"):
        raise NotImplementedError("wandb logging is not ported")
    if cfg.get("profile"):
        raise NotImplementedError("the profiler trace of a training run is not ported")

    seed = cfg.get("seed") or 0
    np.random.seed(seed)
    workdir = cfg.get("workdir") or os.path.join(
        "outputs", str(cfg.get("name", "run")), time.strftime("%Y-%m-%d_%H-%M-%S"))
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

    device = setup_device(opts["device"])
    dm = build_datamodule(cfg)
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
    mlog = MetricLogger(workdir)
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
            print(json.dumps({"early_stop": "lr below min", "epoch": epoch}))
            break

    best_path = os.path.join(workdir, "checkpoint", "best.pt")
    if os.path.exists(best_path):
        pipe.load_checkpoint(best_path)
    test, test_out = pipe.evaluate("test", metric_idx=1)
    mlog.log({f"test/{k}": v for k, v in test.items()}, step=pipe.step)
    pipe.write_predictions(os.path.join(workdir, "test.predict.txt"), "test", test_out)
    return pipe, test


if __name__ == "__main__":
    main()
