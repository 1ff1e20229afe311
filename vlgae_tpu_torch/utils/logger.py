"""Metric logging (counterpart of vlgae_tpu/utils/logger.py): JSON lines
on stdout and in ``<workdir>/metrics.jsonl``, and wandb when the package is
importable. Without it (or when its run fails to start) the wandb side
goes quietly inert and the JSON lines remain.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    """``quiet``: print nothing (the ranks other than 0 of a data-parallel
    run, which also pass no ``workdir``)."""

    def __init__(self, workdir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "vlgae_tpu", name: Optional[str] = None,
                 config: Optional[dict] = None, quiet: bool = False):
        self.path = os.path.join(workdir, "metrics.jsonl") if workdir else None
        self.quiet = quiet
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=name, config=config)
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"time": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        line = json.dumps(rec, default=float)
        if not self.quiet:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)


class WandbWatcher:
    """Histograms of the parameters and/or gradients every ``log_freq``
    updates (``log``: gradients | parameters | all | none, as
    ``wandb.watch``), built on the host. Inert when the wandb package is
    absent or no run is active. In a data-parallel run every rank holds
    one and passes it the whole tensors at the same updates (gathering a
    sharded leaf is a collective); only the ``writer`` logs them."""

    def __init__(self, log: str = "gradients", log_freq: int = 100, writer: bool = True):
        self.log_mode = log
        self.log_freq = max(1, int(log_freq))
        self.writer = writer
        try:
            import wandb

            self._wandb = wandb
        except Exception:
            self._wandb = None

    @property
    def active(self) -> bool:
        return (self.writer and self._wandb is not None
                and getattr(self._wandb, "run", None) is not None
                and self.log_mode != "none")

    def should_log(self, step: int) -> bool:
        """Whether update ``step`` is logged: the same answer on every rank."""
        return (self._wandb is not None and self.log_mode != "none"
                and step % self.log_freq == 0)

    def log_trees(self, step: int, trees):
        """``trees``: ``(name, value, gradient or None)`` of every parameter,
        consumed whole on every rank."""
        payload = {}
        for name, value, grad in trees:
            if not self.active:
                continue
            if self.log_mode in ("parameters", "all"):
                payload[f"parameters/{name}"] = self._wandb.Histogram(
                    value.detach().float().cpu().numpy().ravel())
            if self.log_mode in ("gradients", "all") and grad is not None:
                payload[f"gradients/{name}"] = self._wandb.Histogram(
                    grad.detach().float().cpu().numpy().ravel())
        if payload:
            self._wandb.log(payload, step=step)
