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
    def __init__(self, workdir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "vlgae_tpu", name: Optional[str] = None,
                 config: Optional[dict] = None):
        self.path = os.path.join(workdir, "metrics.jsonl") if workdir else None
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
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)


class WandbWatcher:
    """Histograms of the parameters and/or gradients every ``log_freq``
    updates (``log``: gradients | parameters | all | none, as
    ``wandb.watch``), built on the host from ``named_parameters()``. Inert
    when the wandb package is absent or no run is active."""

    def __init__(self, log: str = "gradients", log_freq: int = 100):
        self.log_mode = log
        self.log_freq = max(1, int(log_freq))
        try:
            import wandb

            self._wandb = wandb
        except Exception:
            self._wandb = None

    @property
    def active(self) -> bool:
        return (self._wandb is not None
                and getattr(self._wandb, "run", None) is not None
                and self.log_mode != "none")

    def should_log(self, step: int) -> bool:
        return self.active and step % self.log_freq == 0

    def log_trees(self, step: int, named_parameters):
        if not self.active:
            return
        payload = {}
        for name, p in named_parameters:
            if self.log_mode in ("parameters", "all"):
                payload[f"parameters/{name}"] = self._wandb.Histogram(
                    p.detach().float().cpu().numpy().ravel())
            if self.log_mode in ("gradients", "all") and p.grad is not None:
                payload[f"gradients/{name}"] = self._wandb.Histogram(
                    p.grad.detach().float().cpu().numpy().ravel())
        if payload:
            self._wandb.log(payload, step=step)
