"""Adam with regex parameter groups, learning-rate schedules, global-norm
clipping and ReduceLROnPlateau (counterpart of
vlgae_tpu/training/optim.py, which builds the same with optax).

Parameters are matched by regex against their flax path joined with dots
(``params.dependency.embedding.transformer.bert...``), so the patterns of
the JAX configs select the same tensors. Frozen parameters stay out of the
optimizer. Every parameter of the optimizer steps on every update (a
parameter that received no gradient steps with a zero one), so the
bias corrections of Adam count updates as optax's global count does, and
the learning rate of update ``k`` (0-based) is ``schedule(k)``.

Under data parallelism the gradients are summed over the ranks before the
clip; with FSDP each rank's Adam steps the local shards of the sharded
parameters in place (plain tensors, so the foreach update is that of whole
tensors, elementwise), its moments are shards too, and the clip's norm
sums the shards' squares over the ranks. A tensor-parallel parameter is a
plain tensor holding this model rank's slice: Adam steps it as it is, and
the clip sums its squares over the model group.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import torch

from ..convert import torch_to_flax_key
from ..parallel.mesh import (DataGroup, all_reduce_grads, full_tensor, global_sum,
                             is_sharded, local, shard_like, tp_spec)


def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule: ``init`` -> ``end`` over ``steps``, then flat."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def _join(schedules, boundaries):
    """optax.join_schedules: schedule ``i`` from boundary ``i - 1`` on,
    counted from that boundary."""

    def f(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out

    return f


def make_schedule(args: Dict[str, Any], base_lr: float, steps_per_epoch: int = 1):
    """A step -> learning-rate function from reference-style scheduler
    args (``gamma: "0.75**(1/2000)"``, ``"N epoch"`` step counts)."""
    target = args.get("_target_", "")

    def resolve(v):
        if isinstance(v, str) and v.endswith(" epoch"):
            return int(v.split()[0]) * steps_per_epoch
        if isinstance(v, str):
            return float(eval(v, {"__builtins__": {}}, {}))
        return v

    if "exponential" in target:
        gamma = resolve(args["gamma"])
        return lambda step: base_lr * gamma ** step
    if "linear_schedule_with_warmup" in target or "linear" in target:
        warmup = int(resolve(args.get("num_warmup_steps", 0)))
        total = int(resolve(args.get("num_training_steps", 10 ** 9)))
        up = _linear(0.0, base_lr, warmup)
        if total <= warmup:
            return up
        return _join([up, _linear(base_lr, 0.0, max(total - warmup, 1))], [warmup])
    if "constant_schedule_with_warmup" in target:
        warmup = int(resolve(args.get("num_warmup_steps", 0)))
        return _join([_linear(0.0, base_lr, warmup), lambda count: base_lr], [warmup])
    return lambda count: base_lr


class ReduceLROnPlateau:
    """Host-side plateau scaling of the learning rate: after more than
    ``patience`` validations without improvement the scale shrinks by
    ``factor`` (not below ``min_lr / base_lr``)."""

    def __init__(self, mode="min", factor=0.5, patience=2, min_lr=0.0):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = None
        self.bad = 0
        self.scale = 1.0

    def step(self, value: float, base_lr: float) -> float:
        better = (self.best is None
                  or (value < self.best if self.mode == "min" else value > self.best))
        if better:
            self.best = value
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr / max(base_lr, 1e-30))
                self.bad = 0
        return self.scale

    def state_dict(self):
        return {"best": self.best, "bad": self.bad, "scale": self.scale}

    def load_state_dict(self, state):
        self.best, self.bad, self.scale = state["best"], state["bad"], state["scale"]


def clip_by_global_norm_(params, max_norm: float, dp: DataGroup = DataGroup()
                         ) -> torch.Tensor:
    """Scale every gradient by ``max_norm / norm`` when the global norm of
    all of them is at least ``max_norm`` (``optax.clip_by_global_norm``: no
    epsilon, unlike ``clip_grad_norm_``). Sharded gradients count with every
    rank's shard (their squares summed over ``dp``, or over the model group
    for a tensor-parallel slice), whole ones once. Returns the norm; no host
    sync."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    parts = [local(g) for g in grads]
    norms = torch.stack(torch._foreach_norm(parts))
    split = [is_sharded(g) for g in grads]
    tp = [tp_spec(p) for p in params]
    if not any(split) and not any(tp):
        norm = torch.linalg.vector_norm(norms)
    else:
        sq = norms * norms
        mp = next((t[1] for t in tp if t is not None), None)
        split = torch.tensor(split, device=sq.device)
        sliced = torch.tensor([t is not None for t in tp], device=sq.device)
        total = sq[~split & ~sliced].sum() + global_sum(sq[split].sum(), dp)
        if mp is not None:
            total = total + global_sum(sq[sliced].sum(), mp)
        norm = torch.sqrt(total)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(parts, scale)
    return norm


def adam_(params, grads, exp_avgs, exp_avg_sqs, steps, lr, beta1: float, beta2: float,
          eps: float) -> None:
    """One Adam update of ``params`` in place from device tensors alone:
    ``lr`` a 0-dim tensor, ``steps`` each parameter's update count as a
    0-dim f32 tensor (counted up here), nothing read on the host, so that
    a CUDA graph can hold it. The arithmetic of ``torch.optim.Adam`` with
    ``capturable=True`` (bias corrections on the device), which takes no
    CPU tensors; the float learning rate of :meth:`Optimizer.update`
    rounds the same quantities in another order."""
    with torch.no_grad():
        torch._foreach_add_(steps, 1)
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
        step_size = torch._foreach_pow(beta1, steps)
        bc2_sqrt = torch._foreach_pow(beta2, steps)
        torch._foreach_sub_(step_size, 1)
        torch._foreach_sub_(bc2_sqrt, 1)
        torch._foreach_neg_(bc2_sqrt)
        torch._foreach_div_(step_size, lr)
        torch._foreach_reciprocal_(step_size)  # -lr / (1 - beta1^t)
        torch._foreach_sqrt_(bc2_sqrt)  # sqrt(1 - beta2^t)
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, bc2_sqrt)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(denom, step_size)
        torch._foreach_addcdiv_(params, exp_avgs, denom)


class Optimizer:
    """``torch.optim.Adam`` (``AdamW`` with weight decay) over regex
    groups, each with its own schedule, a global-norm clip before the
    update and an optional plateau scale on every learning rate."""

    def __init__(self, model: torch.nn.Module, optimizer_cfg: Dict[str, Any],
                 scheduler_cfg: Optional[Dict[str, Any]] = None,
                 steps_per_epoch: int = 1, gradient_clip_val: float = 0.0,
                 frozen_patterns: Optional[List[str]] = None,
                 dp: DataGroup = DataGroup()):
        args = dict(optimizer_cfg.get("args", {"lr": 1e-3}))
        args.pop("_target_", None)
        self.base_lr = float(args.pop("lr", 1e-3))
        betas = args.pop("betas", (0.9, 0.999))
        eps = float(args.pop("eps", 1e-12))
        wd = float(args.pop("weight_decay", 0.0))
        self.clip = float(gradient_clip_val or 0.0)
        self.plateau = None
        sched_args = None
        if scheduler_cfg:
            sched_args = dict(scheduler_cfg.get("args", {}))
            target = str(sched_args.get("_target_", ""))
            if "ReduceLROnPlateau" in target or "plateau" in target.lower():
                self.plateau = ReduceLROnPlateau(**{
                    k: v for k, v in sched_args.items()
                    if k in ("mode", "factor", "patience", "min_lr")})
                sched_args = None

        groups = list(optimizer_cfg.get("groups") or [])
        frozen = list(frozen_patterns or [])
        buckets: List[List[torch.nn.Parameter]] = [[] for _ in range(len(groups) + 1)]
        for name, p in model.named_parameters():
            path = "params." + torch_to_flax_key(name, p.dim()).replace("/", ".")
            if any(re.search(pat, path) for pat in frozen):
                continue
            idx = next((i + 1 for i, g in enumerate(groups)
                        if re.search(g["pattern"], path)), 0)
            buckets[idx].append(p)
        lrs = [self.base_lr] + [float(g.get("lr", self.base_lr)) for g in groups]
        self.schedules = [
            make_schedule(sched_args, lr, steps_per_epoch) if sched_args
            else (lambda count, lr=lr: lr) for lr in lrs]
        self.dp = dp
        self.params = [p for b in buckets for p in b]
        # Adam steps what this rank holds: a sharded parameter's local shard
        # (a view of its storage), a whole parameter itself
        self._held = {id(p): local(p).detach() if is_sharded(p) else p for p in self.params}
        param_groups = [{"params": [self._held[id(p)] for p in b], "lr": lr}
                        for b, lr in zip(buckets, lrs) if b]
        self._sched_of_group = [s for b, s in zip(buckets, self.schedules) if b]
        cls = torch.optim.AdamW if wd > 0 else torch.optim.Adam
        kw = {"weight_decay": wd} if wd > 0 else {}
        self.opt = cls(param_groups, betas=(float(betas[0]), float(betas[1])),
                       eps=eps, **kw)
        # a learning-rate tensor a group, for update_on_device
        self._lrs = None

    def lr_at(self, step: int) -> float:
        """The learning rate of the default group at update ``step``."""
        scale = self.plateau.scale if self.plateau is not None else 1.0
        return float(self.schedules[0](step)) * scale

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, step: int) -> None:
        """:meth:`sum_grads`, then :meth:`update`."""
        self.sum_grads()
        self.update(step)

    def sum_grads(self) -> None:
        """Sum the gradients over the ranks (zeros where none flowed): the
        gradient of the global batch's loss on every rank."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_grads(self.params, self.dp)

    def update(self, step: int) -> None:
        """Clip the summed gradients, set each group's learning rate for
        update ``step``, and apply Adam."""
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip, self.dp)
        for p in self.params:
            held = self._held[id(p)]
            if held is not p:
                held.grad = local(p.grad).detach()
        scale = self.plateau.scale if self.plateau is not None else 1.0
        for group, sched in zip(self.opt.param_groups, self._sched_of_group):
            group["lr"] = float(sched(step)) * scale
        self.opt.step()

    def on_device(self) -> None:
        """Ready :meth:`update_on_device`: each parameter's Adam state on
        its device (moments zero before its first update, the update count
        a 0-dim f32 tensor) and a learning-rate tensor a group. Only for
        whole parameters (world 1) and Adam without weight decay."""
        for group in self.opt.param_groups:
            for p in group["params"]:
                st = self.opt.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                elif st["step"].device != p.device:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
        if self._lrs is None:
            self._lrs = [torch.zeros((), dtype=torch.float32, device=g["params"][0].device)
                         for g in self.opt.param_groups]

    def set_lr_on_device(self, step: int) -> None:
        """Write each group's learning rate of update ``step`` (the
        schedule times the plateau scale) into its tensor: a fill a group,
        outside any graph."""
        scale = self.plateau.scale if self.plateau is not None else 1.0
        for lr, sched in zip(self._lrs, self._sched_of_group):
            lr.fill_(float(sched(step)) * scale)

    def update_on_device(self) -> None:
        """Clip, Adam (:func:`adam_`, at the rates of
        :meth:`set_lr_on_device`) and the gradients zeroed in place (their
        storage kept): device work alone, which a CUDA graph can hold.
        After :meth:`on_device`."""
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip, self.dp)
        for group, lr in zip(self.opt.param_groups, self._lrs):
            ps = group["params"]
            st = [self.opt.state[p] for p in ps]
            beta1, beta2 = group["betas"]
            adam_(ps, [p.grad for p in ps], [s["exp_avg"] for s in st],
                  [s["exp_avg_sq"] for s in st], [s["step"] for s in st], lr,
                  beta1, beta2, group["eps"])
        torch._foreach_zero_([p.grad for p in self.params])

    def _moments(self, adam, convert):
        """``adam`` (an Adam state dict) with each sharded or
        tensor-parallel parameter's moments passed through ``convert(moment,
        param)``."""
        state = {i: {k: convert(v, p) if k != "step" and (is_sharded(p) or tp_spec(p))
                     else v
                     for k, v in st.items()}
                 for i, st in adam["state"].items()
                 for p in (self.params[int(i)],)}
        return {**adam, "state": state}

    def state_dict(self):
        """Adam's and the plateau's state, the moments whole: the same dict
        with FSDP as without."""
        from torch.distributed.tensor import DTensor

        def whole(m, p):
            if tp_spec(p):
                return full_tensor(m, p)
            return DTensor.from_local(m, p.device_mesh, p.placements).full_tensor()

        return {"adam": self._moments(self.opt.state_dict(), whole),
                "plateau": self.plateau.state_dict() if self.plateau else None}

    def load_state_dict(self, state):
        self.opt.load_state_dict(self._moments(
            state["adam"], lambda m, p: shard_like(m.to(local(p).device), p).clone()))
        if self.plateau is not None and state.get("plateau"):
            self.plateau.load_state_dict(state["plateau"])
