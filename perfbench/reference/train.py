"""The reference's first training steps: the joint loss, its gradients by
autograd, the global-norm clip and Adam, from the same weights, inputs and
dropout generator seed as the program's first steps.

The optimizer is the recipe's (``exp=vlgae`` composes ``optimize: linear``
and the trainer's clip): Adam at a base rate of 1e-3, decayed by
``0.75 ** (1 / 2000)`` a step from update 0, betas (0.9, 0.999), eps 1e-12,
the gradients clipped to a global norm of 5 first."""

from __future__ import annotations

import torch

from . import model


LR = 1e-3
GAMMA = 0.75 ** (1 / 2000)
CLIP = 5.0
BETAS = (0.9, 0.999)
EPS = 1e-12


def lr_at(step: int) -> float:
    """The recipe's learning rate at update ``step`` (0 first)."""
    return LR * GAMMA ** step


def first_steps(W0, c, batches, tag_names, seed, alpha):
    """``{"loss": [per step], "grad": {leaf: norm of the first clipped
    gradient}, "change": {leaf: norm of the change after the steps}}``."""
    dev = next(iter(W0.values())).device
    W = {k: v.detach().clone() for k, v in W0.items()}
    names = [k for k in sorted(W) if not model.frozen(k)]
    for k in names:
        W[k].requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    m = {k: torch.zeros_like(W[k]) for k in names}
    v = {k: torch.zeros_like(W[k]) for k in names}
    out = {"loss": [], "grad": {}, "change": {}, "tied": []}
    for step, x in enumerate(batches):
        o = model.forward(W, c, x, tag_names, model.Drops(gen))
        L = model.loss(o, x, alpha)
        grads = torch.autograd.grad(L, [W[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(W[k]) if g is None else g for k, g in zip(names, grads)]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = torch.where(norm < CLIP, torch.ones_like(norm), CLIP / norm)
        grads = [g * scale for g in grads]
        out["loss"].append(float(L.detach()))
        out["tied"].append(int(o["tied"].sum()))
        if step == 0:
            out["grad"] = {k: float(g.norm()) for k, g in zip(names, grads)}
        t = step + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[k].sqrt() / (1 - BETAS[1] ** t) ** 0.5).add_(EPS)
                W[k].addcdiv_(m[k], denom, value=-lr_at(step) / (1 - BETAS[0] ** t))
        del o, L, grads
    out["change"] = {k: float((W[k].detach() - W0[k]).norm()) for k in names}
    return out
