"""The model's weights, made on the card from the seed.

One draw of standard normals for every random leaf together, from a
``torch.Generator`` on the card, cut into the leaves in the order of their
names and scaled by the family's rule on the name (``weight_rule``). The
program and the reference are handed the same tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, rule: Callable) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor}`` on ``device`` for ``(name, shape)`` pairs;
    ``rule(name, shape) -> ("zero" | "one" | "normal", scale)``."""
    shapes = sorted((n, tuple(s)) for n, s in shapes)
    rules = [rule(n, s) for n, s in shapes]
    sizes = [torch.Size(s).numel() for s in (s for _, s in shapes)]
    n_random = sum(k for k, (r, _) in zip(sizes, rules) if r == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    draw = torch.randn(n_random, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), (kind, scale), k in zip(shapes, rules, sizes):
        if kind == "normal":
            out[name] = draw[at:at + k].view(shape).mul_(scale)
            at += k
        else:
            out[name] = torch.full(shape, scale, device=device, dtype=torch.float32)
    return out
