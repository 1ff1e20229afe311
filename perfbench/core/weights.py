"""The model's weights, made on the card from the seed.

One draw of standard normals for every random leaf together, from a
``torch.Generator`` on the card, cut into the leaves in the order of their
names and scaled by a rule on the name: biases, ``*_bias`` leaves and mixing
weights 0; norm scales 1; BERT leaves N(0, 0.02); the static
embedding tables N(0, 1); other matrices N(0, 1/fan_in). The program and
the reference are handed the same tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

TABLES = ("embedding", "root_emb", "dec_emb")


def rule(name: str, shape: Tuple[int, ...]):
    """``("zero" | "one" | "normal", scale)`` of a leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.endswith("_bias") or leaf == "weights":
        return "zero", 0.0
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return "one", 1.0
    if ".bert." in f".{name}":
        return "normal", 0.02
    if leaf in TABLES:
        return "normal", 1.0
    fan_in = shape[-1] if len(shape) == 2 else shape[0]
    return "normal", fan_in ** -0.5


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor}`` on ``device`` for ``(name, shape)`` pairs."""
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
