"""Seeded weights: every parameter and BatchNorm statistic of the model,
made on the device from ``--seed`` in one draw.

One float32 standard normal of the total size comes from a
``torch.Generator`` on the device; each leaf takes its slice, scaled to its
rule. The rules give a trained model's scale, not an initialiser's: no leaf
is zero, so that every leaf has a gradient from the first step (a fresh
model's zero class embedding would give every encoder a zero gradient):

- matrices, convolutions and stacked kernels: std 1 / sqrt(fan_in);
- embedding tables, positions and the CLS token: std 0.02;
- norm scales: 1 + 0.1 z; biases: 0.02 z;
- BatchNorm running means 0.1 z and running variances exp(0.2 z).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from portbench.reference import model as ref


def leaf_rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a leaf's normal draw."""
    if name.endswith("running_mean"):
        return 0.0, 0.1
    if name.endswith("running_var"):
        return 0.0, 0.2  # exponentiated
    if name.endswith(("embeddings.weight", ".pos", ".cls_token")):
        return 0.0, 0.02
    if name.endswith(".scale") or (name.endswith(".weight") and len(shape) == 1):
        return 1.0, 0.1
    if name.endswith(".bias") or name == "capsule_head.bias":
        return 0.0, 0.02
    if name.endswith(".kernel"):
        return 0.0, 1.0 / math.sqrt(shape[-2])
    if name in ("capsule_head.w", "capsule_head.embedding"):
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def leaf_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    shapes = dict(ref.param_shapes(cfg))
    shapes.update({n: (c,) for n, c in ref.running_stat_names(shapes).items()})
    return shapes


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's state_dict (parameters and BatchNorm statistics), float32
    on `device`, the same for the same seed."""
    shapes = leaf_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = leaf_rule(name, shape)
        leaf = flat[offset:offset + n].view(shape).mul_(std).add_(mean)
        out[name] = leaf.exp_() if name.endswith("running_var") else leaf
        offset += n
    return out
