"""flax's ``nn.initializers`` for the port's fresh weights.

Every parameter of a port model is drawn here, from the initializer that
flax uses for the same leaf of the JAX package. An initializer takes the
parameter's shape in the JAX layout (a Dense kernel [in, out], a conv kernel
[kh, kw, in, out], a stacked kernel [R, in, out]) and an optional
``generator``, and returns a float32 tensor in that layout. ``param``
registers it on a module and records the rule, which ``rules`` lists for a
whole model. A parameter whose port layout differs (``Dense.weight`` [out,
in], a conv weight [out, in, kh, kw]) is drawn straight into the port's
shape by ``fill``: its elements are independent draws, so only the fans
need the JAX shape, and no transposed copy is made.

Fans follow flax's ``_compute_fans``: the receptive field is the product of
every axis but ``in_axis`` and ``out_axis``, so a stacked [R, in, out]
kernel drawn whole counts its route axis into both fans. ``stacked`` draws
each leading slice on its own shape instead, as ``nn.vmap`` and the pipeline
layout's per-layer init do.

Draws come from torch's default generator unless one is given, so a model
is seeded as before (``torch.manual_seed``). The distribution, not the bits,
matches flax's: the random generators differ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

Shape = Tuple[int, ...]

# the standard deviation of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


def compute_fans(shape: Sequence[int], in_axis: int = -2, out_axis: int = -1) -> Tuple[float, float]:
    """(fan_in, fan_out) of a kernel of `shape`, as flax counts them."""
    if len(shape) < 2:
        raise ValueError(f"fans of a {len(shape)}-d shape are not defined")
    in_size, out_size = shape[in_axis], shape[out_axis]
    receptive = math.prod(shape) / in_size / out_size
    return in_size * receptive, out_size * receptive


@dataclass(frozen=True)
class VarianceScaling:
    """flax's ``variance_scaling``: std sqrt(scale / n), n the fan that
    `mode` names; a truncated normal is cut at two of its untruncated
    standard deviations."""

    scale: float
    mode: str  # fan_in | fan_out | fan_avg
    distribution: str  # truncated_normal | normal | uniform
    in_axis: int = -2
    out_axis: int = -1

    def std(self, shape: Sequence[int]) -> float:
        fan_in, fan_out = compute_fans(shape, self.in_axis, self.out_axis)
        n = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[self.mode]
        return math.sqrt(self.scale / n)

    def __call__(self, shape: Sequence[int], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fill(torch.empty(tuple(shape)), shape, generator)

    def fill(self, out: torch.Tensor, shape: Sequence[int], generator: Optional[torch.Generator] = None):
        """`out` (any shape) filled with independent draws at `shape`'s std."""
        std = self.std(shape)
        if self.distribution == "truncated_normal":
            # jax.random.truncated_normal's inverse CDF: a uniform draw between
            # the normal CDF at -2 and at 2, through erfinv, times s (one pass;
            # nn.init.trunc_normal_ rejects and redraws the whole tensor)
            s, edge = std / TRUNCATED_STD, math.erf(math.sqrt(2.0))
            out.uniform_(-edge, edge, generator=generator).erfinv_().mul_(math.sqrt(2.0) * s)
            return out.clamp_(-2.0 * s, 2.0 * s)
        if self.distribution == "normal":
            return out.normal_(0.0, std, generator=generator)
        if self.distribution == "uniform":
            limit = math.sqrt(3.0) * std
            return out.uniform_(-limit, limit, generator=generator)
        raise ValueError(f"unknown distribution {self.distribution!r}")


@dataclass(frozen=True)
class Normal:
    """flax's ``normal(stddev)``: an untruncated normal of a fixed std."""

    stddev: float

    def std(self, shape: Sequence[int]) -> float:
        return self.stddev

    def __call__(self, shape: Sequence[int], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fill(torch.empty(tuple(shape)), shape, generator)

    def fill(self, out: torch.Tensor, shape: Sequence[int], generator: Optional[torch.Generator] = None):
        return out.normal_(0.0, self.stddev, generator=generator)


@dataclass(frozen=True)
class Constant:
    """A leaf that no draw decides: a value for every element, or a nested
    tuple of the leaf's shape (a route-logit bias)."""

    value: Any

    def std(self, shape: Sequence[int]) -> float:
        return 0.0

    def __call__(self, shape: Sequence[int], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if isinstance(self.value, tuple):
            return torch.tensor(self.value, dtype=torch.float32).reshape(tuple(shape))
        return torch.full(tuple(shape), float(self.value))


@dataclass(frozen=True)
class Stacked:
    """`inner` drawn on each leading slice's own shape (fans without the
    leading axis), as JAX ``nn.vmap`` and ``parallel/pp.py``'s
    ``stacked`` draw it."""

    inner: Any

    def std(self, shape: Sequence[int]) -> float:
        return self.inner.std(shape[1:])

    def __call__(self, shape: Sequence[int], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.stack([self.inner(shape[1:], generator) for _ in range(shape[0])])


def variance_scaling(scale: float, mode: str, distribution: str, in_axis: int = -2,
                     out_axis: int = -1) -> VarianceScaling:
    return VarianceScaling(scale, mode, distribution, in_axis, out_axis)


def normal(stddev: float = 1e-2) -> Normal:
    return Normal(stddev)


def constant(value) -> Constant:
    return Constant(value)


def stacked(inner) -> Stacked:
    return Stacked(inner)


lecun_normal = variance_scaling(1.0, "fan_in", "truncated_normal")
xavier_uniform = variance_scaling(1.0, "fan_avg", "uniform")
# flax's default_embed_init: [num, features], both axes 0, so fan_in = features
embed_normal = variance_scaling(1.0, "fan_in", "normal", out_axis=0)
zeros = Constant(0.0)
ones = Constant(1.0)


def param(module: nn.Module, name: str, initializer, shape: Sequence[int],
          port_shape: Optional[Sequence[int]] = None) -> nn.Parameter:
    """Registers parameter `name` of `module`, drawn by `initializer` at
    `shape` (the JAX layout), or by its ``fill`` into `port_shape` where the
    port lays the parameter out otherwise, and records (initializer, shape)
    for ``rules``."""
    if port_shape is None:
        value = initializer(tuple(shape))
    else:
        value = initializer.fill(torch.empty(tuple(port_shape)), tuple(shape))
    p = nn.Parameter(value)
    module.register_parameter(name, p)
    module.__dict__.setdefault("_init_rules", {})[name] = (initializer, tuple(shape))
    return p


def rules(model: nn.Module) -> Dict[str, Tuple[Any, Shape]]:
    """(initializer, JAX-layout shape) of every parameter of `model` that
    ``param`` drew, by its ``named_parameters`` name."""
    out = {}
    for prefix, module in model.named_modules():
        for name, rule in module.__dict__.get("_init_rules", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = rule
    return out
