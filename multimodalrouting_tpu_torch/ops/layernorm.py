"""LayerNorm in the JAX package's two precisions (counterpart of
multimodalrouting_tpu/ops/layernorm.py and of flax's nn.LayerNorm).

``layer_norm`` is flax's chain: float32 statistics (E[x^2] - E[x]^2, clipped
at 0) and a float32 normalize + affine, cast to the compute dtype.
``fast_layer_norm`` (encoder.bert_ln="bf16") keeps the statistics and rsqrt
in float32 but runs the per-element normalize + affine in the compute dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from multimodalrouting_tpu_torch.models import init


def _stats(x: torch.Tensor, eps: float):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return xf, mean, torch.rsqrt(var + eps)


def layer_norm(x, weight, bias, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=dtype): all-fp32 normalize + affine, one cast."""
    xf, mean, inv = _stats(x, eps)
    return ((xf - mean) * (inv * weight.float()) + bias.float()).to(dtype)


def fast_layer_norm(x, weight, bias, eps: float) -> torch.Tensor:
    """fp32 statistics, normalize + affine in x's dtype."""
    _, mean, inv = _stats(x, eps)
    dt = x.dtype
    y = (x - mean.to(dt)) * inv.to(dt)
    return y * weight.to(dt) + bias.to(dt)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm counterpart; parameters stay float32."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        init.param(self, "weight", init.ones, (features,))
        init.param(self, "bias", init.zeros, (features,))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


class FastLayerNorm(LayerNorm):
    """FastLayerNorm counterpart: x is cast to the compute dtype on entry."""

    def forward(self, x):
        return fast_layer_norm(x.to(self.dtype), self.weight, self.bias, self.eps)


def bert_layer_norm(impl: str, features: int, eps: float, dtype: torch.dtype) -> LayerNorm:
    """encoder.bert_ln: "bf16" -> FastLayerNorm, "fp32" -> the flax chain."""
    cls = FastLayerNorm if impl == "bf16" else LayerNorm
    return cls(features, eps, dtype)
