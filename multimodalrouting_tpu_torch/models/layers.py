"""Linear layers with the flax modules' precision rules.

flax's nn.Dense / nn.Embed / nn.Conv keep float32 parameters and cast them,
and the input, to the compute dtype at every use. These modules do the same,
so a float32 model and a bfloat16 one share one state_dict; a parameter
stored in the compute dtype already (the frozen BERT body) is used as is.
``StackedDense`` holds G independent Dense layers as one [G, in, out] weight
in the JAX layout, applied to a leading stream axis with one batched matmul.
``dropout`` is flax's nn.Dropout, drawing from an explicit generator.

Fresh weights come from ``models/init.py``, as flax draws them: ``Dense``'s
kernel from ``kernel_init`` on its JAX shape [in, out] (flax's default,
``lecun_normal``, unless the caller passes another, as the attention
projections pass ``xavier_uniform``), biases zeros, ``Embed`` flax's
default embedding init (a normal of std features^-1/2), and
``StackedDense`` ``kernel_init`` on each [in, out] slice (``nn.vmap``'s
per-slice init). ``tests/test_torch_init.py`` holds them against flax.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models import init


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype: torch.dtype = torch.float32,
                 kernel_init=init.lecun_normal):
        super().__init__()
        init.param(self, "weight", kernel_init, (d_in, d_out), (d_out, d_in))
        if bias:
            init.param(self, "bias", init.zeros, (d_out,))
        else:
            self.bias = None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Embed(nn.Module):
    def __init__(self, num: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        init.param(self, "weight", init.embed_normal, (num, features))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.dtype)


class StackedDense(nn.Module):
    """G Dense layers: x [G, ..., in] -> [G, ..., out]."""

    def __init__(self, g: int, d_in: int, d_out: int, dtype: torch.dtype = torch.float32,
                 kernel_init=init.lecun_normal):
        super().__init__()
        init.param(self, "kernel", init.stacked(kernel_init), (g, d_in, d_out))
        init.param(self, "bias", init.zeros, (g, d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        g = x.shape[0]
        flat = x.to(dt).reshape(g, -1, x.shape[-1])
        y = torch.baddbmm(self.bias.to(dt)[:, None, :], flat, self.kernel.to(dt))
        return y.reshape(*x.shape[:-1], -1)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout in train mode: keep each value with probability
    1 - rate and scale the kept ones by 1 / (1 - rate), in x's dtype. The
    identity when rate is 0 or no generator is given (inference)."""
    if rate <= 0.0 or generator is None:
        return x
    keep_p = 1.0 - rate
    if keep_p <= 0.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_p
    return torch.where(keep, x / keep_p, torch.zeros_like(x))
