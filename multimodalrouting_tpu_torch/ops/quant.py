"""Dynamic int8 quantization for the frozen-BERT inference path
(counterpart of multimodalrouting_tpu/ops/quant.py, ``encoder.int8_text``).

The frozen note encoder is pure inference, so its six big matmuls per layer
(the q/k/v/out projections and the two FFN matmuls) can run as int8
products with int32 accumulation:

- weights: symmetric per-output-channel int8, scale = max|W[:, o]| / 127;
- activations: symmetric per-token int8, scale = max|x[t, :]| / 127;
- the product accumulates in int32, is dequantized in fp32, takes the bias
  in fp32 and is cast to the compute dtype.

Rounding is half to even (``torch.round``, as ``jnp.round``) and the clip
is +-127, so the int8 values and scales equal the JAX package's bit for bit.
Both quantizations run inside every forward and the master weights stay
fp32, so checkpoints, ``bridge.py`` and ``pretrained.py`` are untouched.

``int8_matmul`` is ``torch._int_mm``: the JAX package computes this product
with ``lax.dot_general`` outside any Pallas kernel, so a library product is
its counterpart here, not a hand-written kernel. On the card ``_int_mm``
takes more than 16 rows and inner and outer sizes that are multiples of 8
(BERT-base's 768 and 3072 are).

``QuantDense`` has no useful gradient (round is piecewise constant): the
model refuses it with fine-tuned notes (``models/clinbert.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from multimodalrouting_tpu_torch.models import init


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of fp32 maxima |x|."""
    return torch.clamp(amax / 127.0, min=1e-8)


def quantize_with_scale(x32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32 values -> int8 at scale `s` (broadcast), half to even, +-127."""
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)


def quantize_per_channel(w: torch.Tensor, axis: int = 0):
    """Symmetric int8 quantization of a kernel over `axis` (0 for the JAX
    layout [in, out], 1 for torch's [out, in]) -> (wq int8, scale fp32 with
    `axis` kept as 1)."""
    w32 = w.float()
    s = int8_scale(w32.abs().amax(dim=axis, keepdim=True))
    return quantize_with_scale(w32, s), s


def quantize_per_token(x: torch.Tensor):
    """Symmetric int8 quantization of activations over the last axis ->
    (xq int8, scale fp32 [..., 1])."""
    x32 = x.float()
    s = int8_scale(x32.abs().amax(dim=-1, keepdim=True))
    return quantize_with_scale(x32, s), s


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 @ [K, N] int8 -> [..., N] int32."""
    lead = xq.shape[:-1]
    out = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return out.reshape(*lead, wq.shape[-1])


class QuantDense(nn.Module):
    """``layers.Dense`` with its matmul in int8: the same parameters
    (``weight`` [out, in], ``bias`` [out]), so a state_dict loads into
    either, drawn fresh as ``Dense`` draws them (``models/init.py``:
    ``kernel_init``, flax's default ``lecun_normal`` on [in, out], as JAX
    ``QuantDense`` draws its kernel; biases zeros). Inference only."""

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
        wq, s_w = quantize_per_channel(self.weight, axis=1)  # [out, in], s_w [out, 1]
        xq, s_x = quantize_per_token(x)
        y = int8_matmul(xq, wq.t()).float() * s_x * s_w.reshape(-1)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)
