"""Multi-head attention with a float32 softmax, sinusoidal positions and the
causal future mask (counterpart of multimodalrouting_tpu/models/attention.py).

``attention`` is the one dispatch point, the JAX package's case for case
(attention.py:163-206). On projected q/k/v [N, T, H*dh] with no additive
bias, no attention-weight dropout drawn and q and k of one shape, the
selector ``ops/flash.attention_impl`` (MMR_ATTN, MMR_FLASH) picks:

- ``flash`` (default): the packed kernels (``ops/flash_packed.py``: K1
  forward, K2 backward) where ``supports_packed`` holds and either no
  gradient flows through the caller (``frozen_fast_path``) or the packed
  backward covers the shape; else K4a (``ops/flash.py``) where
  ``flash.supports`` holds;
- ``packed``: K1 wherever ``supports_packed`` holds;
- ``splash``: K4b wherever ``flash.supports`` holds;
- ``xla``: neither.

Under a gradient beyond the packed backward's ``MAX_T_BWD`` the JAX package
back-propagates through its XLA attention (flash_packed.py:251-261); the
port takes autograd of the eager attention there. Everything else runs the
eager path: fp32 logits, the key mask applied with where(..., -1e9), fp32
softmax, weights cast to the compute dtype, then dropout on the weights in
training.

Under ``MMR_FUSED_QKV=1`` (read at each call; default off) self-attention
(q, k and v one tensor object) that is not int8 projects k and v as one
product over the concatenated weights and q as its own (``fused_qkv``):
two products where the JAX package makes one (attention.py:140-153), so
that the k and v the attention keeps hold no q beside them. The parameters
keep their names and shapes.

Dropout runs where a ``generator`` is passed (training) and its rate is
above 0, as flax's runs with a dropout key and ``deterministic=False``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.ops import flash, flash_packed
from multimodalrouting_tpu_torch.ops.masked import NEG_INF
from multimodalrouting_tpu_torch.ops.quant import QuantDense


def sinusoidal_positions(
    seq_len: int, dim: int, padding_idx: int = 0, dtype=torch.float32, quantized: bool = False
) -> torch.Tensor:
    """[T, dim] fairseq-style table for positions padding_idx+1 .. +T.
    quantized=True truncates every value toward zero (the reference's
    integer-cast defect, kept for bit-parity runs)."""
    half = dim // 2
    if half <= 0:
        raise ValueError(f"dim must be >= 2, got {dim}")
    positions = np.arange(padding_idx + 1, padding_idx + 1 + seq_len, dtype=np.float32)
    if half == 1:
        freqs = np.ones((1,), dtype=np.float32)
    else:
        freqs = np.exp(np.arange(half, dtype=np.float32) * -(np.log(10000.0) / (half - 1)))
    args = positions[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((seq_len, 1), dtype=np.float32)], axis=1)
    if quantized:
        table = np.trunc(table.astype(np.float32))
    return torch.from_numpy(np.ascontiguousarray(table, dtype=np.float32)).to(dtype)


def future_mask(tq: int, tk: int) -> torch.Tensor:
    """Additive causal mask [Tq, Tk]: -1e9 strictly above the shifted diagonal."""
    offset = 1 + abs(tk - tq)
    i = np.arange(tq)[:, None]
    j = np.arange(tk)[None, :]
    return torch.from_numpy(np.where(j >= i + offset, NEG_INF, 0.0).astype(np.float32))


def attention_branch(
    tq: int, tk: int, head_dim: int, d: int, num_heads: int, *, frozen_fast_path: bool, needs_grad: bool,
) -> str:
    """Which attention a self-attention call of this shape takes under the
    current selector: "packed" (K1/K2), "flash" (K4a), "splash" (K4b) or
    "eager". The caller has checked the shape-free conditions (no bias, no
    dropout drawn, q and k of one shape)."""
    impl = flash.attention_impl()
    if impl == "xla":
        return "eager"
    if impl in ("packed", "flash"):
        take_packed = impl == "packed" or frozen_fast_path or flash_packed.supports_packed_bwd(tq, head_dim)
        if take_packed and flash_packed.supports_packed(tq, tk, head_dim, d, num_heads):
            if needs_grad and not flash_packed.supports_packed_bwd(tq, head_dim):
                return "eager"  # K1 forced beyond its backward: the JAX package differentiates XLA's
            return "packed"
    if impl != "packed" and flash.supports(tq, tk, head_dim):
        return "splash" if impl == "splash" else "flash"
    return "eager"


def attention(
    qh: torch.Tensor,  # [N, Tq, D] projected and scaled
    kh: torch.Tensor,  # [N, Tk, D]
    vh: torch.Tensor,
    kv_mask: Optional[torch.Tensor],  # [N, Tk], 1 = keep
    attn_bias: Optional[torch.Tensor],  # [Tq, Tk] or [N, Tq, Tk] additive
    num_heads: int,
    *,
    frozen_fast_path: bool,
    dtype: torch.dtype,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Attention core -> [N, Tq, D] in `dtype`, before the out-projection."""
    n, tq, d = qh.shape
    tk = kh.shape[1]
    head_dim = d // num_heads
    branch = "eager"
    if attn_bias is None and (generator is None or dropout_rate == 0.0) and qh.shape == kh.shape:
        needs_grad = torch.is_grad_enabled() and (qh.requires_grad or kh.requires_grad or vh.requires_grad)
        branch = attention_branch(
            tq, tk, head_dim, d, num_heads, frozen_fast_path=frozen_fast_path, needs_grad=needs_grad,
        )
    if branch == "packed":
        return flash_packed.packed_attention(qh, kh, vh, kv_mask, num_heads).to(dtype)

    q4 = qh.reshape(n, tq, num_heads, head_dim)
    k4 = kh.reshape(n, tk, num_heads, head_dim)
    v4 = vh.reshape(n, tk, num_heads, head_dim)
    if branch != "eager":
        kernel = flash.splash_self_attention if branch == "splash" else flash.flash_self_attention
        return kernel(q4, k4, v4, kv_mask).to(dtype).reshape(n, tq, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4).float()
    if attn_bias is not None:
        bias = attn_bias.to(device=logits.device, dtype=torch.float32)
        logits = logits + (bias[:, None] if bias.dim() == 3 else bias)
    if kv_mask is not None:
        keep = kv_mask.bool()[:, None, None, :]
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    weights = dropout(torch.softmax(logits, dim=-1).to(dtype), dropout_rate, generator)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v4).reshape(n, tq, d)


def use_fused_qkv() -> bool:
    """``MMR_FUSED_QKV=1``: fuse self-attention's q/k/v projections."""
    return os.environ.get("MMR_FUSED_QKV", "0") == "1"


def fused_qkv(q_proj, k_proj, v_proj, x: torch.Tensor, scaling: float) -> Tuple[torch.Tensor, ...]:
    """(q * scaling, k, v) of `x`: k and v from one product over the two
    Dense layers' weights and biases concatenated along the output features
    and cast to the compute dtype (views of one [..., 2 * d_out] result), q
    from its own. Each output column is its own dot product, as in the
    separate products. The attention keeps k and v for its backward, and
    with them their whole product: q is scaled into a new tensor, so a q
    third in that product would only hold memory."""
    dt = k_proj.dtype
    w = torch.cat([k_proj.weight, v_proj.weight]).to(dt)
    b = torch.cat([k_proj.bias, v_proj.bias]).to(dt)
    kh, vh = F.linear(x.to(dt), w, b).chunk(2, dim=-1)
    return q_proj(x) * scaling, kh, vh


class MultiheadAttention(nn.Module):
    """Batch-first MHA: q [B,Tq,D], k/v [B,Tk,D], kv_mask [B,Tk] (1 = keep),
    optional additive attn_bias [Tq,Tk]. q is scaled by head_dim**-0.5.
    `int8` runs the four projections as int8 products (``ops/quant.py``;
    frozen, inference-only paths), each its own product as in the JAX
    package, which fuses no QKV under int8. Self-attention fuses its k and v
    projections under ``MMR_FUSED_QKV=1`` (``fused_qkv``)."""

    def __init__(self, d: int, num_heads: int, frozen_fast_path: bool = False, dropout: float = 0.0,
                 dtype=torch.float32, int8: bool = False):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d={d} not divisible by heads={num_heads}")
        self.d, self.num_heads, self.dtype = d, num_heads, dtype
        self.frozen_fast_path, self.dropout = frozen_fast_path, dropout
        dense = QuantDense if int8 else Dense
        self.int8 = int8
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, dense(d, d, dtype=dtype, kernel_init=init.xavier_uniform))

    def forward(self, q, k, v, kv_mask=None, attn_bias=None, generator=None) -> torch.Tensor:
        scaling = (self.d // self.num_heads) ** -0.5
        if q is k and k is v and not self.int8 and use_fused_qkv():
            qh, kh, vh = fused_qkv(self.q_proj, self.k_proj, self.v_proj, q, scaling)
        else:
            qh, kh, vh = self.q_proj(q) * scaling, self.k_proj(k), self.v_proj(v)
        out = attention(
            qh, kh, vh, kv_mask, attn_bias, self.num_heads, frozen_fast_path=self.frozen_fast_path,
            dtype=self.dtype, dropout_rate=self.dropout, generator=generator,
        )
        return self.out_proj(out)
