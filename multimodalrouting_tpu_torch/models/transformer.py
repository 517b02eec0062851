"""Pre-LN (MulT-style) transformer streams, G at a time (counterpart of
multimodalrouting_tpu/models/transformer.py).

The JAX package vmaps G parameter-independent MulT stacks into one program.
Here the G streams are one module whose parameters carry the same leading
[G] axis: projections are batched matmuls over the stream axis, and the
attention core runs on the flattened [G*B] batch through the shared dispatch
point. Per stream: inputs scaled by sqrt(d) plus sinusoidal positions
(unless ``use_positional`` is off), an additive attention bias given by the
caller (shared, or one per stream: JAX ``StackedCrossMulTBias``) in place
of the causal mask,
pre-LN layers whose query LayerNorm is reused on cross keys/values, rows
under the query mask zeroed after every block, ReLU FFN of width 4d, final
LayerNorm. In training (a ``generator`` passed) the MulT dropouts run at
the JAX package's sites: embed_dropout on the embedded inputs,
attn_dropout on the attention weights, res_dropout on each block's output
before the residual add, relu_dropout after the FFN's ReLU. Under
``MMR_FUSED_QKV=1`` the self-attention streams project k and v as one
batched product and q as its own (``fused_stacked_qkv``), where the JAX
package's MultiheadAttention fuses all three (q, k and v one array).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models.attention import attention, future_mask, sinusoidal_positions, use_fused_qkv
from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.layers import StackedDense, dropout
from multimodalrouting_tpu_torch.ops.layernorm import layer_norm


class StackedLayerNorm(nn.Module):
    """G flax LayerNorms over x [G, ..., d] (parameters [G, d], JAX names)."""

    def __init__(self, g: int, d: int, dtype, eps: float = 1e-5):
        super().__init__()
        init.param(self, "scale", init.ones, (g, d))
        init.param(self, "bias", init.zeros, (g, d))
        self.eps, self.dtype = eps, dtype

    def forward(self, x):
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return layer_norm(x, self.scale.view(shape), self.bias.view(shape), self.eps, self.dtype)


def fused_stacked_qkv(q_proj, k_proj, v_proj, x: torch.Tensor, scaling: float):
    """``attention.fused_qkv`` for G streams: (q * scaling, k, v) of x
    [G, ..., d], k and v from one batched product over the [G, d, 2 d_out]
    kernels and [G, 2 d_out] biases cast to the compute dtype, q from its
    own."""
    dt = k_proj.dtype
    w = torch.cat([k_proj.kernel, v_proj.kernel], dim=-1).to(dt)
    b = torch.cat([k_proj.bias, v_proj.bias], dim=-1).to(dt)
    flat = x.to(dt).reshape(x.shape[0], -1, x.shape[-1])
    kh, vh = torch.baddbmm(b[:, None, :], flat, w).reshape(*x.shape[:-1], -1).chunk(2, dim=-1)
    return q_proj(x) * scaling, kh, vh


class StackedMultiheadAttention(nn.Module):
    def __init__(self, g: int, d: int, num_heads: int, dtype, attn_dropout: float = 0.0):
        super().__init__()
        self.d, self.num_heads, self.dtype, self.attn_dropout = d, num_heads, dtype, attn_dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, StackedDense(g, d, d, dtype, kernel_init=init.xavier_uniform))

    def forward(self, q, k, v, kv_mask=None, attn_bias=None, generator=None):
        """q [G,B,Tq,d], k/v [G,B,Tk,d], kv_mask [G,B,Tk]; attn_bias
        additive, [Tq,Tk] for every stream or [G,Tq,Tk] per stream."""
        g, b, tq, d = q.shape
        tk = k.shape[2]
        if attn_bias is not None and attn_bias.dim() == 3:  # per stream -> per row of the [G*B] batch
            attn_bias = attn_bias[:, None].expand(g, b, tq, tk).reshape(g * b, tq, tk)
        scaling = (d // self.num_heads) ** -0.5
        if q is k and k is v and use_fused_qkv():  # self-attention streams (k = v = h)
            qh, kh, vh = fused_stacked_qkv(self.q_proj, self.k_proj, self.v_proj, q, scaling)
        else:
            qh, kh, vh = self.q_proj(q) * scaling, self.k_proj(k), self.v_proj(v)
        out = attention(
            qh.reshape(g * b, tq, d),
            kh.reshape(g * b, tk, d),
            vh.reshape(g * b, tk, d),
            None if kv_mask is None else kv_mask.reshape(g * b, tk),
            attn_bias, self.num_heads, frozen_fast_path=False, dtype=self.dtype,
            dropout_rate=self.attn_dropout, generator=generator,
        )
        return self.out_proj(out.reshape(g, b, tq, d))


class StackedMulTEncoderLayer(nn.Module):
    def __init__(self, g: int, d: int, num_heads: int, causal: bool, dtype, attn_dropout: float = 0.0,
                 relu_dropout: float = 0.0, res_dropout: float = 0.0):
        super().__init__()
        self.causal, self.relu_dropout, self.res_dropout = causal, relu_dropout, res_dropout
        self.ln0 = StackedLayerNorm(g, d, dtype)
        self.ln1 = StackedLayerNorm(g, d, dtype)
        self.attn = StackedMultiheadAttention(g, d, num_heads, dtype, attn_dropout)
        self.fc1 = StackedDense(g, d, 4 * d, dtype, kernel_init=init.xavier_uniform)
        self.fc2 = StackedDense(g, 4 * d, d, dtype, kernel_init=init.xavier_uniform)

    def forward(self, x, x_k=None, x_v=None, q_mask=None, kv_mask=None, generator=None, attn_bias=None):
        q_keep = None if q_mask is None else q_mask.to(x.dtype)[..., None]
        cross = x_k is not None
        key_mask = kv_mask if cross else q_mask

        residual = x
        h = self.ln0(x)
        if q_keep is not None:
            h = h * q_keep
        if cross:
            k, v = self.ln0(x_k), self.ln0(x_v)  # the query block's LN, reused
        else:
            k = v = h
        # an explicit bias (route_mult.py's native-length causal offsets on
        # a padded grid) overrides the shape-derived one
        if attn_bias is not None:
            bias = attn_bias
        else:
            bias = future_mask(h.shape[-2], k.shape[-2]) if self.causal else None
        h = self.attn(h, k, v, kv_mask=key_mask, attn_bias=bias, generator=generator)
        x = residual + dropout(h, self.res_dropout, generator)
        if q_keep is not None:
            x = x * q_keep

        residual = x
        h = self.ln1(x)
        if q_keep is not None:
            h = h * q_keep
        h = dropout(F.relu(self.fc1(h)), self.relu_dropout, generator)
        x = residual + dropout(self.fc2(h), self.res_dropout, generator)
        if q_keep is not None:
            x = x * q_keep
        return x


class StackedMulTEncoder(nn.Module):
    """G MulT stacks over [G, B, T, d] streams (self- or cross-attention)."""

    def __init__(self, g: int, d: int, num_heads: int, layers: int, causal: bool = False,
                 positions: str = "sinusoidal", dtype=torch.float32, attn_dropout: float = 0.0,
                 relu_dropout: float = 0.0, res_dropout: float = 0.0, embed_dropout: float = 0.0,
                 use_positional: bool = True):
        super().__init__()
        self.d, self.layers, self.dtype, self.positions = d, layers, dtype, positions
        self.embed_dropout, self.use_positional = embed_dropout, use_positional
        for i in range(layers):
            self.add_module(
                f"layer_{i}",
                StackedMulTEncoderLayer(g, d, num_heads, causal, dtype, attn_dropout, relu_dropout, res_dropout),
            )
        self.final_ln = StackedLayerNorm(g, d, dtype)

    def _embed(self, seq, generator):
        h = (math.sqrt(self.d) * seq.float()).to(self.dtype)
        if self.use_positional:
            pos = sinusoidal_positions(seq.shape[-2], self.d, dtype=self.dtype,
                                       quantized=self.positions == "ref_quantized")
            h = h + pos.to(h.device)
        return dropout(h, self.embed_dropout, generator)

    def forward(self, x_in, x_in_k=None, x_in_v=None, q_mask=None, kv_mask=None, generator=None, attn_bias=None):
        """attn_bias: an additive [Tq,Tk] or per-stream [G,Tq,Tk] bias in
        place of the causal mask (JAX StackedCrossMulTBias)."""
        x = self._embed(x_in, generator)
        if q_mask is not None:
            x = x * q_mask.to(x.dtype)[..., None]
        cross = x_in_k is not None and x_in_v is not None
        x_k = self._embed(x_in_k, generator) if cross else None
        x_v = self._embed(x_in_v, generator) if cross else None
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(
                x, x_k, x_v, q_mask=q_mask, kv_mask=kv_mask if cross else q_mask, generator=generator,
                attn_bias=attn_bias,
            )
        x = self.final_ln(x)
        if q_mask is not None:
            x = x * q_mask.to(x.dtype)[..., None]
        return x
