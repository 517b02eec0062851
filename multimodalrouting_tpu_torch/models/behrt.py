"""BEHRT-style structured EHR time-series encoder (counterpart of
multimodalrouting_tpu/models/behrt.py): linear input projection, learned
positions over a static max length, optional CLS token, post-LN transformer
layers (ReLU, 4d FFN) and an output head LayerNorm -> Linear -> ReLU. In
training (a ``generator`` passed) ``encoder.dropout`` runs on the attention
weights and after the attention, the ReLU and the FFN, as in the JAX
package."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.attention import MultiheadAttention
from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm
from multimodalrouting_tpu_torch.ops.masked import masked_last, masked_mean


class PostLNEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer defaults: post-LN, ReLU, 4d FFN."""

    def __init__(self, d: int, num_heads: int, dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiheadAttention(d, num_heads, dropout=dropout, dtype=dtype)
        self.ln1 = LayerNorm(d, 1e-5, dtype)
        self.fc1 = Dense(d, 4 * d, dtype=dtype)
        self.fc2 = Dense(4 * d, d, dtype=dtype)
        self.ln2 = LayerNorm(d, 1e-5, dtype)

    def forward(self, x, key_mask=None, generator=None):
        drop = lambda h: dropout(h, self.dropout, generator)  # noqa: E731
        x = self.ln1(x + drop(self.attn(x, x, x, kv_mask=key_mask, generator=generator)))
        return self.ln2(x + drop(self.fc2(drop(F.relu(self.fc1(x))))))


class BEHRTLabEncoder(nn.Module):
    def __init__(
        self,
        n_feats: int,
        d: int,
        seq_len: int = 48,
        n_layers: int = 2,
        n_heads: int = 8,
        pool: str = "cls",  # last | mean | cls
        dtype=torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.d, self.seq_len, self.pool, self.dtype = d, seq_len, pool, dtype
        init.param(self, "pos", init.normal(0.02), (1, seq_len, d))
        self.input_proj = Dense(n_feats, d, dtype=dtype)
        if pool == "cls":
            init.param(self, "cls_token", init.normal(0.02), (1, 1, d))
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(d, n_heads, dtype, dropout))
        self.out_ln = LayerNorm(d, 1e-5, dtype)
        self.out_proj = Dense(d, d, dtype=dtype)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B,T,F] (or [B,T]); mask [B,T] -> (seq [B,T,D], mask [B,T], pooled [B,D])."""
        if x.dim() == 2:
            x = x[..., None]
        b, t, _ = x.shape
        if t > self.seq_len:
            raise ValueError(f"T={t} exceeds static seq_len={self.seq_len}")
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.float32, device=x.device)
        dt = self.dtype
        h = self.input_proj(x) + self.pos[:, :t].to(dt)
        use_cls = self.pool == "cls"
        if use_cls:
            h = torch.cat([self.cls_token.to(dt).expand(b, 1, self.d), h], dim=1)
            key_mask = torch.cat([torch.ones((b, 1), dtype=mask.dtype, device=mask.device), mask], dim=1)
        else:
            key_mask = mask
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, key_mask=key_mask, generator=generator)
        h = F.relu(self.out_proj(self.out_ln(h)))
        if use_cls:
            seq, pooled = h[:, 1:], h[:, 0]
        else:
            seq = h
            pooled = masked_last(seq, mask) if self.pool == "last" else masked_mean(seq, mask)
        return seq, mask.float(), pooled
