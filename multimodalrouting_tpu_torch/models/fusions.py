"""Route fusion families for the 7-route taxonomy (counterpart of
multimodalrouting_tpu/models/fusions.py).

- ``PairwiseFusion`` / ``TrimodalFusion``: an MLP over the concatenated or
  rich features ([za, zb, za*zb, |za-zb|]; the trimodal products) with a
  learnable residual scale;
- ``LinearPairFusion`` / ``LinearTriFusion``: one bias-free Dense;
- ``CrossModalEncoder`` / ``TrimodalCrossEncoder``: bidirectional
  cross-attention over single-token sequences (the trimodal one reuses each
  layer's block for L<->N, L<->I, N<->I);
- ``DirectionalCrossAttnFusion`` and ``TriTokenAttentionFusion``: the
  missing-modality-safe sequence fusions; a sample whose key side is empty
  maps to the out projection of zeros;
- ``SevenRouteFusion``: the seven route embeddings from the pooled
  unimodal ones, by ``bi_fusion_mode`` / ``tri_fusion_mode`` (mlp | attn |
  linear).

Module and parameter names are flax's (``ln_0``, ``fc_0``, ``Dense_0``,
``res_scale``, ...), so ``bridge.py`` maps them mechanically. Every GELU is
the exact erf GELU, and every LayerNorm flax's with eps 1e-5. ``d_in`` is
the width of the inputs where flax infers it (the encoders' ``d``).
Dropout draws from the ``generator`` passed in training.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.attention import MultiheadAttention
from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm
from multimodalrouting_tpu_torch.ops.masked import masked_mean

EPS = 1e-5


class MLPBlock(nn.Module):
    """(LN -> Dense -> GELU -> Dropout) per hidden width, then LN -> Dense;
    hidden widths [4 * out, 2 * out] by default."""

    def __init__(self, d_in: int, out_dim: int, hidden: Optional[Sequence[int]] = None, p_drop: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        dims = (list(hidden) if hidden is not None else [4 * out_dim, 2 * out_dim]) + [out_dim]
        self.n_hidden, self.p_drop = len(dims) - 1, p_drop
        prev = d_in
        for i, h in enumerate(dims[:-1]):
            setattr(self, f"ln_{i}", LayerNorm(prev, EPS, dtype))
            setattr(self, f"fc_{i}", Dense(prev, h, dtype=dtype))
            prev = h
        self.ln_out = LayerNorm(prev, EPS, dtype)
        self.fc_out = Dense(prev, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = F.gelu(getattr(self, f"fc_{i}")(getattr(self, f"ln_{i}")(x)))
            x = dropout(x, self.p_drop, generator)
        return self.fc_out(self.ln_out(x))


class PairwiseFusion(nn.Module):
    def __init__(self, d: int, feature_mode: str = "rich", p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.feature_mode = feature_mode
        self.mlp = MLPBlock((2 if feature_mode == "concat" else 4) * d, d, p_drop=p_drop, dtype=dtype)
        init.param(self, "res_scale", init.constant(0.5), ())

    def forward(self, za, zb, generator=None):
        if self.feature_mode == "concat":
            x = torch.cat([za, zb], dim=-1)
        else:
            x = torch.cat([za, zb, za * zb, (za - zb).abs()], dim=-1)
        h = self.mlp(x, generator)
        return h + self.res_scale.to(h.dtype) * 0.5 * (za + zb)


class TrimodalFusion(nn.Module):
    def __init__(self, d: int, feature_mode: str = "rich", p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.feature_mode = feature_mode
        self.mlp = MLPBlock((3 if feature_mode == "concat" else 7) * d, d, p_drop=p_drop, dtype=dtype)
        init.param(self, "res_scale", init.constant(0.5), ())

    def forward(self, zl, zn, zi, generator=None):
        if self.feature_mode == "concat":
            x = torch.cat([zl, zn, zi], dim=-1)
        else:
            x = torch.cat([zl, zn, zi, zl * zn, zl * zi, zn * zi, zl * zn * zi], dim=-1)
        h = self.mlp(x, generator)
        return h + self.res_scale.to(h.dtype) * (zl + zn + zi) / 3.0


class LinearPairFusion(nn.Module):
    """Bias-free Dense(2 d_in -> d), the capsule variant's fusion."""

    def __init__(self, d: int, d_in: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(2 * (d_in or d), d, bias=False, dtype=dtype)

    def forward(self, za, zb, generator=None):
        return self.Dense_0(torch.cat([za, zb], dim=-1))


class LinearTriFusion(nn.Module):
    def __init__(self, d: int, d_in: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(3 * (d_in or d), d, bias=False, dtype=dtype)

    def forward(self, zl, zn, zi, generator=None):
        return self.Dense_0(torch.cat([zl, zn, zi], dim=-1))


class CrossAttnPairBlock(nn.Module):
    """One bidirectional cross-attention layer over [B, T, d] tokens."""

    def __init__(self, d: int, n_heads: int = 4, p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.p_drop = p_drop
        self.norm_a = LayerNorm(d, EPS, dtype)
        self.norm_b = LayerNorm(d, EPS, dtype)
        self.a2b = MultiheadAttention(d, n_heads, dropout=p_drop, dtype=dtype)
        self.b2a = MultiheadAttention(d, n_heads, dropout=p_drop, dtype=dtype)
        self.ff_a = MLPBlock(d, d, hidden=[4 * d], p_drop=p_drop, dtype=dtype)
        self.ff_b = MLPBlock(d, d, hidden=[4 * d], p_drop=p_drop, dtype=dtype)

    def forward(self, xa, xb, generator=None):
        drop = lambda x: dropout(x, self.p_drop, generator)  # noqa: E731
        q, k = self.norm_a(xa), self.norm_b(xb)
        xa = xa + drop(self.a2b(q, k, k, generator=generator))
        xa = xa + drop(self.ff_a(xa, generator))
        q, k = self.norm_b(xb), self.norm_a(xa)
        xb = xb + drop(self.b2a(q, k, k, generator=generator))
        xb = xb + drop(self.ff_b(xb, generator))
        return xa, xb


class CrossModalEncoder(nn.Module):
    """Pair fusion by bidirectional cross-attention on [B, 1, d] tokens."""

    def __init__(self, d: int, n_layers: int = 2, n_heads: int = 4, p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"block_{i}", CrossAttnPairBlock(d, n_heads, p_drop, dtype))
        self.pool_ln = LayerNorm(2 * d, EPS, dtype)
        self.pool_fc = Dense(2 * d, d, dtype=dtype)

    def forward(self, za, zb, generator=None):
        xa, xb = za[:, None, :], zb[:, None, :]
        for i in range(self.n_layers):
            xa, xb = getattr(self, f"block_{i}")(xa, xb, generator)
        return self.pool_fc(self.pool_ln(torch.cat([xa, xb], dim=-1)[:, 0]))


class TrimodalCrossEncoder(nn.Module):
    """Round-robin trimodal cross-attention: each layer's one block runs
    L<->N, L<->I, then N<->I."""

    def __init__(self, d: int, n_layers: int = 2, n_heads: int = 4, p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.n_layers, self.p_drop = n_layers, p_drop
        for i in range(n_layers):
            setattr(self, f"block_{i}", CrossAttnPairBlock(d, n_heads, p_drop, dtype))
        self.pool_ln0 = LayerNorm(3 * d, EPS, dtype)
        self.pool_fc0 = Dense(3 * d, 4 * d, dtype=dtype)
        self.pool_fc1 = Dense(4 * d, d, dtype=dtype)
        init.param(self, "res_scale", init.constant(0.5), ())

    def forward(self, zl, zn, zi, generator=None):
        xl, xn, xi = zl[:, None, :], zn[:, None, :], zi[:, None, :]
        for i in range(self.n_layers):
            blk = getattr(self, f"block_{i}")
            xl, xn = blk(xl, xn, generator)
            xl, xi = blk(xl, xi, generator)
            xn, xi = blk(xn, xi, generator)
        h = F.gelu(self.pool_fc0(self.pool_ln0(torch.cat([xl, xn, xi], dim=-1)[:, 0])))
        h = self.pool_fc1(dropout(h, self.p_drop, generator))
        return h + self.res_scale.to(h.dtype) * (zl + zn + zi) / 3.0


class DirectionalCrossAttnFusion(nn.Module):
    """A <- B cross-attention over sequences; a sample whose B is empty maps
    to out(0), a learned constant (the pooled state is zeroed before the out
    projection)."""

    def __init__(self, d: int, n_heads: int = 4, p_drop: float = 0.1, pool: str = "mean", dtype=torch.float32):
        super().__init__()
        self.pool = pool
        self.attn = MultiheadAttention(d, n_heads, dropout=p_drop, dtype=dtype)
        self.post_ln = LayerNorm(d, EPS, dtype)
        self.ff1 = Dense(d, 4 * d, dtype=dtype)
        self.ff2 = Dense(4 * d, d, dtype=dtype)
        self.out_ln = LayerNorm(d, EPS, dtype)
        self.out_proj_ln = LayerNorm(d, EPS, dtype)
        self.out_proj_fc = Dense(d, d, dtype=dtype)

    def forward(self, a_seq, a_mask, b_seq, b_mask, generator=None):
        h = self.attn(a_seq, b_seq, b_seq, kv_mask=b_mask, generator=generator)
        h = self.post_ln(a_seq + h)
        h = self.out_ln(h + self.ff2(F.relu(self.ff1(h))))  # ReLU in this fusion's FF, as the reference
        if self.pool == "first":  # the first valid query token, else token 0
            has_any = a_mask.sum(dim=1) > 0
            idx = torch.where(has_any, (a_mask > 0.5).int().argmax(dim=1), torch.zeros_like(has_any, dtype=torch.long))
            z = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[2]))[:, 0]
        else:
            z = masked_mean(h, a_mask)
        z = z * (b_mask.sum(dim=1) > 0).to(z.dtype)[:, None]
        return self.out_proj_fc(self.out_proj_ln(z))


class TriTokenAttentionFusion(nn.Module):
    """A learned query token attending over concat([L_seq, N_seq, I_seq])."""

    def __init__(self, d: int, n_heads: int = 4, p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.d = d
        init.param(self, "query", init.normal(0.02), (1, 1, d))
        self.ln_kv = LayerNorm(d, EPS, dtype)
        self.attn = MultiheadAttention(d, n_heads, dropout=p_drop, dtype=dtype)
        self.out_proj_ln = LayerNorm(d, EPS, dtype)
        self.out_proj_fc = Dense(d, d, dtype=dtype)

    def forward(self, l_seq, l_mask, n_seq, n_mask, i_seq, i_mask, generator=None):
        kv_mask = torch.cat([l_mask, n_mask, i_mask], dim=1)
        kv = self.ln_kv(torch.cat([l_seq, n_seq, i_seq], dim=1))
        q = self.query.to(kv.dtype).expand(l_seq.shape[0], 1, self.d)
        h = self.attn(q, kv, kv, kv_mask=kv_mask, generator=generator)[:, 0]
        h = h * (kv_mask.sum(dim=1) > 0).to(h.dtype)[:, None]  # no valid token: out(0)
        return self.out_proj_fc(self.out_proj_ln(h))


class SevenRouteFusion(nn.Module):
    """The 7-route embedding dict from the pooled unimodal embeddings."""

    def __init__(self, d: int, d_in: Optional[int] = None, feature_mode: str = "rich", bi_fusion_mode: str = "mlp",
                 tri_fusion_mode: str = "mlp", p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()

        def pair():
            if bi_fusion_mode == "attn":
                return CrossModalEncoder(d, p_drop=p_drop, dtype=dtype)
            if bi_fusion_mode == "linear":
                return LinearPairFusion(d, d_in, dtype=dtype)
            return PairwiseFusion(d, feature_mode, p_drop, dtype)

        self.LN, self.LI, self.NI = pair(), pair(), pair()
        if tri_fusion_mode == "attn":
            self.LNI = TrimodalCrossEncoder(d, p_drop=p_drop, dtype=dtype)
        elif tri_fusion_mode == "linear":
            self.LNI = LinearTriFusion(d, d_in, dtype=dtype)
        else:
            self.LNI = TrimodalFusion(d, feature_mode, p_drop, dtype)

    def forward(self, zl, zn, zi, generator=None) -> Dict[str, torch.Tensor]:
        return {
            "L": zl, "N": zn, "I": zi,
            "LN": self.LN(zl, zn, generator),
            "LI": self.LI(zl, zi, generator),
            "NI": self.NI(zn, zi, generator),
            "LNI": self.LNI(zl, zn, zi, generator),
        }
