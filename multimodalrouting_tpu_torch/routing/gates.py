"""The gated-concat routing path (counterpart of
multimodalrouting_tpu/routing/gates.py): the learned gate net, the uniform
and loss-based gates, the gate-weighted route concatenation, the final
concat head and the per-route heads.

``RouteGateNet`` and ``RouteHead`` normalise with flax's LayerNorm (eps
1e-5); ``StackedRouteHeads`` normalises by hand with eps 1e-6 and the
population variance, and keeps its R heads' parameters stacked along the
route axis (``ln_scale``, ``ln_bias``, ``w1``, ``b1``, ``w2``, ``b2``), as
the JAX module holds them. Every GELU is the exact erf GELU.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.fusions import EPS, MLPBlock
from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm
from multimodalrouting_tpu_torch.ops.masked import masked_softmax


class RouteGateNet(nn.Module):
    """MLP([zL|zN|zI]) -> softmax over routes, renormalised over the
    available ones."""

    def __init__(self, d_in: int, num_routes: int, hidden: int = 1024, p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.p_drop, self.dtype = p_drop, dtype
        self.ln = LayerNorm(d_in, EPS, dtype)
        self.fc1 = Dense(d_in, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, num_routes, dtype=dtype)

    def forward(self, zl, zn, zi, avail: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        x = F.gelu(self.fc1(self.ln(torch.cat([zl, zn, zi], dim=-1))))
        w = torch.softmax(self.fc2(dropout(x, self.p_drop, generator)).float(), dim=1)
        if avail is not None:
            w = w * avail.float()
            w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)
        return w.to(self.dtype)


def uniform_gates(avail: torch.Tensor) -> torch.Tensor:
    """Uniform over the available routes."""
    w = avail.float()
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)


def loss_based_gates(route_losses: torch.Tensor, avail: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """softmax(-alpha * per-route loss + log availability)."""
    logits = -alpha * route_losses.float() + torch.log(torch.clamp(avail.float(), min=1e-9))
    return masked_softmax(logits, None, axis=1)


def concat_routes(
    route_embs: Dict[str, torch.Tensor], gates: torch.Tensor, routes: Sequence[str], l2norm: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate-weighted route embeddings -> ([B, R*d], [B, R, d])."""
    z = torch.stack([route_embs[r] for r in routes], dim=1)
    if l2norm:
        z = z / torch.clamp(torch.linalg.vector_norm(z, dim=2, keepdim=True), min=1e-12)
    zw = gates.to(z.dtype)[..., None] * z
    b, r, d = zw.shape
    return zw.reshape(b, r * d), zw


class FinalConcatHead(nn.Module):
    """Deep MLP over the R*d concatenated route features."""

    def __init__(self, num_routes: int, d: int, n_tasks: int = 1, hidden: Optional[Sequence[int]] = None,
                 p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        in_dim = num_routes * d
        hidden = list(hidden) if hidden is not None else [4 * in_dim, 2 * in_dim]
        self.mlp = MLPBlock(in_dim, n_tasks, hidden=hidden, p_drop=p_drop, dtype=dtype)

    def forward(self, x_cat: torch.Tensor, generator=None) -> torch.Tensor:
        return self.mlp(x_cat, generator)


class RouteHead(nn.Module):
    """One route's head: LN -> Dense(width_mult * d) -> GELU -> Dropout -> Dense."""

    def __init__(self, d: int, n_tasks: int = 1, p_drop: float = 0.1, width_mult: int = 2, dtype=torch.float32):
        super().__init__()
        self.p_drop = p_drop
        self.ln = LayerNorm(d, EPS, dtype)
        self.fc1 = Dense(d, width_mult * d, dtype=dtype)
        self.fc2 = Dense(width_mult * d, n_tasks, dtype=dtype)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.fc2(dropout(F.gelu(self.fc1(self.ln(x))), self.p_drop, generator))


class StackedRouteHeads(nn.Module):
    """R independent RouteHeads as one batched program: z [B, R, d] ->
    logits [B, R, n_tasks]."""

    def __init__(self, num_routes: int, d: int, n_tasks: int = 1, p_drop: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.num_routes, self.p_drop, self.dtype = num_routes, p_drop, dtype
        r = num_routes
        init.param(self, "ln_scale", init.ones, (r, d))
        init.param(self, "ln_bias", init.zeros, (r, d))
        # lecun_normal on the whole [R, in, out]: the route axis counts into the fan
        init.param(self, "w1", init.lecun_normal, (r, d, 2 * d))
        init.param(self, "b1", init.zeros, (r, 2 * d))
        init.param(self, "w2", init.lecun_normal, (r, 2 * d, n_tasks))
        init.param(self, "b2", init.zeros, (r, n_tasks))

    def forward(self, z: torch.Tensor, generator=None) -> torch.Tensor:
        if z.shape[1] != self.num_routes:
            raise ValueError(f"expected {self.num_routes} routes, got {z.shape[1]}")
        dt = z.dtype
        zf = z.float()
        mean = zf.mean(dim=-1, keepdim=True).to(dt)
        var = zf.var(dim=-1, unbiased=False, keepdim=True).to(dt)
        h = (z - mean) * torch.rsqrt(var + 1e-6)
        h = h * self.ln_scale.to(dt)[None] + self.ln_bias.to(dt)[None]
        h = torch.einsum("brd,rdh->brh", h, self.w1.to(dt)) + self.b1.to(dt)[None]
        h = dropout(F.gelu(h), self.p_drop, generator)
        return torch.einsum("brh,rht->brt", h, self.w2.to(dt)) + self.b2.to(dt)[None]
