"""sMRO block-staged routing (counterpart of
multimodalrouting_tpu/routing/smro.py).

``MMRouting``: learned per-instance route and block gates over the shared
context [zL|zN|zI], stage masks for the uni -> bi -> tri curriculum, and
stop-gradients (``.detach()``) on the lower blocks in staged training: at
``bi`` the fused logits are w_uni * sg(uni) + w_bi * bi, the gate weight
itself stopped only under ``strict_freeze_gate``; at ``tri`` likewise for
uni and bi. ``loss_based_fuse`` is the deterministic variant: route
weights softmax(-alpha * EMA route losses), block weights softmax(-alpha *
block-mean losses), no masks or stop-gradients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models.fusions import EPS
from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm
from multimodalrouting_tpu_torch.ops.masked import masked_softmax
from multimodalrouting_tpu_torch.routes import block_mask_for_stage, get_blocks

FULL_STAGES = (None, "eval", "")


class MMRoutingOut(NamedTuple):
    fused: torch.Tensor  # [B, C] fused logits
    route_w: torch.Tensor  # [B, R]
    block_w: torch.Tensor  # [B, 3]
    block_logits: torch.Tensor  # [B, 3, C] per-block contributions (uni / bi / tri)


def _block_sums(weighted: torch.Tensor, routes: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    blocks = get_blocks(routes)
    return tuple(weighted[:, list(blocks[k])].sum(dim=1) for k in ("uni", "bi", "tri"))


class MMRouting(nn.Module):
    """Learned per-instance gating with sMRO block-staged fusion."""

    def __init__(self, routes: Tuple[str, ...], d_in: int, gate_hidden: int = 256, p_drop: float = 0.10,
                 strict_freeze_gate: bool = False, dtype=torch.float32):
        super().__init__()
        self.routes, self.p_drop, self.strict_freeze_gate = tuple(routes), p_drop, strict_freeze_gate
        for name, out_dim in (("route_gate", len(routes)), ("block_gate", 3)):
            setattr(self, f"{name}_ln", LayerNorm(d_in, EPS, dtype))
            setattr(self, f"{name}_fc1", Dense(d_in, gate_hidden, dtype=dtype))
            setattr(self, f"{name}_fc2", Dense(gate_hidden, out_dim, dtype=dtype))

    def _gate(self, name: str, x: torch.Tensor, generator) -> torch.Tensor:
        h = F.gelu(getattr(self, f"{name}_fc1")(getattr(self, f"{name}_ln")(x)))
        return getattr(self, f"{name}_fc2")(dropout(h, self.p_drop, generator))

    def forward(self, route_logits: torch.Tensor, zl, zn, zi, stage: Optional[str] = None,
                generator=None) -> MMRoutingOut:
        b, r, _ = route_logits.shape
        if r != len(self.routes):
            raise ValueError(f"route_logits has {r} routes, expected {len(self.routes)}")
        x = torch.cat([zl, zn, zi], dim=-1)
        rmask = bmask = None
        if stage not in FULL_STAGES:
            rmask, bmask = (m.to(x.device)[None].expand(b, -1) for m in block_mask_for_stage(stage, self.routes))
        route_w = masked_softmax(self._gate("route_gate", x, generator), rmask, axis=-1)
        block_w = masked_softmax(self._gate("block_gate", x, generator), bmask, axis=-1)

        uni, bi, tri = _block_sums(route_logits * route_w[..., None].to(route_logits.dtype), self.routes)
        block_logits = torch.stack([uni, bi, tri], dim=1)
        w_uni, w_bi, w_tri = (block_w[:, i : i + 1] for i in range(3))
        strict = self.strict_freeze_gate
        if stage in FULL_STAGES:
            fused = w_uni * uni + w_bi * bi + w_tri * tri
        elif stage == "uni":
            fused = w_uni * uni
        elif stage == "bi":
            fused = (w_uni.detach() if strict else w_uni) * uni.detach() + w_bi * bi
        elif stage == "tri":
            fused = (w_uni.detach() if strict else w_uni) * uni.detach() + (
                w_bi.detach() if strict else w_bi) * bi.detach() + w_tri * tri
        else:
            raise ValueError(f"Invalid stage {stage!r}")
        return MMRoutingOut(fused=fused, route_w=route_w, block_w=block_w, block_logits=block_logits)


def loss_based_route_weights(route_losses_ema: torch.Tensor, alpha: float,
                             routes: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R] EMA route losses -> (route_w [R] = softmax(-alpha * losses),
    block_w [3] = softmax(-alpha * each block's mean loss))."""
    losses = route_losses_ema.float()
    blocks = get_blocks(routes)
    block_losses = torch.stack([losses[list(blocks[k])].mean() for k in ("uni", "bi", "tri")])
    return torch.softmax(-alpha * losses, dim=0), torch.softmax(-alpha * block_losses, dim=0)


def loss_based_fuse(route_logits: torch.Tensor, route_losses_ema: torch.Tensor, alpha: float,
                    routes: Sequence[str]) -> MMRoutingOut:
    """Deterministic loss-based fusion: logits weighted by route, summed by
    block, blocks weighted and summed."""
    b = route_logits.shape[0]
    rw, bw = loss_based_route_weights(route_losses_ema, alpha, routes)
    uni, bi, tri = _block_sums(route_logits * rw[None, :, None].to(route_logits.dtype), routes)
    block_logits = torch.stack([uni, bi, tri], dim=1)
    fused = (block_logits * bw[None, :, None].to(block_logits.dtype)).sum(dim=1)
    return MMRoutingOut(fused=fused, route_w=rw[None].expand(b, -1), block_w=bw[None].expand(b, 3),
                        block_logits=block_logits)
