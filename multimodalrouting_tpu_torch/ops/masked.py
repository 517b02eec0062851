"""Masked pooling / softmax primitives (counterpart of
multimodalrouting_tpu/ops/masked.py). They run in the caller's dtype; the
softmax is computed in float32 and cast back."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], axis: int = 1) -> torch.Tensor:
    """Mean over `axis` counting only mask==1 positions; 0 for an empty mask."""
    if mask is None:
        return x.mean(dim=axis)
    m = mask.to(x.dtype).unsqueeze(-1)
    denom = torch.clamp((m).sum(dim=axis), min=1.0)
    return (x * m).sum(dim=axis) / denom


def masked_last(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Last valid step of x [B,T,D] by mask [B,T]; zeros if none is valid."""
    if mask is None:
        return x[:, -1]
    lengths = (mask > 0.5).long().sum(dim=1)
    idx = torch.clamp(lengths - 1, 0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]
    return torch.where((lengths > 0)[:, None], out, torch.zeros_like(out))


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], axis: int = 1) -> torch.Tensor:
    """Max over `axis` with masked positions filled with -1e9."""
    if mask is None:
        return x.amax(dim=axis)
    keep = mask.bool().unsqueeze(-1)
    return torch.where(keep, x, torch.full_like(x, NEG_INF)).amax(dim=axis)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor], axis: int = -1) -> torch.Tensor:
    """Softmax with masked entries forced to ~0, computed in float32."""
    x = logits.float()
    if mask is not None:
        x = torch.where(mask.bool(), x, torch.full_like(x, NEG_INF))
    x = x - x.amax(dim=axis, keepdim=True)
    e = torch.exp(x)
    out = e / torch.clamp(e.sum(dim=axis, keepdim=True), min=1e-30)
    return out.to(logits.dtype)
