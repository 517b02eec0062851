"""Loss terms (counterpart of multimodalrouting_tpu/train/losses.py): BCE
over logits with pos_weight, label smoothing and sample weights, focal BCE (with alpha, and the
unimodal trainers' pos_weight-ed one without),
the death-logit contrast, the clamped pos_weight, the routing regularizers,
the differentiable fairness penalties (EDDI, soft equalized odds) and the
2-class cross-entropy. All in fp32.

On a mesh (``parallel/mesh.py``) the clamped pos_weight and the fairness
penalties, ratios of batch sums, take their sums over the data group
(``global_sum``): every rank holds the global batch's value.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multimodalrouting_tpu_torch.parallel.mesh import global_sum


def bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    pos_weight: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    sample_weight: Optional[torch.Tensor] = None,
    reduce: bool = True,
) -> torch.Tensor:
    """Binary cross-entropy over logits with an optional per-label pos_weight
    and label smoothing y' = y (1 - s) + 0.5 s."""
    logits, targets = logits.float(), targets.float()
    if label_smoothing > 0.0:
        targets = targets * (1.0 - label_smoothing) + 0.5 * label_smoothing
    pos_term = -targets * F.logsigmoid(logits)
    if pos_weight is not None:
        pos_term = pos_term * pos_weight.float()
    loss = pos_term - (1.0 - targets) * F.logsigmoid(-logits)
    if sample_weight is not None:
        sw = sample_weight.float()
        loss = loss * (sw[..., None] if loss.dim() > sw.dim() else sw)
    return loss.mean() if reduce else loss


def focal_bce_with_logits(
    logits: torch.Tensor, targets: torch.Tensor, *, gamma: float = 2.0, alpha: float = 0.25, reduce: bool = True
) -> torch.Tensor:
    logits, targets = logits.float(), targets.float()
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    return loss.mean() if reduce else loss


def focal_pos_weight_bce(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    gamma: float = 2.0,
    pos_weight: Optional[torch.Tensor] = None,
    reduce: bool = True,
) -> torch.Tensor:
    """The unimodal trainers' focal loss: pos_weight-ed BCE x (1 - p_t)^gamma,
    with no alpha term."""
    logits, targets = logits.float(), targets.float()
    bce = bce_with_logits(logits, targets, pos_weight=pos_weight, reduce=False)
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = (1 - p_t) ** gamma * bce
    return loss.mean() if reduce else loss


def death_logit(logits: torch.Tensor) -> torch.Tensor:
    """2-class capsule logits -> the single mortality logit."""
    return logits[:, 1] - logits[:, 0]


def clamped_pos_weight(y: torch.Tensor, lo: float = 0.1, hi: float = 5.0) -> torch.Tensor:
    """Per-label neg/pos ratio clamped to [lo, hi], of the global batch on a
    mesh."""
    y = y.float()
    counts = global_sum(torch.stack([y.sum(dim=0), (1.0 - y).sum(dim=0)]))
    pos = torch.clamp(counts[0], min=1.0)
    neg = torch.clamp(counts[1], min=1.0)
    return torch.clamp(neg / pos, lo, hi)


def routing_regularizers(
    r_matrix: torch.Tensor,  # [B,R,K]
    route_mask: Optional[torch.Tensor] = None,  # [B,R]
    *,
    entropy_bonus: float = 0.0,
    uniform_penalty: float = 0.0,
) -> torch.Tensor:
    """Entropy bonus (rewards diverse routing) and uniformity penalty
    (punishes an exactly uniform collapse)."""
    if entropy_bonus == 0.0 and uniform_penalty == 0.0:
        return torch.zeros((), dtype=torch.float32, device=r_matrix.device)
    r = torch.clamp(r_matrix.float(), 1e-9, 1.0)
    loss = torch.zeros((), dtype=torch.float32, device=r.device)
    if entropy_bonus:
        loss = loss - entropy_bonus * (-(r * torch.log(r)).sum(dim=1)).mean()
    if uniform_penalty:
        if route_mask is not None:
            n_avail = torch.clamp(route_mask.float().sum(dim=1, keepdim=True), min=1.0)[..., None]
        else:
            n_avail = r.shape[1]
        loss = loss + uniform_penalty * ((r - 1.0 / n_avail) ** 2).sum(dim=1).mean()
    return loss


def eddi_loss(probs: torch.Tensor, targets: torch.Tensor, groups: torch.Tensor, num_groups: int = 2) -> torch.Tensor:
    """Differentiable EDDI: mean absolute deviation of each present group's
    mean error |p - y| from the overall mean error."""
    err = (probs.float() - targets.float()).abs()
    masks = [(groups == g).float() for g in range(num_groups)]
    # the global batch's sums on a mesh: error and count overall, then per group
    sums = global_sum(torch.stack([err.sum(), err.new_tensor(float(err.numel()))]
                                  + [x for m in masks for x in ((err * m).sum(), m.sum())]))
    overall = sums[0] / sums[1]
    total = torch.zeros((), dtype=torch.float32, device=err.device)
    count = torch.zeros((), dtype=torch.float32, device=err.device)
    for g in range(num_groups):
        n = sums[3 + 2 * g]
        has = (n > 0).float()
        total = total + has * (sums[2 + 2 * g] / torch.clamp(n, min=1.0) - overall).abs()
        count = count + has
    return total / torch.clamp(count, min=1.0)


def soft_eq_odds_loss(probs: torch.Tensor, targets: torch.Tensor, groups: torch.Tensor,
                      num_groups: int = 2) -> torch.Tensor:
    """Soft equalized odds: squared gaps between groups' mean scores among
    positives (a TPR proxy) and among negatives (an FPR proxy)."""
    probs, targets = probs.float(), targets.float()
    masks = [(groups == g).float() * sel for sel in (targets, 1.0 - targets) for g in range(num_groups)]
    # the global batch's sums on a mesh: score and count per (selection, group)
    sums = global_sum(torch.stack([x for m in masks for x in ((probs * m).sum(), m.sum())]))
    loss = torch.zeros((), dtype=torch.float32, device=probs.device)
    for s in range(2):
        rates, valid = [], []
        for g in range(num_groups):
            k = 2 * (s * num_groups + g)
            n = sums[k + 1]
            rates.append(sums[k] / torch.clamp(n, min=1.0))
            valid.append((n > 0).float())
        for i in range(num_groups):
            for j in range(i + 1, num_groups):
                loss = loss + valid[i] * valid[j] * (rates[i] - rates[j]) ** 2
    return loss


def ce_two_class(logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """2-class cross-entropy over [B, 2] logits, with label smoothing."""
    targets = targets.float()
    onehot = torch.stack([1.0 - targets, targets], dim=1)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + 0.5 * label_smoothing
    return -(onehot * F.log_softmax(logits.float(), dim=1)).sum(dim=1).mean()
