"""Capsule routing heads: route projector, route-width adapter, prior
composition and the decision head (counterpart of
multimodalrouting_tpu/routing/capsule_head.py).

Head styles: "rmatrix" (routing sees all-ones masked acts; logits from the
R-matrix aggregation of the primary poses), "class_linear" and "class_embed"
(the priors drive routing; logits from the decision poses).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.layers import Dense
from multimodalrouting_tpu_torch.ops.capsule import capsule_routing, capsule_weight_std, route_given_label

INTERACTION_ROUTES = ("LN", "NL", "LI", "IL", "NI", "IN", "LNI")


class RoutePrimaryProjector(nn.Module):
    """Per-route Linear(d_in -> pc_dim+1) as one stacked einsum ->
    (poses [B,R,pc], acts [B,R,1])."""

    def __init__(self, routes: Tuple[str, ...], d_in: int, pc_dim: int, use_route_logit_bias: bool = False,
                 interaction_bias_init: float = -0.8472978603872037, prior_floor: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.routes, self.pc_dim, self.prior_floor, self.dtype = tuple(routes), pc_dim, prior_floor, dtype
        r = len(routes)
        # lecun_normal on the whole [R, d_in, pc+1]: the route axis counts into the fan
        init.param(self, "kernel", init.lecun_normal, (r, d_in, pc_dim + 1))
        init.param(self, "bias", init.zeros, (r, pc_dim + 1))
        if use_route_logit_bias:
            values = tuple((interaction_bias_init if name in INTERACTION_ROUTES else 0.0,) for name in routes)
            init.param(self, "route_logit_bias", init.constant(values), (r, 1))
        else:
            self.route_logit_bias = None

    def forward(self, route_embs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        missing = set(self.routes) - set(route_embs)
        if missing:
            raise KeyError(f"route_embs missing routes: {sorted(missing)}")
        dt = self.dtype
        x = torch.stack([route_embs[k] for k in self.routes], dim=1).to(dt)  # [B,R,d_in]
        pc_all = torch.einsum("brd,rdp->brp", x, self.kernel.to(dt)) + self.bias.to(dt)[None]
        poses = pc_all[:, :, : self.pc_dim]
        raw_logits = pc_all[:, :, self.pc_dim :]
        if self.route_logit_bias is not None:
            raw_logits = raw_logits + self.route_logit_bias.to(dt)[None]
        acts = torch.sigmoid(raw_logits.float()).to(dt)
        if self.prior_floor > 0.0:
            acts = torch.clamp(acts, min=self.prior_floor)
        return poses, acts


class RouteDimAdapter(nn.Module):
    """Per-route Linear(d_src -> d_in, no bias) as one stacked einsum; the
    identity (no parameter) when d_src == d_in."""

    def __init__(self, routes: Tuple[str, ...], d_in: int, d_src: int, dtype=torch.float32):
        super().__init__()
        self.routes, self.dtype = tuple(routes), dtype
        self.identity = d_src == d_in
        if not self.identity:
            # lecun_normal on the whole [R, d_src, d_in]: the route axis counts into the fan
            init.param(self, "kernel", init.lecun_normal, (len(self.routes), d_src, d_in))

    def forward(self, route_embs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.identity:
            return dict(route_embs)
        dt = self.dtype
        x = torch.stack([route_embs[k] for k in self.routes], dim=1).to(dt)  # [B,R,src]
        y = torch.einsum("brs,rsd->brd", x, self.kernel.to(dt))
        return {k: y[:, i] for i, k in enumerate(self.routes)}


def compose_priors(
    acts: torch.Tensor,
    *,
    route_mask: Optional[torch.Tensor] = None,
    acts_override: Optional[torch.Tensor] = None,
    act_temperature: float = 1.0,
    prior_floor: float = 0.02,
    prior_ceiling: float = 0.98,
    detach: bool = False,
) -> torch.Tensor:
    """Priors [B,R,1] from projector acts: override -> mask multiply ->
    logit-space temperature (fp32) -> floor/ceiling clamp -> optional detach.
    With a route mask, temperature and clamp touch only kept entries."""
    if acts.dim() == 2:
        acts = acts[..., None]
    prior = acts if acts_override is None else acts_override.to(acts.dtype)
    if prior.dim() == 2:
        prior = prior[..., None]
    keep = None
    if route_mask is not None:
        rm = route_mask
        if rm.dim() == 1:
            rm = rm[None].expand(prior.shape[0], rm.shape[0])
        keep = rm[..., None].bool()
        prior = prior * rm[..., None].to(prior.dtype)
    if isinstance(act_temperature, torch.Tensor) or act_temperature != 1.0:
        x32 = torch.clamp(prior.float(), 1e-6, 1.0 - 1e-6)
        tempered = torch.sigmoid((torch.log(x32) - torch.log1p(-x32)) / act_temperature).to(prior.dtype)
        prior = torch.where(keep, tempered, prior) if keep is not None else tempered
    lo = prior_floor if prior_floor > 0.0 else 0.0
    hi = prior_ceiling if prior_ceiling > 0.0 else 1.0
    clamped = torch.clamp(prior, lo, hi)
    prior = torch.where(keep, clamped, prior) if keep is not None else clamped
    return prior.detach() if detach else prior


class CapsuleHeadOut(NamedTuple):
    logits: torch.Tensor  # [B,K]
    alpha: torch.Tensor  # [B,R] route activations (priors)
    r_matrix: torch.Tensor  # [B,R,K] p(route | label)
    coef: torch.Tensor  # [B,R,K] raw routing coefficients


class CapsuleHead(nn.Module):
    """Routing-by-agreement decision head over route capsules."""

    def __init__(self, num_routes: int, pc_dim: int, mc_caps_dim: int, num_classes: int,
                 num_routing: int = 3, head_style: str = "rmatrix", routing_mode: str = "softmax_out",
                 act_type: str = "ONES", uniform_routing: bool = False, gate_temp: float = 1.0,
                 gate_min: float = 0.0, gate_max: float = 1.0, dropout_rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate  # model.capsule_dropout, decision poses, training only
        if head_style not in ("rmatrix", "class_linear", "class_embed"):
            raise ValueError(f"Unknown head_style {head_style!r}")
        self.num_routes, self.num_routing, self.head_style = num_routes, num_routing, head_style
        self.routing_mode, self.act_type, self.uniform_routing = routing_mode, act_type, uniform_routing
        self.gate_temp, self.gate_min, self.gate_max, self.dtype = gate_temp, gate_min, gate_max, dtype
        init.param(self, "w", init.normal(capsule_weight_std(num_routes, pc_dim, num_classes)),
                   (num_routes, pc_dim, num_classes, mc_caps_dim))
        if head_style == "rmatrix":
            self.pose_to_mc = Dense(pc_dim, mc_caps_dim, bias=False, dtype=dtype)
        if head_style == "class_linear":
            init.param(self, "cls_kernel", init.normal(0.02), (num_classes, mc_caps_dim))
            init.param(self, "cls_bias", init.zeros, (num_classes,))
        else:
            init.param(self, "embedding", init.zeros, (num_classes, mc_caps_dim))
            init.param(self, "bias", init.zeros, (num_classes,))

    def forward(self, poses, priors, route_mask=None, generator=None) -> CapsuleHeadOut:
        b, r, _ = poses.shape
        if r != self.num_routes:
            raise ValueError(f"poses has {r} routes, head expects {self.num_routes}")
        if priors.dim() == 2:
            priors = priors[..., None]
        dt = self.dtype
        rm = None
        if route_mask is not None:
            rm = route_mask
            if rm.dim() == 1:
                rm = rm[None].expand(b, r)
            rm = rm.to(poses.dtype)
            poses = poses * rm[..., None]
            priors = priors * rm[..., None]
        if self.head_style == "rmatrix":
            routing_act = torch.ones((b, r), dtype=poses.dtype, device=poses.device)
            if rm is not None:
                routing_act = routing_act * rm
        else:
            routing_act = priors[..., 0]
        out = capsule_routing(
            poses, routing_act, self.w.to(dt), self.num_routing, mode=self.routing_mode,
            act_type=self.act_type, uniform_routing=self.uniform_routing, gate_temp=self.gate_temp,
            gate_min=self.gate_min, gate_max=self.gate_max, dropout_rate=self.dropout_rate,
            generator=generator,
        )
        alpha = priors[..., 0]
        r_matrix = route_given_label(out.coef, route_mask=rm)
        if self.head_style == "rmatrix":
            d_bkp = torch.einsum("brk,brp->bkp", r_matrix.float(), poses.float())
            d_bkm = self.pose_to_mc(d_bkp)
            logits = torch.einsum("bkm,km->bk", d_bkm, self.embedding.to(dt)) + self.bias.to(dt)[None]
        elif self.head_style == "class_linear":
            logits = torch.einsum("bkm,km->bk", out.pose.to(dt), self.cls_kernel.to(dt)) + self.cls_bias.to(dt)[None]
        else:
            logits = torch.einsum("bmd,md->bm", out.pose.to(dt), self.embedding.to(dt)) + self.bias.to(dt)[None]
        return CapsuleHeadOut(logits=logits, alpha=alpha, r_matrix=r_matrix, coef=out.coef)
