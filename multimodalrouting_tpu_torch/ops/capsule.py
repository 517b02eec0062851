"""Capsule routing-by-agreement on tensors.

Counterpart of multimodalrouting_tpu/ops/capsule.py. All routing math runs
in float32 whatever the compute dtype, and the outputs are cast back to the
pose dtype. The canonical mode (softmax_out, ONES acts, not uniform, no
dropout) goes to K3's wrapper (``ops/fused_capsule.py``): the fused Hopper
kernel on CUDA tensors, this plain program on CPU tensors, decided inside
the wrapper so that a program traced on the CPU keeps the kernel's op;
every other mode runs the plain program below.

Shapes:
    pose  [B, N, A]    primary capsule poses (N = #routes, A = pc_dim)
    act   [B, N]       primary capsule activations
    w     [N, A, M, D] routing weights (M = #decision caps, D = mc dim)
    -> decision pose [B, M, D], decision act [B, M], coef [B, N, M]
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class CapsuleOut(NamedTuple):
    pose: torch.Tensor  # [B, M, D]
    act: torch.Tensor  # [B, M]
    coef: torch.Tensor  # [B, N, M] routing coefficients


def capsule_weight_std(n_in: int, a: int, m: int) -> float:
    """The capsule weights' std, sqrt(M / (A * N)), as the JAX package draws them."""
    return math.sqrt(m / (a * n_in))


def capsule_weight_init(n_in: int, a: int, m: int, d: int, generator: Optional[torch.Generator] = None):
    """sqrt(M / (A * N)) * randn, as the JAX package initialises it."""
    return capsule_weight_std(n_in, a, m) * torch.randn((n_in, a, m, d), generator=generator)


def _gate_temp_and_clamp(act, temp: float, gmin: float, gmax: float, eps: float = 1e-6):
    """Logit-space temperature + clamp on activations (sigmoid_routes mode)."""
    a = torch.clamp(act, eps, 1.0 - eps)
    if temp and temp != 1.0:
        a = torch.sigmoid((torch.log(a) - torch.log1p(-a)) / temp)
    if gmin > 0.0 or gmax < 1.0:
        a = torch.clamp(a, gmin, gmax)
    return a


def routing_plain(
    pose: torch.Tensor,
    act: torch.Tensor,
    w: torch.Tensor,
    num_iters: int,
    *,
    mode: str = "softmax_out",
    act_type: str = "ONES",
    uniform_routing: bool = False,
    gate_temp: float = 1.0,
    gate_min: float = 0.0,
    gate_max: float = 1.0,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing program in float32 -> (pose, act, coef), all float32
    (`compute_dtype=torch.float64` gives a reference without fp32 rounding).

    Decision-pose dropout (inverted, at the end of every iteration) runs only
    when `dropout_rate > 0` and a `generator` is given, as the JAX function
    runs it only with a dropout key."""
    n_in, _, m_out, d_out = w.shape
    b = pose.shape[0]
    pose32, act32, w32 = (x.to(compute_dtype) for x in (pose, act, w))
    scale = 1.0 / math.sqrt(d_out)
    dev = pose.device

    if mode == "sigmoid_routes":
        act32 = _gate_temp_and_clamp(act32, gate_temp, gate_min, gate_max)
        seed_coef = torch.full((n_in, m_out), 1.0 / n_in, dtype=compute_dtype, device=dev)
    elif mode in ("softmax_out", "uniform"):
        seed_coef = torch.full((n_in, m_out), 1.0 / m_out, dtype=compute_dtype, device=dev)
    else:
        raise ValueError(f"Unknown capsule routing mode {mode!r}")

    votes = torch.einsum("bna,namd->bnmd", pose32, w32)
    next_pose = torch.einsum("nm,bnmd->bmd", seed_coef, votes)
    next_act = act32.mean(dim=1, keepdim=True).expand(b, m_out)
    uniform = uniform_routing or mode == "uniform"
    coef = seed_coef[None].expand(b, n_in, m_out)
    votes_act = votes * act32[:, :, None, None]
    use_dropout = dropout_rate > 0.0 and generator is not None
    keep_p = 1.0 - float(dropout_rate)

    for _ in range(int(num_iters)):
        if uniform:
            fill = 1.0 / n_in if mode == "sigmoid_routes" else 1.0 / m_out
            coef = torch.full((b, n_in, m_out), fill, dtype=compute_dtype, device=dev)
        else:
            agree = torch.einsum("bnmd,bmd->bnm", votes, next_pose) * scale
            if mode == "sigmoid_routes":
                qk = torch.clamp(torch.sigmoid(agree), 1e-6, 1.0 - 1e-6)
                coef = qk / torch.clamp(qk.sum(dim=1, keepdim=True), min=1e-6)
            else:
                qk = torch.softmax(agree, dim=2) * next_act[:, None, :]
                coef = qk / (qk.sum(dim=2, keepdim=True) + 1e-10)
        next_pose = torch.einsum("bnm,bnmd->bmd", coef, votes_act)
        if use_dropout:
            keep = torch.rand(next_pose.shape, generator=generator, device=dev) < keep_p
            next_pose = torch.where(keep, next_pose / keep_p, torch.zeros_like(next_pose))
        if act_type == "ONES":
            next_act = torch.ones((b, m_out), dtype=compute_dtype, device=dev)
    return next_pose, next_act, coef


def capsule_routing(
    pose: torch.Tensor,
    act: torch.Tensor,
    w: torch.Tensor,
    num_iters: int,
    *,
    mode: str = "softmax_out",
    act_type: str = "ONES",
    uniform_routing: bool = False,
    gate_temp: float = 1.0,
    gate_min: float = 0.0,
    gate_max: float = 1.0,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> CapsuleOut:
    """Run `num_iters` routing iterations; outputs in pose's dtype.

    mode "softmax_out" (canonical agreement softmax over M), "sigmoid_routes"
    (per-(route, label) sigmoid gates normalised over routes) or "uniform"."""
    if pose.dim() != 3:
        raise ValueError(f"pose must be [B,N,A], got {tuple(pose.shape)}")
    if act.dim() == 3 and act.shape[-1] == 1:
        act = act[..., 0]
    if act.dim() != 2:
        raise ValueError(f"act must be [B,N] or [B,N,1], got {tuple(act.shape)}")
    dropout = dropout_rate > 0.0 and generator is not None
    if mode == "softmax_out" and act_type == "ONES" and not uniform_routing and not dropout:
        # K3's wrapper on any device (the plain program on a CPU tensor), so
        # that a program exported on the CPU reaches the kernel on the card
        from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused

        p, a, c = capsule_routing_fused(pose, act, w, num_iters)
    else:
        p, a, c = routing_plain(
            pose, act, w, num_iters, mode=mode, act_type=act_type,
            uniform_routing=uniform_routing, gate_temp=gate_temp, gate_min=gate_min,
            gate_max=gate_max, dropout_rate=dropout_rate, generator=generator,
        )
    dt = pose.dtype
    return CapsuleOut(pose=p.to(dt), act=a.to(dt), coef=c.to(dt))


def route_given_label(coef: torch.Tensor, route_mask: Optional[torch.Tensor] = None, eps: float = 1e-10):
    """Normalise routing coefficients over routes per label: R[b,:,k] sums to 1."""
    resp = coef.float()
    if route_mask is not None:
        m = route_mask
        if m.dim() == 1:
            m = m[None, :, None]
        elif m.dim() == 2:
            m = m[:, :, None]
        resp = resp * m.float()
    denom = torch.clamp(resp.sum(dim=1, keepdim=True), min=eps)
    return (resp / denom).to(coef.dtype)
