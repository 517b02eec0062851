"""Fused capsule routing (K3): all iterations in one Hopper kernel.

Counterpart of multimodalrouting_tpu/ops/pallas_capsule.py. The kernel
(``csrc/capsule_routing.cu``) computes ``ops/capsule.py:capsule_routing`` in
its softmax_out / ONES mode as one thread-block cluster per tile of up to 16
batch rows, the votes resident in the CTAs' shared memory across
iterations; it reads fp32 or bf16 inputs as they are and writes fp32.
``capsule_routing_fused`` launches it on CUDA
tensors (or raises) and runs ``capsule_routing_reference``, the plain
version, on CPU tensors; without a gradient it does so through the custom
op ``mmr::capsule_routing``, which ``torch.export`` keeps in a serving
program. Under a gradient it goes through
``FusedCapsuleRouting``, an autograd Function with that forward whose
backward recomputes the plain program under autograd and returns its VJP,
as pallas_capsule.py does: the JAX package has no backward kernel for K3.
"""
from __future__ import annotations

from typing import Tuple

import torch

from multimodalrouting_tpu_torch.ops import hopper
from multimodalrouting_tpu_torch.ops.capsule import routing_plain


def capsule_routing_reference(pose, act, w, num_iters: int, compute_dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """Plain version of K3: the routing program in softmax_out / ONES mode
    (in float64 with `compute_dtype`, the checks' exact reference)."""
    return routing_plain(pose, act, w, num_iters, mode="softmax_out", act_type="ONES", compute_dtype=compute_dtype)


class FusedCapsuleRouting(torch.autograd.Function):
    """K3 forward; backward = the VJP of the plain program, recomputed."""

    @staticmethod
    def forward(ctx, pose, act, w, num_iters: int):
        ctx.save_for_backward(pose, act, w)
        ctx.num_iters = num_iters
        if pose.device.type == "cpu":
            return capsule_routing_reference(pose, act, w, num_iters)
        return _launch(pose, act, w, num_iters)

    @staticmethod
    def backward(ctx, *cotangents):
        inputs = [x.detach().requires_grad_(x.requires_grad) for x in ctx.saved_tensors]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            outs = capsule_routing_reference(*inputs, ctx.num_iters)
            # the decision act (all ones under ONES) depends on no input
            live = [(o, c) for o, c in zip(outs, cotangents) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in live], wanted, [c for _, c in live], allow_unused=True))
        return tuple(next(grads) if x.requires_grad else None for x in inputs) + (None,)


def capsule_routing_fused(
    pose: torch.Tensor,  # [B, N, A]
    act: torch.Tensor,  # [B, N]
    w: torch.Tensor,  # [N, A, M, D]
    num_iters: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (decision pose [B,M,D], decision act [B,M], coef [B,N,M]), fp32."""
    if torch.is_grad_enabled() and (pose.requires_grad or act.requires_grad or w.requires_grad):
        return FusedCapsuleRouting.apply(pose, act, w, int(num_iters))
    return torch.ops.mmr.capsule_routing(pose, act, w, int(num_iters))


_ENTRY = {torch.float32: "capsule_routing_f32", torch.bfloat16: "capsule_routing_bf16"}


def _launch(pose, act, w, num_iters: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors (or raises). The kernel reads pose, act and w in
    their own type (all fp32 or all bf16, as the head hands them over), so
    nothing is cast before the launch."""
    if not pose.is_cuda:
        raise ValueError(f"capsule routing runs on CUDA or CPU tensors, got {pose.device}")
    b, n, a = pose.shape
    n_w, a_w, m, d = w.shape
    if (n_w, a_w) != (n, a) or tuple(act.shape) != (b, n):
        raise ValueError(f"shape mismatch: pose {tuple(pose.shape)}, act {tuple(act.shape)}, w {tuple(w.shape)}")
    if pose.dtype not in _ENTRY or act.dtype != pose.dtype or w.dtype != pose.dtype:
        raise ValueError(f"K3 takes pose, act and w all fp32 or all bf16, got {pose.dtype}, {act.dtype}, {w.dtype}")
    if act.device != pose.device or w.device != pose.device:
        raise ValueError(f"pose, act and w must be on one device, got {pose.device}, {act.device}, {w.device}")
    dev = pose.device
    # the kernel reads pose and w through TMA tensor maps: 16-byte aligned starts
    pose, w = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (pose.contiguous(), w.contiguous()))
    act = act.contiguous()
    pose_out = torch.empty((b, m, d), dtype=torch.float32, device=dev)
    act_out = torch.empty((b, m), dtype=torch.float32, device=dev)
    coef_out = torch.empty((b, n, m), dtype=torch.float32, device=dev)
    rc = getattr(hopper.library("capsule_routing"), _ENTRY[pose.dtype])(
        pose.data_ptr(), act.data_ptr(), w.data_ptr(),
        pose_out.data_ptr(), act_out.data_ptr(), coef_out.data_ptr(),
        b, n, a, m, d, int(num_iters), torch.cuda.current_stream(dev).cuda_stream,
    )
    # cudaErrorInvalidValue: beyond the limits in csrc/capsule_routing.cu's note
    hopper.check(rc, f"capsule_routing of B={b}, N={n}, A={a}, M={m}, D={d} in {pose.dtype}")
    capsule_routing_fused.launches += 1
    return pose_out, act_out, coef_out


def empty_launch(device) -> None:
    """One launch of K3's library's empty kernel: the device time any single
    launch costs (chip_smoke.py's floor_ms). Not counted as a K3 launch."""
    lib = hopper.library("capsule_routing")
    hopper.check(lib.capsule_routing_empty(torch.cuda.current_stream(device).cuda_stream), "capsule_routing_empty")


capsule_routing_fused.launches = 0


@torch.library.custom_op("mmr::capsule_routing", mutates_args=(), device_types="cuda")
def _capsule_routing_op(pose: torch.Tensor, act: torch.Tensor, w: torch.Tensor,
                        num_iters: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 without a gradient as the custom op ``mmr::capsule_routing`` (what
    a ``torch.export`` program calls): ``_launch`` on CUDA tensors, counted
    there."""
    return _launch(pose, act, w, num_iters)


@_capsule_routing_op.register_kernel("cpu")
def _capsule_routing_cpu(pose, act, w, num_iters):
    return tuple(x.contiguous() for x in capsule_routing_reference(pose, act, w, num_iters))


@_capsule_routing_op.register_fake
def _capsule_routing_fake(pose, act, w, num_iters):
    b, n, _ = pose.shape
    m, d = w.shape[2], w.shape[3]
    f32 = torch.float32
    return pose.new_empty((b, m, d), dtype=f32), pose.new_empty((b, m), dtype=f32), pose.new_empty((b, n, m), dtype=f32)
