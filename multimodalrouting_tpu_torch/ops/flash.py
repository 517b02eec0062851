"""Segment-id self-attention: the port of K4a (flash) and K4b (splash).

Counterpart of multimodalrouting_tpu/ops/flash.py. There,
``flash_self_attention`` (K4a) and ``splash_self_attention`` (K4b) wrap the
upstream Pallas flash and splash kernels over [B, H, T, dh] with segment ids
q = kv = the key mask, a full non-causal mask and q pre-scaled, so both
compute one function, segment attention:

- a valid query attends the valid keys;
- a pad query attends the pad keys only;
- an all-pad chunk gets an ordinary softmax over all of its keys.

This is not K1's function on pad rows (K1's pad queries attend the valid
keys, and its all-pad rows are uniform); valid rows agree.

Both wrappers here take q, k, v as [N, T, H, dh] (a view of the
projections' [N, T, H*dh] layout: the kernels read it in place) plus the
[N, T] mask, and launch one Hopper kernel pair: ``csrc/flash_attention.cu``
forward and ``csrc/flash_attention_bwd.cu`` backward, each wrapper under its
own launch counters (``.launches`` forward, ``.bwd_launches`` backward). On
a CPU tensor they run the plain versions ``segment_attention_reference``
and ``segment_attention_bwd_reference``; on a CUDA tensor they launch the
kernel or raise. Under a gradient they go through ``SegmentAttention``, an
autograd Function whose forward also keeps each row's log-sum-exp and whose
backward takes di = rowsum(o * do) from the saved output with the di kernel
that K2 launches too (``csrc/attention_bwd.cuh``), ahead of its two product
kernels, as the upstream backward takes it from XLA before its kernels.

``attention_impl`` is the JAX package's selector: MMR_ATTN = flash
(default) | packed | splash | xla, with MMR_FLASH=0 selecting xla.
The JAX package's TPU tiling variables (MMR_FLASH_BLOCK_*, MMR_SPLASH_BLOCK_*)
and MMR_SPLASH_INTERPRET change no result and are not ported.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from multimodalrouting_tpu_torch.ops import hopper
from multimodalrouting_tpu_torch.ops.flash_packed import cuda_mask

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # upstream DEFAULT_MASK_VALUE
BLOCK_K = 512  # the JAX package's key block, min(512, T) (flash.py:128)


def attention_impl() -> str:
    """Self-attention kernel selector: MMR_ATTN = flash (default) | packed |
    splash | xla; MMR_FLASH set to another value than 1 selects xla (the
    JAX package's ``attention_impl`` and ``_use_flash_attention`` together).
    Under "flash", frozen or packed-backward-covered shapes take the packed
    kernels (K1/K2) and the rest of the gate takes K4a; "packed" forces K1
    wherever it is supported; "splash" takes K4b wherever ``supports``
    holds."""
    if os.environ.get("MMR_FLASH", "1") != "1":
        return "xla"
    return os.environ.get("MMR_ATTN", "flash")


def supports(tq: int, tk: int, head_dim: int) -> bool:
    """The JAX package's gate: self-attention with T >= 256, T % 128 == 0
    (no upper limit), head_dim in {64, 128}, any head count."""
    return tq == tk and tq >= 256 and tq % 128 == 0 and head_dim in (64, 128)


def segment_logits(q, k, kv_mask) -> torch.Tensor:
    """fp32 logits [N, H, T, T] plus where(m_q == m_k, 0, MASK_VALUE)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = kv_mask.float()
    same = m[:, None, :, None] == m[:, None, None, :]
    return s + torch.where(same, 0.0, MASK_VALUE)


def segment_attention_reference(q, k, v, kv_mask) -> torch.Tensor:
    """Plain version of K4 in the upstream flash kernel's order at the JAX
    package's key block, min(512, T). One block (T <= 512,
    flash_attention.py:540-557): p = exp(s - rowmax) / l in fp32, rounded to
    the input type, p @ v accumulated in fp32. Several blocks (T > 512,
    :440-477): per block m_next = max(m, rowmax), p = exp(s - m_next) rounded
    to the input type unnormalised, acc = acc * (l_corr / l_next) +
    (p @ v) / l_next. Output [N, T, H, dh] in the input type."""
    dt = q.dtype
    s = segment_logits(q, k, kv_mask)
    vf = v.float()
    t = s.shape[-1]
    if t <= BLOCK_K:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), vf)
        return out.to(dt)
    m_prev = torch.full(s.shape[:-1] + (1,), -float("inf"), dtype=torch.float32, device=s.device)
    l_prev = torch.zeros_like(m_prev)
    acc = torch.zeros(s.shape[:-1] + (v.shape[-1],), dtype=torch.float32, device=s.device)
    for k0 in range(0, t, BLOCK_K):
        sb = s[..., k0 : k0 + BLOCK_K]
        m_next = torch.maximum(m_prev, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_next)
        l_corr = torch.exp(m_prev - m_next) * l_prev
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), vf[:, k0 : k0 + BLOCK_K])
        acc = acc * (l_corr * inv) + pv * inv
        m_prev, l_prev = m_next, l_next
    return acc.transpose(1, 2).to(dt)


def segment_attention_bwd_reference(q, k, v, kv_mask, out, do) -> Tuple[torch.Tensor, ...]:
    """Plain version of K4's backward in the upstream order
    (flash_attention.py:254-275, :895-920, :1227-1261): p = exp(s - m) / l in
    fp32; di = rowsum(o * do) from the saved output `out`; dv = p^T do with p
    rounded to the input type; ds = (do v^T - di) * p; dk = ds^T q and
    dq = ds k with ds rounded to the input type; fp32 accumulation, outputs
    in the input type. -> (dq, dk, dv), each [N, T, H, dh]."""
    dt = q.dtype
    s = segment_logits(q, k, kv_mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    di = (out.float() * dof).sum(dim=-1).transpose(1, 2)[..., None]  # [N, H, T, 1]
    ds = ((dp - di) * p).to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_cuda(named) -> None:
    """What the kernels take: bf16 or fp32 [N, T, H, dh] tensors of one
    shape, dtype and device, each head's row contiguous, row strides and base
    pointers 16-byte aligned (vector loads)."""
    (_, ref), *rest = named
    if not ref.is_cuda:
        raise ValueError(f"segment attention runs on CUDA or CPU tensors, got {ref.device}")
    if ref.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"segment attention takes bfloat16 or float32, got {ref.dtype}")
    for name, x in rest:
        if x.shape != ref.shape or x.dtype != ref.dtype or x.device != ref.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, x in named:
        if x.stride(3) != 1 or x.stride(2) != x.shape[3] or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: each head's row must be contiguous, with 16-byte aligned rows")


def segment_attention_fwd(q, k, v, kv_mask, want_lse: bool, counter):
    """The forward kernel on CUDA tensors [N, T, H, dh] -> (out [N, T, H, dh],
    lse [N, H, T] fp32 or None without `want_lse`). Adds one to
    `counter.launches` (the calling wrapper) per launch."""
    n, t, h, dh = q.shape
    _check_cuda((("q", q), ("k", k), ("v", v)))
    mask = cuda_mask(kv_mask, q)
    out = torch.empty((n, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, t), dtype=torch.float32, device=q.device) if want_lse else None
    lib = hopper.library("flash_attention")
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_f32
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        n, t, h, dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    hopper.check(rc, "flash_attention")
    counter.launches += 1
    return out, lse


def segment_attention_bwd(q, k, v, kv_mask, out, lse, do, counter) -> Tuple[torch.Tensor, ...]:
    """K4's backward -> (dq, dk, dv) [N, T, H, dh] in q's dtype. On CUDA
    tensors it launches the di kernel (di = rowsum(out * do)) and the two
    product kernels with the forward's `lse` [N, H, T] (or raises), adding
    one to `counter.bwd_launches`; on CPU tensors it runs the plain version."""
    n, t, h, dh = q.shape
    if not supports(t, k.shape[1], dh):
        raise ValueError(f"segment attention backward unsupported for T={t}, head_dim={dh}")
    if q.device.type == "cpu":
        return segment_attention_bwd_reference(q, k, v, kv_mask, out, do)
    _check_cuda((("q", q), ("k", k), ("v", v), ("do", do), ("out", out)))
    mask = cuda_mask(kv_mask, q)
    if lse is None or lse.shape != (n, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{n}, {h}, {t}] from the forward kernel")
    dq, dk, dv = (torch.empty((n, t, h, dh), dtype=q.dtype, device=q.device) for _ in range(3))
    di = torch.empty((n, h, t), dtype=torch.float32, device=q.device)
    lib = hopper.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_bwd_f32
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(), out.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
        n, t, h, dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1), do.stride(0), do.stride(1), dq.stride(0), dq.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    hopper.check(rc, "flash_attention_bwd")
    counter.bwd_launches += 1
    return dq, dk, dv


class SegmentAttention(torch.autograd.Function):
    """K4 forward (keeping its log-sum-exp on CUDA), K4 backward, each
    counted on `counter` (the wrapper that was called). The mask takes no
    gradient; the scale of q belongs to the caller's graph."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, counter):
        if q.device.type == "cpu":
            out, lse = segment_attention_reference(q, k, v, kv_mask), None
        else:
            out, lse = segment_attention_fwd(q, k, v, kv_mask, True, counter)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.counter = counter
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = segment_attention_bwd(q, k, v, kv_mask, out, lse, do.contiguous(), ctx.counter)
        return dq, dk, dv, None, None


def _segment_attention(q, k, v, kv_mask, counter) -> torch.Tensor:
    n, t, h, dh = q.shape
    if not supports(t, k.shape[1], dh):
        raise ValueError(f"segment attention unsupported for T={t}, head_dim={dh}")
    if kv_mask is None:
        kv_mask = torch.ones((n, t), dtype=torch.float32, device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SegmentAttention.apply(q, k, v, kv_mask.float(), counter)
    if q.device.type == "cpu":
        return segment_attention_reference(q, k, v, kv_mask)
    return segment_attention_fwd(q, k, v, kv_mask, False, counter)[0]


def flash_self_attention(
    q: torch.Tensor,  # [N, T, H, dh], already scaled by dh**-0.5
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],  # [N, T], 1 = valid
) -> torch.Tensor:
    """K4a: segment attention -> [N, T, H, dh] in q's dtype."""
    return _segment_attention(q, k, v, kv_mask, flash_self_attention)


def splash_self_attention(
    q: torch.Tensor,  # [N, T, H, dh], already scaled by dh**-0.5
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],  # [N, T], 1 = valid
) -> torch.Tensor:
    """K4b: the same function through the same kernels, counted apart."""
    return _segment_attention(q, k, v, kv_mask, splash_self_attention)


for _wrapper in (flash_self_attention, splash_self_attention):
    _wrapper.launches = 0
    _wrapper.bwd_launches = 0
