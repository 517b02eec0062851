"""Packed-layout self-attention: q/k/v stay [N, T, H*dh] (K1).

Counterpart of multimodalrouting_tpu/ops/flash_packed.py. The projections'
natural layout is [N, T, H*dh]; the kernel reads the strided [N, T, H, dh]
view of it in place and writes the packed layout the out-projection wants,
so no head-split copy is made on either side. On the chunk-BERT grid
(128 chunks x 512 tokens, 12 heads of 64) it runs once per BERT layer.

``packed_attention`` is the wrapper: on a CUDA tensor it launches the
hand-written Hopper kernel (``csrc/packed_attention.cu``) or raises; on a CPU
tensor it runs ``packed_attention_reference``, the plain version with the
TPU kernel's arithmetic order. The kernel is forward-only: its backward
(the TPU's ``_bwd_kernel``) comes with the training path, so a call on CUDA
tensors that require grad raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from multimodalrouting_tpu_torch.ops import hopper

MAX_T = 1024
MAX_T_BWD = 512


def supports_packed(tq: int, tk: int, head_dim: int, d: int, num_heads: int) -> bool:
    """The JAX package's gate, unchanged: self-attention with 256 <= T <= 1024,
    T % 128 == 0, head_dim in {64, 128}, an even head count at head_dim 64."""
    if tq != tk or tq < 256 or tq > MAX_T or tq % 128 != 0:
        return False
    if head_dim not in (64, 128) or d % 128 != 0 or num_heads * head_dim != d:
        return False
    if head_dim == 64 and num_heads % 2 != 0:
        return False
    return True


def supports_packed_bwd(t: int, head_dim: int) -> bool:
    return t <= MAX_T_BWD and head_dim in (64, 128)


def packed_attention_reference(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    """Plain version of K1 in the TPU kernel's order: fp32 logits plus
    (1 - m) * -1e30, fp32 softmax, p normalised then cast to the input type,
    p @ v accumulated in fp32, output cast to the input type."""
    n, t, d = q.shape
    dh = d // num_heads
    q4 = q.reshape(n, t, num_heads, dh).float()
    k4 = k.reshape(n, t, num_heads, dh).float()
    v4 = v.reshape(n, t, num_heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    logits = logits + ((1.0 - kv_mask.float()) * -1e30)[:, None, None, :]
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v4.float())
    return out.reshape(n, t, d).to(q.dtype)


def packed_attention(
    q: torch.Tensor,  # [N, T, H*dh], already scaled by dh**-0.5
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],  # [N, T], 1 = valid key
    num_heads: int,
) -> torch.Tensor:
    """Self-attention in the packed layout -> [N, T, H*dh] in q's dtype."""
    n, t, d = q.shape
    head_dim = d // num_heads
    if not supports_packed(t, k.shape[1], head_dim, d, num_heads):
        raise ValueError(f"packed attention unsupported for T={t}, d={d}, heads={num_heads}")
    if kv_mask is None:
        kv_mask = torch.ones((n, t), dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, kv_mask, num_heads)
    if not q.is_cuda:
        raise ValueError(f"packed attention runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("the packed attention kernel is forward-only: call it under torch.no_grad()")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"packed attention takes bfloat16 or float32, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # rows of 16-byte-aligned 16-byte chunks (vector loads in the kernel)
        if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: inner dim must be contiguous with 16-byte aligned rows")
    mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if mask.shape != (n, t):
        raise ValueError(f"kv_mask must be [{n}, {t}], got {tuple(mask.shape)}")
    out = torch.empty((n, t, d), dtype=q.dtype, device=q.device)
    lib = hopper.library("packed_attention")
    fn = lib.packed_attention_bf16 if q.dtype == torch.bfloat16 else lib.packed_attention_f32
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n, t, num_heads, head_dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    hopper.check(rc, "packed_attention")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0
