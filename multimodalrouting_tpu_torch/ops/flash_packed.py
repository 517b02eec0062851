"""Packed-layout self-attention: q/k/v stay [N, T, H*dh] (K1 forward, K2
backward).

Counterpart of multimodalrouting_tpu/ops/flash_packed.py. The projections'
natural layout is [N, T, H*dh]; the kernels read the strided [N, T, H, dh]
view of it in place and write the packed layout, so no head-split copy is
made on either side. On the chunk-BERT grid (128 chunks x 512 tokens, 12
heads of 64) K1 runs once per BERT layer, and K2 once per fine-tuned layer
in the backward.

``packed_attention`` is the entry point. Without a gradient it calls the
custom op ``mmr::packed_attention``, which runs K1
(``csrc/packed_attention.cu``) on a CUDA tensor, or raises, and
``packed_attention_reference``, the plain version with the TPU kernel's
arithmetic order, on a CPU tensor; as an op, the kernel is a node that
``torch.export`` keeps in a serving program (``artifact.py``). Under a gradient it goes through
``PackedAttention``, an autograd Function whose forward is the same and also
keeps K1's per-row log-sum-exp and its output, and whose backward is
``packed_attention_bwd``: K2 (``csrc/packed_attention_bwd.cu``) on CUDA
tensors, ``packed_attention_bwd_reference`` on CPU tensors. K2 takes each
row's rowsum(dp * p) as di = rowsum(o * do) from the saved output, with the
di kernel both attention backwards launch first (``attention_bwd_di``,
plain version ``attention_bwd_di_reference``); the saved output is the
tensor the out-projection keeps for its own backward, so saving it costs no
memory. ``MMR_PACKED_BWD=xla`` (read at each backward) is the JAX
package's way around its Pallas backward: on CPU tensors the backward is
then autograd's VJP of the plain version (``packed_attention_vjp_reference``),
recomputed from the saved q, k, v as the JAX package's takes the VJP of its
XLA attention; on CUDA tensors it raises, because the port's backward there
is K2.
``supports_packed_bwd`` is the JAX package's gate for the backward: a caller
whose shape fails it under a gradient takes the eager attention instead
(models/attention.py), as the JAX package takes the XLA VJP.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    n, t, d = x.shape
    return x.reshape(n, t, num_heads, d // num_heads).float()


def _softmax_p(q, k, kv_mask, num_heads: int) -> torch.Tensor:
    """fp32 p [N, H, T, T] of logits + (1 - m) * -1e30."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads), _heads(k, num_heads))
    logits = logits + ((1.0 - kv_mask.float()) * -1e30)[:, None, None, :]
    return torch.softmax(logits, dim=-1)


def packed_attention_reference(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    """Plain version of K1 in the TPU kernel's order: fp32 logits plus
    (1 - m) * -1e30, fp32 softmax, p normalised then cast to the input type,
    p @ v accumulated in fp32, output cast to the input type."""
    n, t, d = q.shape
    p = _softmax_p(q, k, kv_mask, num_heads).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), _heads(v, num_heads))
    return out.reshape(n, t, d).to(q.dtype)


def packed_attention_bwd_reference(q, k, v, kv_mask, do, num_heads: int,
                                   di: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Plain version of K2 in the TPU kernel's order (flash_packed.py
    _bwd_kernel): recompute the fp32 softmax p; dv = p^T do with p cast to
    the input type; dp = do v^T; ds = p (dp - rowsum(dp p)); dq = ds k and
    dk = ds^T q with ds cast to the input type; fp32 accumulation, outputs in
    the input type. -> (dq, dk, dv), each [N, T, H*dh]. Given `di` [N, H, T]
    (``attention_bwd_di_reference`` of the output), ds takes it in place of
    rowsum(dp p): the kernel's order."""
    n, t, d = q.shape
    dt = q.dtype
    p = _softmax_p(q, k, kv_mask, num_heads)
    do4 = _heads(do, num_heads)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do4)
    dp = torch.einsum("bqhd,bkhd->bhqk", do4, _heads(v, num_heads))
    rowsum = (dp * p).sum(dim=-1, keepdim=True) if di is None else di.float()[..., None]
    ds = (p * (dp - rowsum)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads(k, num_heads))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _heads(q, num_heads))
    return tuple(x.reshape(n, t, d).to(dt) for x in (dq, dk, dv))


def attention_bwd_di_reference(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of the di kernel: di = rowsum(o * do) in fp32 over
    [N, T, H, dh] views -> [N, H, T]."""
    return (out.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def attention_bwd_di(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The di kernel alone (both attention backwards launch it first, inside
    their own entry points) on [N, T, H, dh] views -> [N, H, T] fp32; the
    plain version on CPU tensors."""
    if out.device.type == "cpu":
        return attention_bwd_di_reference(out, do)
    n, t, h, dh = out.shape
    if t % 128 or dh not in (64, 128):
        raise ValueError(f"the di kernel takes T % 128 == 0 and head_dim 64 or 128, got T={t}, head_dim={dh}")
    for name, x in (("out", out), ("do", do)):
        if x.shape != out.shape or x.dtype != out.dtype or x.device != out.device:
            raise ValueError(f"{name} must match out in shape, dtype and device")
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the di kernel takes bfloat16 or float32, got {x.dtype}")
        if x.stride(3) != 1 or x.stride(2) != dh or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: each head's row must be contiguous, with 16-byte aligned rows")
    di = torch.empty((n, h, t), dtype=torch.float32, device=out.device)
    lib = hopper.library("packed_attention_bwd")
    fn = lib.attention_bwd_di_bf16 if out.dtype == torch.bfloat16 else lib.attention_bwd_di_f32
    rc = fn(out.data_ptr(), do.data_ptr(), di.data_ptr(), n, t, h, dh, out.stride(0), out.stride(1),
            do.stride(0), do.stride(1), torch.cuda.current_stream(out.device).cuda_stream)
    hopper.check(rc, "attention_bwd_di")
    attention_bwd_di.launches += 1
    return di


def _check_cuda(named) -> None:
    """What K1 and K2 take: bf16 or fp32 tensors of one shape, dtype and
    device; each row's inner dimension contiguous with 16-byte aligned rows
    (vector loads in the kernels)."""
    (_, ref), *rest = named
    if not ref.is_cuda:
        raise ValueError(f"packed attention runs on CUDA or CPU tensors, got {ref.device}")
    if ref.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"packed attention takes bfloat16 or float32, got {ref.dtype}")
    for name, x in rest:
        if x.shape != ref.shape or x.dtype != ref.dtype or x.device != ref.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, x in named:
        if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: inner dim must be contiguous with 16-byte aligned rows")


def cuda_mask(kv_mask: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The [N, T] key mask as the kernels read it: contiguous fp32 on q's
    device (q is [N, T, ...])."""
    n, t = q.shape[:2]
    mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if mask.shape != (n, t):
        raise ValueError(f"kv_mask must be [{n}, {t}], got {tuple(mask.shape)}")
    return mask


def packed_attention_fwd(q, k, v, kv_mask, num_heads: int, want_lse: bool):
    """The K1 wrapper on CUDA tensors -> (out [N, T, D], lse [N, H, T] fp32,
    or None without `want_lse`)."""
    n, t, d = q.shape
    _check_cuda((("q", q), ("k", k), ("v", v)))
    mask = cuda_mask(kv_mask, q)
    out = torch.empty((n, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, num_heads, t), dtype=torch.float32, device=q.device) if want_lse else None
    lib = hopper.library("packed_attention")
    fn = lib.packed_attention_bf16 if q.dtype == torch.bfloat16 else lib.packed_attention_f32
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        n, t, num_heads, d // num_heads,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    hopper.check(rc, "packed_attention")
    packed_attention.launches += 1
    return out, lse


def packed_attention_bwd(q, k, v, kv_mask, out, lse, do, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """The K2 wrapper -> (dq, dk, dv) in q's dtype. On CUDA tensors it
    launches the di kernel and the two product kernels with K1's output `out`
    and `lse` [N, H, T] (or raises); on CPU tensors it runs the plain version
    in the TPU order, which needs neither."""
    n, t, d = q.shape
    head_dim = d // num_heads
    if not supports_packed_bwd(t, head_dim) or not supports_packed(t, k.shape[1], head_dim, d, num_heads):
        raise ValueError(f"packed attention backward unsupported for T={t}, d={d}, heads={num_heads}")
    if q.device.type == "cpu":
        return packed_attention_bwd_reference(q, k, v, kv_mask, do, num_heads)
    _check_cuda((("q", q), ("k", k), ("v", v), ("do", do), ("out", out)))
    mask = cuda_mask(kv_mask, q)
    if lse is None or lse.shape != (n, num_heads, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{n}, {num_heads}, {t}] from the forward kernel")
    dq, dk, dv = (torch.empty((n, t, d), dtype=q.dtype, device=q.device) for _ in range(3))
    di = torch.empty((n, num_heads, t), dtype=torch.float32, device=q.device)
    lib = hopper.library("packed_attention_bwd")
    fn = lib.packed_attention_bwd_bf16 if q.dtype == torch.bfloat16 else lib.packed_attention_bwd_f32
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(), out.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
        n, t, num_heads, head_dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1), do.stride(0), do.stride(1), dq.stride(0), dq.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    hopper.check(rc, "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    return dq, dk, dv


def packed_bwd_impl(device: torch.device) -> str:
    """``MMR_PACKED_BWD`` for a backward on `device`, read at each backward
    as the JAX package reads it (flash_packed.py:_packed_bwd): ``xla`` takes
    the plain attention's VJP on the CPU and raises on the card, anything
    else (``pallas``, the default) K2."""
    impl = os.environ.get("MMR_PACKED_BWD", "pallas")
    if impl == "xla" and device.type != "cpu":
        raise ValueError(
            "MMR_PACKED_BWD=xla selects the JAX package's XLA backward in place of its Pallas kernel; "
            "on the card the port's packed backward is K2 (ops/flash_packed.py): unset MMR_PACKED_BWD"
        )
    return impl


def packed_attention_vjp_reference(q, k, v, kv_mask, do, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv): autograd's VJP of ``packed_attention_reference`` at
    the saved q, k, v, recomputed here, so that no [N, H, T, T] tensor lives
    from the forward to the backward (the JAX package's ``jax.vjp`` of its
    XLA attention inside the backward, under ``MMR_PACKED_BWD=xla``)."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = packed_attention_reference(q, k, v, kv_mask, num_heads)
        return torch.autograd.grad(out, (q, k, v), do)


class PackedAttention(torch.autograd.Function):
    """K1 forward (keeping its output and, on CUDA, its log-sum-exp), K2
    backward (on CPU tensors under ``MMR_PACKED_BWD=xla``, the plain VJP;
    on CUDA tensors that switch raises). The mask takes
    no gradient; the scale of q belongs to the caller's graph."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads: int):
        if q.device.type == "cpu":
            out, lse = packed_attention_reference(q, k, v, kv_mask, num_heads), None
        else:
            out, lse = packed_attention_fwd(q, k, v, kv_mask, num_heads, want_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        if packed_bwd_impl(q.device) == "xla":
            dq, dk, dv = packed_attention_vjp_reference(q, k, v, kv_mask, do, ctx.num_heads)
        else:
            dq, dk, dv = packed_attention_bwd(q, k, v, kv_mask, out, lse, do.contiguous(), ctx.num_heads)
        return dq, dk, dv, None, None


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if not supports_packed_bwd(t, head_dim):
            raise ValueError(f"packed attention under a gradient needs T <= {MAX_T_BWD}, got T={t}")
        return PackedAttention.apply(q, k, v, kv_mask.float(), num_heads)
    return torch.ops.mmr.packed_attention(q, k, v, kv_mask, num_heads)


@torch.library.custom_op("mmr::packed_attention", mutates_args=(), device_types="cuda")
def _packed_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """K1's forward without a gradient as the custom op ``mmr::packed_attention``
    (what a ``torch.export`` program calls): the wrapper's launch on CUDA
    tensors, counted there."""
    return packed_attention_fwd(q, k, v, kv_mask, num_heads, want_lse=False)[0]


@_packed_attention_op.register_kernel("cpu")
def _packed_attention_cpu(q, k, v, kv_mask, num_heads):
    return packed_attention_reference(q, k, v, kv_mask, num_heads).contiguous()


@_packed_attention_op.register_fake
def _packed_attention_fake(q, k, v, kv_mask, num_heads):
    return q.new_empty(q.shape)


packed_attention.launches = 0
packed_attention_bwd.launches = 0
attention_bwd_di.launches = 0
