#!/usr/bin/env python3
"""Drive the PyTorch port's flagship serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It

1. builds the Hopper kernels from multimodalrouting_tpu_torch/csrc/ (one
   nvcc per source, in parallel) and prints the build time and ptxas report;
2. holds K1 (packed attention) against its plain version at the flagship
   shape [128, 512, 768] in bf16 with masks from the synthetic cohort
   (all-pad chunks included), in fp32 at a smaller N, and at head_dim 128;
3. holds K2 (the packed attention's backward) against its plain version at
   the same shapes, with a cotangent on every row, and shows that the bf16
   limits reject two planted faults;
4. holds K3 (fused capsule routing) against its plain version at
   [16, 10, 32] x [10, 32, 2, 64], and its autograd gradients against
   autograd through the plain program;
5. writes a full-width flagship checkpoint (BERT-base 12 x 768 over 8 x 512
   note chunks, ResNet34 on 224^2, MulT d=256, 10-route capsule head, bf16)
   with seeded random weights, loads it with Predictor(device="cuda") and
   serves one record, a batch of 16, a record without an image and one HTTP
   request, with the kernels' launch counters read around exactly that run;
   the same weights scored in fp32 on the CPU are the reference;
6. trains the full-width flagship with fine-tuned notes (batch 16, note
   packing on): 2 warm-up and 5 timed steps with the launch counters read
   around the timed ones, then one step's profile; one step under the
   frozen-text default; and train_model over 32 + 16 stays for one epoch,
   whose checkpoint Predictor(device="cuda") serves;
7. prints a {"kernels": [...]} line, the card's name and power limit, and
   the {"ok": true, "device": ...} line last.

Any failed check raises, and the script exits non-zero without the last
line. Without a CUDA card it exits 2 before doing anything.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from multimodalrouting_tpu_torch.ckpt import save_checkpoint
from multimodalrouting_tpu_torch.configs import load_cfg
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops import hopper
from multimodalrouting_tpu_torch.ops.capsule import capsule_weight_init
from multimodalrouting_tpu_torch.ops.flash_packed import (
    packed_attention,
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_fwd,
    packed_attention_reference,
)
from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused, capsule_routing_reference
from multimodalrouting_tpu_torch.serve import Predictor, batch_from_records, make_http_server
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket, train_model
from multimodalrouting_tpu_torch.train.state import create_train_state
from multimodalrouting_tpu_torch.train.steps import make_train_step

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet (dense): the bound column's peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
# K1 in bf16 is held by two limits, both set by the output itself:
# - max|got - ref| <= 2**-6 * max|ref| (2 to 4 bf16 ulps at the output's
#   largest magnitude): both sides round the output to bf16, so they sit one
#   ulp apart wherever their fp32 values straddle a rounding boundary;
# - rms(got - ref) <= 2 * rms(ref - exact), where exact is the same function
#   with no bf16 rounding of p or of the output: the kernel's online softmax
#   rounds p to bf16 before normalising, the plain version after, two
#   independent roundings of one size, so they differ by ~sqrt(2) times the
#   plain version's own rounding error. A coarser p (6 significant bits
#   instead of 8) or a dropped key tile breaks it (phase 2 checks both).
K1_BF16_MAX_REL = 2.0**-6
K1_BF16_RMS_RATIO = 2.0
K1_FP32_TOL = (2e-5, 2e-5)  # (atol, rtol): the same function summed in another order
# K2 in bf16 is held by K1's two limits, for each of dq, dk and dv. The
# kernel and the plain version round p (for dv) and ds (for dq, dk) to bf16
# at the same place; they differ by fp32 summation order before those
# roundings and the outputs', so rms(got - ref) is well under the plain
# version's own rounding error.
K2_FP32_TOL = (2e-5, 2e-5)
K3_TOL = (1e-5, 1e-5)  # fp32 routing, sums in another order
# End to end, bf16 on the card against fp32 on the CPU through 12 BERT
# layers, the ResNet and the MulT streams: bf16 keeps ~3 significant digits.
E2E_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def device_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_spans(fn, iters: int):
    """(name, microseconds) of every CUDA kernel in a torch.profiler trace of
    `iters` calls of fn, after one untraced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, name_parts, iters: int) -> float:
    """Device time of one call: for each name part, the mean duration of the
    CUDA kernels whose name contains it, summed over the parts; the kernels'
    own time, without the host's launch overhead. Fails if the trace holds
    no kernel of a part."""
    spans = device_spans(fn, iters)
    total = 0.0
    for part in (name_parts,) if isinstance(name_parts, str) else name_parts:
        hits = [us for name, us in spans if part in name]
        require(len(hits) > 0, f"no kernel named *{part}* in the profiler trace")
        total += sum(hits) / len(hits) / 1e3
    return total


def bound(bytes_moved: float, flops: float, kind: str):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    got, ref = got.float(), ref.float()
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - ref).abs()
    excess = (err - (atol + rtol * ref.abs())).max().item()
    max_err = err.max().item()
    log(f"[check] {name}: max_abs_err={max_err:.3e} (atol={atol}, rtol={rtol})")
    require(excess <= 0, f"{name}: outside tolerance by {excess:.3e}")
    return max_err


def bf16_errors(got: torch.Tensor, ref: torch.Tensor, exact: torch.Tensor) -> dict:
    """K1's bf16 error against the plain version `ref`, beside the scales the
    limits use: the output's largest magnitude and the plain version's own
    rounding error against `exact`."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    worst = int(diff.argmax())
    max_err, at = diff.flatten()[worst].item(), abs(ref.flatten()[worst].item())
    ulp = 2.0 ** (math.floor(math.log2(at)) - 7) if at > 0 else 2.0**-133
    return {
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": max_err,
        "max_ref": ref.abs().max().item(),
        "ref_at_worst": at,
        "ulps_at_worst": max_err / ulp,
        "rms_ratio": ((got - ref).norm() / (ref - exact.float()).norm()).item(),
    }


def within_bf16_limits(e: dict) -> bool:
    return e["finite"] and e["max_abs_err"] <= K1_BF16_MAX_REL * e["max_ref"] and e["rms_ratio"] <= K1_BF16_RMS_RATIO


def describe_bf16(e: dict) -> str:
    return (f"max_abs_err={e['max_abs_err']:.3e} = {e['ulps_at_worst']:.1f} bf16 ulp at |ref|={e['ref_at_worst']:.4f} "
            f"(limit 2^-6 * max|ref| = {K1_BF16_MAX_REL * e['max_ref']:.3e}), "
            f"rms_ratio={e['rms_ratio']:.3f} (limit {K1_BF16_RMS_RATIO})")


def check_bf16(name: str, got: torch.Tensor, ref: torch.Tensor, exact: torch.Tensor) -> float:
    e = bf16_errors(got, ref, exact)
    log(f"[check] {name}: {describe_bf16(e)}")
    require(within_bf16_limits(e), f"{name}: outside the bf16 limits")
    return e["max_abs_err"]


def plain_coarse_p(q, k, v, m, heads: int, bits: int) -> torch.Tensor:
    """A planted fault: the plain version of K1 with p rounded to `bits`
    significant bits instead of bf16's 8."""
    n, t, d = q.shape
    q4, k4, v4 = (x.reshape(n, t, heads, d // heads).float() for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4) + ((1.0 - m) * -1e30)[:, None, None, :]
    mant, ex = torch.frexp(torch.softmax(logits, dim=-1))
    p = torch.ldexp(torch.round(mant * 2**bits) / 2**bits, ex)
    return torch.einsum("bhqk,bkhd->bqhd", p, v4).reshape(n, t, d).to(q.dtype)


def k1_inputs(n: int, t: int, heads: int, dh: int, dtype, dev, mask):
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (n, t, heads * dh)
    q = (torch.randn(shape, generator=g, device=dev) * dh**-0.5).to(dtype)
    k = torch.randn(shape, generator=g, device=dev).to(dtype)
    v = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q, k, v, mask[:n].to(dev)


def phase_k1(dev) -> dict:
    # key masks of the flagship serving batch: 16 stays x 8 chunks of 512
    # tokens from the synthetic cohort, padded chunks included
    cohort = make_synthetic_cohort(16, s=8, l=512, image_size=8, seed=SEED)
    mask = torch.from_numpy(cohort.note_attn.reshape(128, 512).astype(np.float32))
    log(f"[k1] mask: {int((mask.sum(1) == 0).sum())} of 128 chunks all-pad")
    with torch.no_grad():
        q, k, v, m = k1_inputs(128, 512, 12, 64, torch.bfloat16, dev, mask)
        out = packed_attention(q, k, v, m, 12)
        torch.cuda.synchronize()
        ref = packed_attention_reference(q, k, v, m, 12)
        exact = packed_attention_reference(q.float(), k.float(), v.float(), m, 12)
        err = check_bf16("K1 bf16 [128,512,768] dh=64", out, ref, exact)
        # the limits must reject a kernel that is wrong by a little or a lot
        dropped = m.clone()
        dropped[:, 64:128] = 0.0
        for fault, bad in (("key tile 64-127 dropped", lambda: packed_attention_reference(q, k, v, dropped, 12)),
                           ("p rounded to 6 bits", lambda: plain_coarse_p(q, k, v, m, 12, bits=6))):
            e = bf16_errors(bad(), ref, exact)
            log(f"[fault] K1 planted fault, {fault}: {describe_bf16(e)}")
            require(not within_bf16_limits(e), f"the bf16 limits accept a planted fault: {fault}")
        del exact, dropped
        ms = kernel_ms(lambda: packed_attention(q, k, v, m, 12), "packed_attention_bf16_kernel", 20)
        # under a gradient the forward also writes each row's log-sum-exp for K2
        ms_lse = kernel_ms(lambda: packed_attention_fwd(q, k, v, m, 12, want_lse=True),
                           "packed_attention_bf16_kernel", 20)
        plain_ms = device_time_ms(lambda: packed_attention_reference(q, k, v, m, 12), 5)
        q4, k4, v4 = (x.unflatten(2, (12, 64)).transpose(1, 2) for x in (q, k, v))
        add_mask = ((1.0 - m) * -1e30).to(torch.bfloat16)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = device_time_ms(lambda: sdpa(q4, k4, v4, attn_mask=add_mask, scale=1.0), 20)
        del ref

        q2, k2, v2, m2 = k1_inputs(16, 512, 12, 64, torch.float32, dev, mask)
        check_close("K1 fp32 [16,512,768] dh=64", packed_attention(q2, k2, v2, m2, 12),
                    packed_attention_reference(q2, k2, v2, m2, 12), *K1_FP32_TOL)
        q2, k2, v2, m2 = k1_inputs(32, 512, 6, 128, torch.bfloat16, dev, mask)
        check_bf16("K1 bf16 [32,512,768] dh=128", packed_attention(q2, k2, v2, m2, 6),
                   packed_attention_reference(q2, k2, v2, m2, 6),
                   packed_attention_reference(q2.float(), k2.float(), v2.float(), m2, 6))
    n, t, d, h, dh = 128, 512, 768, 12, 64
    bound_ms, bound_by = bound(4 * n * t * d * 2 + n * t * 4, 4 * n * h * t * t * dh, "bf16")
    log(f"[k1] kernel_ms={ms:.4f} (with the lse write {ms_lse:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return {
        "name": "packed_attention", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/packed_attention.cu",
        "replaces": "multimodalrouting_tpu/ops/flash_packed.py:58",
        "max_abs_err": err, "ms": ms, "ms_with_lse": ms_lse, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def bwd_with_fault(q, k, v, m, do, heads: int) -> tuple:
    """A planted fault: the plain version of K2 with the rowsum term of ds
    dropped (ds = p * dp)."""
    n, t, d = q.shape
    q4, k4, v4, do4 = (x.reshape(n, t, heads, d // heads).float() for x in (q, k, v, do))
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4) + ((1.0 - m) * -1e30)[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do4)
    ds = (p * torch.einsum("bqhd,bkhd->bhqk", do4, v4)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k4)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q4)
    return tuple(x.reshape(n, t, d).to(q.dtype) for x in (dq, dk, dv))


def k2_inputs(n: int, t: int, heads: int, dh: int, dtype, dev, mask):
    """K1's inputs plus a cotangent that is nonzero on every row, pad
    queries included (the plain VJP is defined there too)."""
    q, k, v, m = k1_inputs(n, t, heads, dh, dtype, dev, mask)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    return q, k, v, m, do


def check_k2(tag: str, q, k, v, m, do, heads: int) -> float:
    """K2 against its plain version: bf16 limits per output (with `exact`,
    the plain version in fp32 with nothing rounded), or fp32 tolerances."""
    _, lse = packed_attention_fwd(q, k, v, m, heads, want_lse=True)
    got = packed_attention_bwd(q, k, v, m, lse, do, heads)
    torch.cuda.synchronize()
    ref = packed_attention_bwd_reference(q, k, v, m, do, heads)
    if q.dtype == torch.float32:
        return max(check_close(f"K2 {tag} {name}", x, y, *K2_FP32_TOL) for name, x, y in zip("dq dk dv".split(), got, ref))
    exact = packed_attention_bwd_reference(q.float(), k.float(), v.float(), m, do.float(), heads)
    return max(check_bf16(f"K2 {tag} {name}", x, y, e) for name, x, y, e in zip("dq dk dv".split(), got, ref, exact))


def phase_k2(dev) -> dict:
    cohort = make_synthetic_cohort(16, s=8, l=512, image_size=8, seed=SEED)
    mask = torch.from_numpy(cohort.note_attn.reshape(128, 512).astype(np.float32))
    log(f"[k2] mask: {int((mask.sum(1) == 0).sum())} of 128 chunks all-pad")
    with torch.no_grad():
        q, k, v, m, do = k2_inputs(128, 512, 12, 64, torch.bfloat16, dev, mask)
        err = check_k2("bf16 [128,512,768] dh=64", q, k, v, m, do, 12)
        ref = packed_attention_bwd_reference(q, k, v, m, do, 12)
        exact = packed_attention_bwd_reference(q.float(), k.float(), v.float(), m, do.float(), 12)
        dropped = m.clone()
        dropped[:, 64:128] = 0.0
        for fault, bad in (("rowsum term dropped", lambda: bwd_with_fault(q, k, v, m, do, 12)),
                           ("key tile 64-127 skipped",
                            lambda: packed_attention_bwd_reference(q, k, v, dropped, do, 12))):
            rejected = []
            for name, x, y, e in zip("dq dk dv".split(), bad(), ref, exact):
                errors = bf16_errors(x, y, e)
                log(f"[fault] K2 planted fault, {fault}, {name}: {describe_bf16(errors)}")
                rejected.append(not within_bf16_limits(errors))
            require(any(rejected), f"the bf16 limits accept a planted K2 fault: {fault}")
        del ref, exact, dropped
        _, lse = packed_attention_fwd(q, k, v, m, 12, want_lse=True)
        ms = kernel_ms(lambda: packed_attention_bwd(q, k, v, m, lse, do, 12),
                       ("bwd_dq_bf16_kernel", "bwd_dkdv_bf16_kernel"), 20)
        plain_ms = device_time_ms(lambda: packed_attention_bwd_reference(q, k, v, m, do, 12), 5)
    # the library's backward: SDPA on the same [N, H, T, dh] view and additive mask
    q4, k4, v4 = (x.unflatten(2, (12, 64)).transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    add_mask = ((1.0 - m) * -1e30).to(torch.bfloat16)[:, None, None, :]
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=add_mask, scale=1.0)
    do4 = do.unflatten(2, (12, 64)).transpose(1, 2)
    spans = device_spans(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True), 20)
    library_ms = sum(us for _, us in spans) / 20 / 1e3
    del q4, k4, v4, out4, do4
    with torch.no_grad():
        q2, k2, v2, m2, do2 = k2_inputs(16, 512, 12, 64, torch.float32, dev, mask)
        check_k2("fp32 [16,512,768] dh=64", q2, k2, v2, m2, do2, 12)
        q2, k2, v2, m2, do2 = k2_inputs(32, 512, 6, 128, torch.bfloat16, dev, mask)
        check_k2("bf16 [32,512,768] dh=128", q2, k2, v2, m2, do2, 6)
    n, t, d, h, dh = 128, 512, 768, 12, 64
    # reads q, k, v, do, the mask and K1's lse once; writes dq, dk, dv once;
    # five T x T x dh products per head
    bound_ms, bound_by = bound(7 * n * t * d * 2 + n * t * 4 + n * h * t * 4, 10 * n * h * t * t * dh, "bf16")
    log(f"[k2] kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "multimodalrouting_tpu/ops/flash_packed.py:140",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def phase_k3_grad(dev) -> None:
    """The K3 autograd Function's gradients (kernel forward, the plain
    program's VJP backward) against autograd through the plain program."""
    b, n, a, m, d = 16, 10, 32, 2, 64
    rng = np.random.default_rng(SEED + 2)
    pose = torch.from_numpy(rng.normal(size=(b, n, a)).astype(np.float32)).to(dev)
    act = torch.from_numpy((rng.random((b, n)) > 0.3).astype(np.float32)).to(dev)
    w = capsule_weight_init(n, a, m, d, torch.Generator().manual_seed(SEED)).to(dev)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev) for s in ((b, m, d), (b, m), (b, n, m))]
    grads = []
    for fn in (capsule_routing_fused, capsule_routing_reference):
        p, ww = pose.clone().requires_grad_(), w.clone().requires_grad_()
        before = capsule_routing_fused.launches
        outs = fn(p, act, ww, 3)
        loss = sum((o * c).sum() for o, c in zip(outs, cot) if o.requires_grad)
        grads.append(torch.autograd.grad(loss, (p, ww)))
        if fn is capsule_routing_fused:
            require(capsule_routing_fused.launches == before + 1, "K3 did not launch under autograd")
    for name, x, y in zip(("pose", "w"), *grads):
        check_close(f"K3 gradient d{name}", x, y, *K3_TOL)


def phase_k3(dev) -> dict:
    b, n, a, m, d = 16, 10, 32, 2, 64
    rng = np.random.default_rng(SEED)
    pose = torch.from_numpy(rng.normal(size=(b, n, a)).astype(np.float32)).to(dev)
    # the head's routing acts are the route mask: some stays miss N or I
    act = torch.from_numpy((rng.random((b, n)) > 0.3).astype(np.float32)).to(dev)
    w = capsule_weight_init(n, a, m, d, torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        got = capsule_routing_fused(pose, act, w, 3)
        torch.cuda.synchronize()
        ref = capsule_routing_reference(pose, act, w, 3)
        err = max(check_close(f"K3 {name}", x, y, *K3_TOL) for name, x, y in zip(("pose", "act", "coef"), got, ref))
        ms = kernel_ms(lambda: capsule_routing_fused(pose, act, w, 3), "capsule_routing_kernel", 50)
        plain_ms = device_time_ms(lambda: capsule_routing_reference(pose, act, w, 3), 50)
    iters = 3
    flops = 2 * b * n * a * m * d + iters * (2 * b * n * m * d * 2)
    bytes_moved = 4 * (b * n * a + b * n + n * a * m * d + b * m * d + b * m + b * n * m)
    bound_ms, bound_by = bound(bytes_moved, flops, "fp32")
    log(f"[k3] kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by})")
    return {
        "name": "capsule_routing", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/capsule_routing.cu",
        "replaces": "multimodalrouting_tpu/ops/pallas_capsule.py:41",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }


def flagship_checkpoint(ckpt_dir: str):
    """Full-width flagship config at the real serving shapes (a real-cohort
    checkpoint: synthetic off, data_root set — never read), seeded random
    weights, nonzero BatchNorm running statistics and head embedding."""
    cfg = flagship_cfg()
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
        head = model.capsule_head
        head.embedding.copy_(torch.randn(head.embedding.shape, generator=g))
        head.bias.copy_(0.1 * torch.randn(head.bias.shape, generator=g))
    save_checkpoint(ckpt_dir, model.state_dict(), cfg, temperature=1.25, thresholds=[0.4])
    return cfg


def records_from_cohort(cohort, n: int, drop_image=()):
    recs = []
    for i in range(n):
        rec = {
            "x_struct": cohort.x_struct[i], "m_struct": cohort.m_struct[i],
            "note_ids": cohort.note_ids[i], "note_attn": cohort.note_attn[i],
            "chunk_mask": cohort.chunk_mask[i],
        }
        if i not in drop_image:
            rec["image"] = cohort.image[i]
        recs.append(rec)
    return recs


def check_rows(name: str, rows, n: int) -> None:
    require(len(rows) == n, f"{name}: {len(rows)} rows for {n} records")
    for row in rows:
        p = np.asarray(row["probs"], np.float64)
        require(bool(np.isfinite(p).all() and ((0 <= p) & (p <= 1)).all()), f"{name}: bad probs {p}")
        require(len(row["alpha"]) == 10 and len(row["top_routes"]) == 3, f"{name}: bad route audit")


def http_roundtrip(predictor, records) -> dict:
    server = make_http_server(predictor, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        to_json = [{k: np.asarray(v).tolist() for k, v in r.items()} for r in records]
        req = urllib.request.Request(
            f"{base}/predict", data=json.dumps({"records": to_json}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            payload = json.loads(resp.read())
        with urllib.request.urlopen(f"{base}/health", timeout=60) as resp:
            health = json.loads(resp.read())
        require(health["ok"] and len(health["routes"]) == 10, f"bad /health: {health}")
        return payload
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)


def profile_forward(predictor, batch, top: int = 15) -> None:
    """Where one serving forward's device time goes: kernel time by name from
    a torch.profiler trace, the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predictor.predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, total = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, total + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(total for _, total in by_name.values())
    log(f"[profile] batch-{batch.batch_size} forward: wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
        f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} kernels={sum(n for n, _ in by_name.values())}")
    for name, (n, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile] {total:9.3f} ms {100 * total / busy_ms:5.1f}% x{n:<5d} {name[:110]}")


def phase_serving(dev, tmp: str) -> dict:
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "flagship")
    cfg = flagship_checkpoint(ckpt)
    e = cfg.encoder
    log(f"[serve] checkpoint written in {time.perf_counter() - t0:.1f}s "
        f"(BERT {e.bert_layers}x{e.bert_hidden}, L={e.text_max_len}, S={e.notes_max_chunks}, "
        f"{e.vision_backbone} {e.image_size}^2, dtype={cfg.model.dtype})")
    predictor = Predictor(ckpt, device="cuda")
    cohort = make_synthetic_cohort(
        32, t=e.structured_seq_len, f=e.structured_n_feats, s=e.notes_max_chunks, l=e.text_max_len,
        image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=SEED + 1,
    )
    records = records_from_cohort(cohort, 16, drop_image=(1,))
    predictor.predict_records(records[:2])  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    reset_counts()
    single = predictor.predict_records(records[:1])
    batch = predictor.predict_records(records)
    no_image = predictor.predict_records(records[1:2])
    http = http_roundtrip(predictor, records[:2])["predictions"]
    torch.cuda.synchronize()
    launches = read_counts()
    forwards = 4
    log(f"[serve] launches over {forwards} forwards: {launches}")
    require(launches["packed_attention"] == e.bert_layers * forwards,
            f"K1 launched {launches['packed_attention']} times, expected {e.bert_layers * forwards}")
    require(launches["capsule_routing"] == forwards,
            f"K3 launched {launches['capsule_routing']} times, expected {forwards}")
    require(launches["packed_attention_bwd"] == 0, "serving launched the backward kernel")
    check_rows("single", single, 1)
    check_rows("batch16", batch, 16)
    check_rows("no-image", no_image, 1)
    check_rows("http", http, 2)
    require(batch[1]["alpha"]["I"] == 0.0, "a stay without an image must have alpha_I = 0")
    out16 = predictor.predict(batch_from_records(cfg, records))
    require(out16["alpha"].shape == (16, 10) and out16["r_matrix"].shape == (16, 10, 2), "bad output shapes")

    # reference: the same checkpoint in fp32 on the CPU, two records
    ref_dir = os.path.join(tmp, "flagship_fp32")
    os.makedirs(ref_dir)
    for name in ("weights.pt", "meta.json"):
        os.link(os.path.join(ckpt, name), os.path.join(ref_dir, name))
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg_dict = json.load(f)
    cfg_dict["model"]["dtype"] = "float32"
    with open(os.path.join(ref_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f)
    t1 = time.perf_counter()
    ref_rows = Predictor(ref_dir, device="cpu").predict_records(records[:2])
    for got, ref in zip(batch[:2], ref_rows):
        dp = abs(float(np.asarray(got["probs"]).reshape(-1)[0]) - float(np.asarray(ref["probs"]).reshape(-1)[0]))
        da = max(abs(got["alpha"][r] - ref["alpha"][r]) for r in ref["alpha"])
        log(f"[serve] card bf16 vs CPU fp32: |dprob|={dp:.3e} max|dalpha|={da:.3e} (tol {E2E_TOL})")
        require(dp <= E2E_TOL and da <= E2E_TOL, "serving output disagrees with the fp32 CPU reference")
    log(f"[serve] CPU fp32 reference in {time.perf_counter() - t1:.1f}s")

    lat = []
    for i in range(20):
        t = time.perf_counter()
        predictor.predict_records(records[i % 16 : i % 16 + 1])
        lat.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    reps = 5
    for _ in range(reps):
        predictor.predict_records(records)
    stays_per_s = 16 * reps / (time.perf_counter() - t)
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    log(f"[serve] single-record p50_ms={p50:.2f} p95_ms={p95:.2f}; batch-16 stays_per_s={stays_per_s:.2f}")
    profile_forward(predictor, batch_from_records(cfg, records))
    profile_forward(predictor, batch_from_records(cfg, records[:1]), top=8)
    return launches


def flagship_cfg(**overrides):
    """configs/trimodal_mort.yaml on the defaults, as a real-cohort run (so a
    checkpoint serves the full L=512 and 224^2 shapes; data_root is never
    read)."""
    return load_cfg(
        os.path.join(ROOT, "configs", "trimodal_mort.yaml"),
        overrides={"data.synthetic": False, "data.data_root": "real-cohort", **overrides},
        environ={},
    )


def full_width_cohort(cfg, n: int, seed: int):
    e = cfg.encoder
    return make_synthetic_cohort(
        n, t=e.structured_seq_len, f=e.structured_n_feats, s=e.notes_max_chunks, l=e.text_max_len,
        image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=seed,
    )


def reset_counts() -> None:
    packed_attention.launches = packed_attention_bwd.launches = capsule_routing_fused.launches = 0


def read_counts() -> dict:
    return {"packed_attention": packed_attention.launches, "packed_attention_bwd": packed_attention_bwd.launches,
            "capsule_routing": capsule_routing_fused.launches}


def profile_step(fn, label: str, top: int = 15) -> None:
    """One call's device time by kernel name and the device's idle share of
    its wall time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, total = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, total + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(total for _, total in by_name.values())
    log(f"[profile] {label}: wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
        f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} kernels={sum(n for n, _ in by_name.values())}")
    for name, (n, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile] {total:9.3f} ms {100 * total / busy_ms:5.1f}% x{n:<5d} {name[:110]}")


def phase_train_finetune(dev, warmup: int = 2, steps: int = 5) -> dict:
    """The flagship train step with fine-tuned notes at full width, batch 16,
    note packing on, lr_head = lr_enc = train.lr (bench.py's fine-tuned
    leg): K1 forward and K2 backward in every BERT layer, K3 under autograd."""
    cfg = flagship_cfg(**{"encoder.finetune_text": True})
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED)
    cap = note_pack_bucket(cfg, cohort)
    batch = batch_to(cohort, dev)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    lr = cfg.train.lr
    watched = ("encoders.bbert.bert.layer_0.intermediate.weight", "encoders.imgenc.backbone.conv1.weight")
    named = dict(model.named_parameters())
    before = {n: named[n].detach().clone() for n in watched}
    ema_before = {n: state.ema[n].clone() for n in watched}
    log(f"[train] fine-tuned: {sum(p.numel() for p in state.params()) / 1e6:.1f}M trainable parameters, "
        f"note_pack={cap} of {cohort.chunk_mask.size} chunks ({int(cohort.chunk_mask.sum())} valid)")
    for _ in range(warmup):
        step(state, batch, gen, lr, lr, note_pack=cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen, lr, lr, note_pack=cap) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m.loss) for m in metrics]
    log(f"[train] fine-tuned launches over {steps} steps: {launches}")
    log(f"[train] fine-tuned losses {['%.5f' % x for x in losses]}, step_ms={wall / steps * 1e3:.1f}, "
        f"stays_per_s={cfg.train.batch_size * steps / wall:.2f}, peak_memory_gb={peak_gb:.2f}")
    require(all(np.isfinite(losses)) and all(m.grad_finite for m in metrics), "non-finite loss or gradient")
    expect = {"packed_attention": 12 * steps, "packed_attention_bwd": 12 * steps, "capsule_routing": steps}
    require(launches == expect, f"launches {launches}, expected {expect}")
    for n in watched:
        moved = (named[n].detach() - before[n]).abs().max().item()
        ema_moved = (state.ema[n] - ema_before[n]).abs().max().item()
        log(f"[train] {n}: max|param change|={moved:.3e}, max|EMA change|={ema_moved:.3e}")
        require(moved > 0 and ema_moved > 0, f"{n} or its EMA did not move")
    profile_step(lambda: step(state, batch, gen, lr, lr, note_pack=cap), "one fine-tuned training step")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


def phase_train_frozen(dev) -> dict:
    """One step under the frozen-text default: K1 runs without a gradient,
    K2 never, K3 under autograd."""
    cfg = flagship_cfg()
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    batch = batch_to(cohort, dev)
    reset_counts()
    m = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=note_pack_bucket(cfg, cohort))
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[train] frozen default: loss={float(m.loss):.5f} launches {launches}")
    require(np.isfinite(float(m.loss)) and m.grad_finite, "frozen step: non-finite loss or gradient")
    expect = {"packed_attention": 12, "packed_attention_bwd": 0, "capsule_routing": 1}
    require(launches == expect, f"frozen step launches {launches}, expected {expect}")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


def phase_entry_point(dev, tmp: str) -> None:
    """train_model over a small full-width cohort writes a checkpoint that
    Predictor(device="cuda") loads and serves."""
    cfg = flagship_cfg(**{"encoder.finetune_text": True, "train.epochs": 1, "train.min_epochs": 0})
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    out = os.path.join(tmp, "trained")
    t0 = time.perf_counter()
    result = train_model(cfg, model, full_width_cohort(cfg, 32, SEED + 3), full_width_cohort(cfg, 16, SEED + 4),
                         log_fn=log, ckpt_dir=out)
    log(f"[entry] train_model: {len(result.history)} epoch in {time.perf_counter() - t0:.1f}s, "
        f"history={result.history}, temperature={result.temperature:.3f}, thresholds={result.thresholds}")
    require(len(result.history) == 1 and np.isfinite(result.history[0]["train_loss"]), "bad train_model history")
    del model, result
    torch.cuda.empty_cache()
    predictor = Predictor(os.path.join(out, "final"), device="cuda")
    rows = predictor.predict_records(records_from_cohort(full_width_cohort(cfg, 1, SEED + 5), 1))
    check_rows("trained checkpoint", rows, 1)
    log(f"[entry] served one record from the trained checkpoint: {rows[0]}")
    del predictor
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} ({smi})")

    secs = hopper.build()
    log(f"[build] kernels built in {secs:.1f}s into {hopper.BUILD_DIR}")
    for name in hopper.SOURCES:
        for line in hopper.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    kernels = [phase_k1(dev), phase_k2(dev), phase_k3(dev)]
    phase_k3_grad(dev)
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_path["serving"] = phase_serving(dev, tmp)
        by_path["train_finetune"] = phase_train_finetune(dev)
        by_path["train_frozen"] = phase_train_frozen(dev)
        phase_entry_point(dev, tmp)
    for k in kernels:  # this slice's main path: the fine-tuned training steps
        k["launches"] = by_path["train_finetune"][k["name"]]
        k["launches_by_path"] = {path: counts.get(k["name"], 0) for path, counts in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
