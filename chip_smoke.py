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
3. holds K2 (the packed attention's backward: the di kernel, then the dq
   and dk/dv kernels) against its plain version at the same shapes, with a
   cotangent on every row, requires a repeat launch to give the same bits,
   holds the di kernel alone against its plain version, and shows that the
   bf16 limits reject two planted faults;
4. holds K3 (fused capsule routing) against its plain version at
   [16, 10, 32] x [10, 32, 2, 64], and its autograd gradients against
   autograd through the plain program;
5. holds K4 (segment attention, the kernel pair of K4a flash and K4b
   splash), forward and backward, against its plain versions on every row at
   the flagship shape, at head_dim 128, at T = 1024 with 3 heads and in
   fp32 (a repeat backward giving the same bits), shows that the bf16 limits
   reject two planted faults (K1's key-mask semantics, a dropped key tile),
   and times it beside SDPA with the boolean segment mask;
6. writes a full-width flagship checkpoint (BERT-base 12 x 768 over 8 x 512
   note chunks, ResNet34 on 224^2, MulT d=256, 10-route capsule head, bf16)
   with seeded random weights, loads it with Predictor(device="cuda") and
   serves one record, a batch of 16, a record without an image and one HTTP
   request, with the kernels' launch counters read around exactly that run;
   the same weights scored in fp32 on the CPU are the reference;
7. trains the full-width flagship with fine-tuned notes (batch 16, note
   packing on): 2 warm-up and 5 timed steps with the launch counters read
   around the timed ones, then one step's profile; one step under the
   frozen-text default;
8. serves the same weights from a train.pipeline_parallel=true config (the
   layers converted to the stacked pp_layers layout on load) at 1 and 16
   records through K4a, against the layered Predictor, and takes two
   fine-tuned steps on that layout (K4a forward and backward);
9. under MMR_ATTN=splash, 2 + 5 fine-tuned steps through K4b forward and
   backward, and one serving forward through K4b against the default one;
10. train_model over 32 + 16 stays for one epoch, whose checkpoint
   Predictor(device="cuda") serves;
11. prints a {"kernels": [...]} line (each kernel with its launches on its
   own path and on every path), the card's name and power limit, and the
   {"ok": true, "device": ...} line last.

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
from multimodalrouting_tpu_torch.ops import flash
from multimodalrouting_tpu_torch.ops.capsule import capsule_weight_init
from multimodalrouting_tpu_torch.ops.flash import (
    flash_self_attention,
    segment_attention_bwd,
    segment_attention_bwd_reference,
    segment_attention_fwd,
    segment_attention_reference,
    splash_self_attention,
)
from multimodalrouting_tpu_torch.ops.flash_packed import (
    attention_bwd_di,
    attention_bwd_di_reference,
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
# kernel and the plain version round p (for dv) and ds (for dk) to bf16 at
# the same place; they differ by fp32 summation order before those roundings
# and the outputs'. For dq the kernel rounds ds = p (dp - di) with di from
# the bf16 output and then moves dq to the plain version's rowsum(dp p):
# where the two differ by a part of an ulp of ds, the roundings fall apart,
# up to two independent roundings of one size (~sqrt(2) of the plain
# version's own error).
K2_FP32_TOL = (2e-5, 2e-5)
# K4 (segment attention, forward and backward) in bf16 is held by K1's two
# limits on every row and each output: like K1 the kernel rounds p relative
# to the running maximum of 64-key tiles, the plain version (the upstream
# order) normalised at T <= 512 or per 512-key block beyond; the backward
# rounds p and ds where the plain version does.
K4_FP32_TOL = (2e-5, 2e-5)
# di = rowsum(o * do) in fp32: the kernel and the plain version sum the same
# products in another order.
DI_TOL = (2e-5, 2e-5)
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


# The attention backward's kernels (K2 and K4 alike), in launch order.
BWD_KERNELS = {"di": "bwd_di_kernel", "dq": "bwd_dq_wgmma_kernel", "dkdv": "bwd_dkdv_wgmma_kernel"}


def bwd_ms(fn, iters: int = 20) -> tuple:
    """Device time of one backward call: every CUDA kernel in a profiler
    trace of `iters` calls, summed and divided by `iters`, with its split
    into BWD_KERNELS. Fails if a kernel of the backward is missing or another
    kernel ran. -> (ms, {part: ms})."""
    spans = device_spans(fn, iters)
    split = {part: sum(us for name, us in spans if key in name) / iters / 1e3 for part, key in BWD_KERNELS.items()}
    require(all(ms > 0 for ms in split.values()), f"a backward kernel is missing from the trace: {split}")
    others = sorted({name for name, _ in spans if not any(key in name for key in BWD_KERNELS.values())})
    require(not others, f"the backward launched other kernels: {others}")
    return sum(us for _, us in spans) / iters / 1e3, split


def describe_split(split: dict) -> str:
    return " + ".join(f"{part} {ms:.4f}" for part, ms in split.items())


def require_repeatable(tag: str, first, again) -> None:
    """The split backward writes each output from one block, in one order:
    a second launch on the same inputs must give the same bits."""
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            f"{tag}: a second backward launch on the same inputs gave other bits")


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
        ms = kernel_ms(lambda: packed_attention(q, k, v, m, 12), "attention_fwd_bf16_kernel", 20)
        # under a gradient the forward also writes each row's log-sum-exp for K2
        ms_lse = kernel_ms(lambda: packed_attention_fwd(q, k, v, m, 12, want_lse=True),
                           "attention_fwd_bf16_kernel", 20)
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
    the plain version in fp32 with nothing rounded), or fp32 tolerances; a
    second launch must give the same bits."""
    out, lse = packed_attention_fwd(q, k, v, m, heads, want_lse=True)
    got = packed_attention_bwd(q, k, v, m, out, lse, do, heads)
    require_repeatable(f"K2 {tag}", got, packed_attention_bwd(q, k, v, m, out, lse, do, heads))
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
        out, lse = packed_attention_fwd(q, k, v, m, 12, want_lse=True)
        check_close("di bf16 [128,512,768] dh=64", attention_bwd_di(heads4(out, 12), heads4(do, 12)),
                    attention_bwd_di_reference(heads4(out, 12), heads4(do, 12)), *DI_TOL)
        ms, split = bwd_ms(lambda: packed_attention_bwd(q, k, v, m, out, lse, do, 12))
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
    # reads q, k, v, K1's output o, do, the mask and K1's lse once; writes
    # dq, dk, dv once; five T x T x dh products per head
    bound_ms, bound_by = bound(8 * n * t * d * 2 + n * t * 4 + n * h * t * 4, 10 * n * h * t * t * dh, "bf16")
    log(f"[k2] kernel_ms={ms:.4f} ({describe_split(split)}) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "multimodalrouting_tpu/ops/flash_packed.py:140",
        "max_abs_err": err, "ms": ms, "split_ms": split, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def heads4(x: torch.Tensor, heads: int) -> torch.Tensor:
    """The [N, T, H, dh] view of a packed [N, T, H*dh] tensor, as the model
    hands it to K4."""
    return x.unflatten(2, (heads, x.shape[2] // heads))


def segment_dropped_tile(q4, k4, v4, m, out=None, do4=None):
    """A planted fault: plain segment attention with keys 64-127 dropped
    from every row; with `do4`, its backward (dq, dk, dv) from `out`."""
    dt = q4.dtype
    s = flash.segment_logits(q4, k4, m)
    s[..., 64:128] = flash.MASK_VALUE
    p = torch.softmax(s, dim=-1)
    if do4 is None:
        return torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v4.float()).to(dt)
    dof = do4.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v4.float())
    ds = ((dp - (out.float() * dof).sum(-1).transpose(1, 2)[..., None]) * p).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k4.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q4.float())
    return tuple(x.to(dt) for x in (dq, dk, dv))


def check_k4(tag: str, q, k, v, m, do, heads: int) -> tuple:
    """K4 forward and backward against the plain versions on every row:
    bf16 limits per output (`exact`: the plain versions in fp32 with nothing
    rounded), or fp32 tolerances. The serving forward (no lse) must equal the
    training one, and a second backward launch must give the same bits.
    -> (forward error, backward error)."""
    q4, k4, v4, do4 = (heads4(x, heads) for x in (q, k, v, do))
    out, lse = segment_attention_fwd(q4, k4, v4, m, True, flash_self_attention)
    grads = segment_attention_bwd(q4, k4, v4, m, out, lse, do4, flash_self_attention)
    require_repeatable(f"K4 {tag}", grads, segment_attention_bwd(q4, k4, v4, m, out, lse, do4, flash_self_attention))
    serving = flash_self_attention(q4, k4, v4, m)
    torch.cuda.synchronize()
    require(torch.equal(serving, out), f"K4 {tag}: the serving forward differs from the training one")
    ref = segment_attention_reference(q4, k4, v4, m)
    ref_grads = segment_attention_bwd_reference(q4, k4, v4, m, out, do4)
    names = ("dq", "dk", "dv")
    if q.dtype == torch.float32:
        fwd = check_close(f"K4 {tag} out", out, ref, *K4_FP32_TOL)
        bwd = max(check_close(f"K4 {tag} {n}", x, y, *K4_FP32_TOL) for n, x, y in zip(names, grads, ref_grads))
        return fwd, bwd
    qf, kf, vf = q4.float(), k4.float(), v4.float()
    exact = segment_attention_reference(qf, kf, vf, m)
    fwd = check_bf16(f"K4 {tag} out", out, ref, exact)
    exact_grads = segment_attention_bwd_reference(qf, kf, vf, m, exact, do4.float())
    bwd = max(check_bf16(f"K4 {tag} {n}", x, y, e) for n, x, y, e in zip(names, grads, ref_grads, exact_grads))
    return fwd, bwd


def phase_k4(dev) -> list:
    """K4 (segment attention: K4a flash and K4b splash share the kernel
    pair) at the flagship shape with the serving batch's masks, at head_dim
    128, at T = 1024 with 3 heads and in fp32; two planted faults; times."""
    cohort = make_synthetic_cohort(16, s=8, l=512, image_size=8, seed=SEED)
    mask = torch.from_numpy(cohort.note_attn.reshape(128, 512).astype(np.float32))
    long_mask = torch.from_numpy(make_synthetic_cohort(8, s=2, l=1024, image_size=8, seed=SEED + 7)
                                 .note_attn.reshape(16, 1024).astype(np.float32))
    log(f"[k4] mask: {int((mask.sum(1) == 0).sum())} of 128 chunks all-pad; T=1024 mask: "
        f"{int((long_mask.sum(1) == 0).sum())} of 16 all-pad")
    n, t, h, dh = 128, 512, 12, 64
    with torch.no_grad():
        q, k, v, m, do = k2_inputs(n, t, h, dh, torch.bfloat16, dev, mask)
        fwd_err, bwd_err = check_k4("bf16 [128,512,768] dh=64", q, k, v, m, do, h)
        q4, k4, v4, do4 = (heads4(x, h) for x in (q, k, v, do))
        ref = segment_attention_reference(q4, k4, v4, m)
        exact = segment_attention_reference(q4.float(), k4.float(), v4.float(), m)
        out, lse = segment_attention_fwd(q4, k4, v4, m, True, flash_self_attention)
        ref_grads = segment_attention_bwd_reference(q4, k4, v4, m, out, do4)
        exact_grads = segment_attention_bwd_reference(q4.float(), k4.float(), v4.float(), m, exact, do4.float())
        key_mask_grads = [heads4(x, h) for x in packed_attention_bwd_reference(q, k, v, m, do, h)]
        faults = (
            ("K1's key mask for segment ids", heads4(packed_attention_reference(q, k, v, m, h), h), key_mask_grads),
            ("key tile 64-127 dropped", segment_dropped_tile(q4, k4, v4, m),
             segment_dropped_tile(q4, k4, v4, m, out, do4)),
        )
        for fault, bad, bad_grads in faults:
            e = bf16_errors(bad, ref, exact)
            log(f"[fault] K4 planted fault, {fault}, out: {describe_bf16(e)}")
            rejected = [not within_bf16_limits(e)]
            for name, x, y, ex in zip(("dq", "dk", "dv"), bad_grads, ref_grads, exact_grads):
                e = bf16_errors(x, y, ex)
                log(f"[fault] K4 planted fault, {fault}, {name}: {describe_bf16(e)}")
                rejected.append(not within_bf16_limits(e))
            require(rejected[0] and any(rejected[1:]), f"the bf16 limits accept a planted K4 fault: {fault}")
        del ref, exact, ref_grads, exact_grads, key_mask_grads, faults, bad, bad_grads
        fwd_ms = {w.__name__: kernel_ms(lambda: w(q4, k4, v4, m), "attention_fwd_bf16_kernel", 20)
                  for w in (flash_self_attention, splash_self_attention)}
        ms_lse = kernel_ms(lambda: segment_attention_fwd(q4, k4, v4, m, True, flash_self_attention),
                           "attention_fwd_bf16_kernel", 20)
        bwd = {w.__name__: bwd_ms(lambda: segment_attention_bwd(q4, k4, v4, m, out, lse, do4, w))
               for w in (flash_self_attention, splash_self_attention)}
        plain_ms = device_time_ms(lambda: segment_attention_reference(q4, k4, v4, m), 5)
        plain_bwd_ms = device_time_ms(lambda: segment_attention_bwd_reference(q4, k4, v4, m, out, do4), 3)
        # the library: SDPA on the [N, H, T, dh] view with the boolean segment mask [N, 1, T, T]
        same = (m[:, None, :, None] == m[:, None, None, :])
        qh, kh, vh = (x.transpose(1, 2) for x in (q4, k4, v4))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = device_time_ms(lambda: sdpa(qh, kh, vh, attn_mask=same, scale=1.0), 20)
    qh, kh, vh = (x.detach().requires_grad_() for x in (qh, kh, vh))
    out_h = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=same, scale=1.0)
    spans = device_spans(lambda: torch.autograd.grad(out_h, (qh, kh, vh), do4.transpose(1, 2), retain_graph=True), 20)
    library_bwd_ms = sum(us for _, us in spans) / 20 / 1e3
    del qh, kh, vh, out_h, same, q, k, v, q4, k4, v4, do4, out, lse
    torch.cuda.empty_cache()
    with torch.no_grad():
        check_k4("bf16 [32,512,768] dh=128", *k2_inputs(32, 512, 6, 128, torch.bfloat16, dev, mask), 6)
        check_k4("bf16 [16,1024,192] 3 heads dh=64", *k2_inputs(16, 1024, 3, 64, torch.bfloat16, dev, long_mask), 3)
        check_k4("fp32 [16,512,768] dh=64", *k2_inputs(16, 512, 12, 64, torch.float32, dev, mask), 12)
        check_k4("fp32 [8,1024,256] dh=128", *k2_inputs(8, 1024, 2, 128, torch.float32, dev, long_mask), 2)
    d = h * dh
    bound_ms, bound_by = bound(4 * n * t * d * 2 + n * t * 4, 4 * n * h * t * t * dh, "bf16")
    # the backward reads q, k, v, o, do, the mask and lse once, writes dq,
    # dk, dv once; five T x T x dh products per head
    bwd_bound_ms, bwd_bound_by = bound(8 * n * t * d * 2 + n * t * 4 + n * h * t * 4,
                                       10 * n * h * t * t * dh, "bf16")
    log(f"[k4] forward kernel_ms={fwd_ms} (with the lse write {ms_lse:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    for w, (ms, split) in bwd.items():
        log(f"[k4] {w} backward kernel_ms={ms:.4f} ({describe_split(split)}) plain_ms={plain_bwd_ms:.4f} "
            f"library_ms={library_bwd_ms:.4f} bound_ms={bwd_bound_ms:.4f} ({bwd_bound_by})")
    rows = []
    for name, wrapper, replaces in (("flash_attention", flash_self_attention, "multimodalrouting_tpu/ops/flash.py:100"),
                                    ("splash_attention", splash_self_attention, "multimodalrouting_tpu/ops/flash.py:48")):
        rows.append({
            "name": name, "route": "cuda", "source": "multimodalrouting_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "max_abs_err": fwd_err, "ms": fwd_ms[wrapper.__name__], "ms_with_lse": ms_lse,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
        rows.append({
            "name": f"{name}_bwd", "route": "cuda", "source": "multimodalrouting_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "max_abs_err": bwd_err, "ms": bwd[wrapper.__name__][0],
            "split_ms": bwd[wrapper.__name__][1], "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
            "library_ms": library_bwd_ms,
        })
    return rows


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
    records = serving_records(cfg)
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
    require(launches == expected(packed_attention=e.bert_layers * forwards, capsule_routing=forwards),
            f"serving launches {launches}: the backward or K4 ran")
    check_rows("single", single, 1)
    check_rows("batch16", batch, 16)
    check_rows("no-image", no_image, 1)
    check_rows("http", http, 2)
    require(batch[1]["alpha"]["I"] == 0.0, "a stay without an image must have alpha_I = 0")
    out16 = predictor.predict(batch_from_records(cfg, records))
    require(out16["alpha"].shape == (16, 10) and out16["r_matrix"].shape == (16, 10, 2), "bad output shapes")

    # reference: the same checkpoint in fp32 on the CPU, two records
    ref_dir = checkpoint_variant(ckpt, os.path.join(tmp, "flagship_fp32"), "model", "dtype", "float32")
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


COUNTED = {
    "packed_attention": (packed_attention, "launches"),
    "packed_attention_bwd": (packed_attention_bwd, "launches"),
    "flash_attention": (flash_self_attention, "launches"),
    "flash_attention_bwd": (flash_self_attention, "bwd_launches"),
    "splash_attention": (splash_self_attention, "launches"),
    "splash_attention_bwd": (splash_self_attention, "bwd_launches"),
    "capsule_routing": (capsule_routing_fused, "launches"),
}


MAIN_PATH = {
    "packed_attention": "train_finetune", "packed_attention_bwd": "train_finetune",
    "capsule_routing": "train_finetune", "flash_attention": "serving_pp",
    "flash_attention_bwd": "train_pp_finetune", "splash_attention": "train_splash",
    "splash_attention_bwd": "train_splash",
}


def reset_counts() -> None:
    for fn, attr in COUNTED.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTED.items()}


def expected(**per_run) -> dict:
    """Every kernel's expected count: the given ones, 0 for the rest."""
    return {name: per_run.get(name, 0) for name in COUNTED}


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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for rank, (name, (n, total)) in enumerate(ranked):
        if rank < top or "attn::" in name:  # the top rows and every attention kernel
            log(f"[profile] {total:9.3f} ms {100 * total / busy_ms:5.1f}% x{n:<5d} {name[:110]}")


def phase_train_finetune(dev, warmup: int = 2, steps: int = 5, label: str = "fine-tuned", per_step=None,
                         layer_key: str = "layer_0.intermediate.weight", profile: bool = True, **overrides) -> dict:
    """The flagship train step with fine-tuned notes at full width, batch 16,
    note packing on, lr_head = lr_enc = train.lr (bench.py's fine-tuned
    leg): by default K1 forward and K2 backward in every BERT layer, K3 under
    autograd; `overrides` change the config and `per_step` the launches
    expected in each step."""
    cfg = flagship_cfg(**{"encoder.finetune_text": True, **overrides})
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED)
    cap = note_pack_bucket(cfg, cohort)
    batch = batch_to(cohort, dev)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    lr = cfg.train.lr
    watched = (f"encoders.bbert.bert.{layer_key}", "encoders.imgenc.backbone.conv1.weight")
    named = dict(model.named_parameters())
    before = {n: named[n].detach().clone() for n in watched}
    ema_before = {n: state.ema[n].clone() for n in watched}
    log(f"[train] {label}: {sum(p.numel() for p in state.params()) / 1e6:.1f}M trainable parameters, "
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
    log(f"[train] {label} launches over {steps} steps: {launches}")
    log(f"[train] {label} losses {['%.5f' % x for x in losses]}, step_ms={wall / steps * 1e3:.1f}, "
        f"stays_per_s={cfg.train.batch_size * steps / wall:.2f}, peak_memory_gb={peak_gb:.2f}")
    require(all(np.isfinite(losses)) and all(m.grad_finite for m in metrics), "non-finite loss or gradient")
    per_step = per_step or {"packed_attention": 12, "packed_attention_bwd": 12, "capsule_routing": 1}
    expect = expected(**{name: count * steps for name, count in per_step.items()})
    require(launches == expect, f"launches {launches}, expected {expect}")
    for n in watched:
        moved = (named[n].detach() - before[n]).abs().max().item()
        ema_moved = (state.ema[n] - ema_before[n]).abs().max().item()
        log(f"[train] {n}: max|param change|={moved:.3e}, max|EMA change|={ema_moved:.3e}")
        require(moved > 0 and ema_moved > 0, f"{n} or its EMA did not move")
    if profile:
        profile_step(lambda: step(state, batch, gen, lr, lr, note_pack=cap), f"one {label} training step")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


def checkpoint_variant(src: str, dst: str, section: str, key: str, value) -> str:
    """The checkpoint `src` under one other config value: its weights and
    meta hard-linked into `dst`, config.json with cfg[section][key] = value."""
    os.makedirs(dst)
    for name in ("weights.pt", "meta.json"):
        os.link(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "config.json")) as f:
        cfg_dict = json.load(f)
    cfg_dict[section][key] = value
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg_dict, f)
    return dst


def serving_records(cfg):
    e = cfg.encoder
    cohort = make_synthetic_cohort(
        32, t=e.structured_seq_len, f=e.structured_n_feats, s=e.notes_max_chunks, l=e.text_max_len,
        image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=SEED + 1,
    )
    return records_from_cohort(cohort, 16, drop_image=(1,))


def check_agree(label: str, got, ref) -> None:
    """Served rows against reference rows of the same records: |dprob| and
    max |dalpha| within E2E_TOL."""
    dp = max(abs(float(np.asarray(g["probs"]).reshape(-1)[0]) - float(np.asarray(r["probs"]).reshape(-1)[0]))
             for g, r in zip(got, ref))
    da = max(abs(g["alpha"][k] - r["alpha"][k]) for g, r in zip(got, ref) for k in r["alpha"])
    log(f"[serve] {label}: max|dprob|={dp:.3e} max|dalpha|={da:.3e} over {len(ref)} records (tol {E2E_TOL})")
    require(dp <= E2E_TOL and da <= E2E_TOL, f"{label}: outputs disagree")


def phase_serving_pp(dev, tmp: str) -> dict:
    """A pipeline-layout flagship checkpoint served by Predictor(device="cuda")
    at 1 and 16 records: phase_serving's weights file under a config with
    train.pipeline_parallel=true, the layers converted to the pp_layers
    layout on load; K4a in every BERT layer, no K1. The same weights served
    from the layered checkpoint are the reference."""
    layered = os.path.join(tmp, "flagship")
    pp_dir = checkpoint_variant(layered, os.path.join(tmp, "flagship_pp"), "train", "pipeline_parallel", True)
    predictor = Predictor(pp_dir, device="cuda")
    keys = predictor.model.state_dict()
    require("encoders.bbert.bert.pp_layers.q_kernel" in keys and not any(".layer_0." in k for k in keys
                                                                        if k.startswith("encoders.bbert.")),
            "the pipeline-layout config did not build the pp_layers layout")
    records = serving_records(predictor.cfg)
    predictor.predict_records(records[:2])
    torch.cuda.synchronize()
    reset_counts()
    single = predictor.predict_records(records[:1])
    batch = predictor.predict_records(records)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[serve-pp] launches over 2 forwards: {launches}")
    require(launches == expected(flash_attention=24, capsule_routing=2), f"pp serving launches {launches}")
    check_rows("pp single", single, 1)
    check_rows("pp batch16", batch, 16)
    check_agree("pipeline layout (K4a) vs layered (K1)", batch, Predictor(layered, device="cuda").predict_records(records))
    lat = []
    for i in range(10):
        t = time.perf_counter()
        predictor.predict_records(records[i : i + 1])
        lat.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    for _ in range(3):
        predictor.predict_records(records)
    stays_per_s = 16 * 3 / (time.perf_counter() - t)
    log(f"[serve-pp] single-record p50_ms={float(np.percentile(lat, 50)):.2f}; batch-16 stays_per_s={stays_per_s:.2f}")
    profile_forward(predictor, batch_from_records(predictor.cfg, records), top=8)
    del predictor
    torch.cuda.empty_cache()
    return launches


def phase_splash(dev, tmp: str) -> dict:
    """MMR_ATTN=splash: the fine-tuned flagship step through K4b forward and
    backward (2 warm-up, 5 timed steps), then one serving forward of the
    layered checkpoint through K4b. -> {path: launches}."""
    before = os.environ.get("MMR_ATTN")
    os.environ["MMR_ATTN"] = "splash"
    try:
        out = {"train_splash": phase_train_finetune(
            dev, label="splash fine-tuned", profile=False,
            per_step={"splash_attention": 12, "splash_attention_bwd": 12, "capsule_routing": 1})}
        layered = os.path.join(tmp, "flagship")
        predictor = Predictor(layered, device="cuda")
        records = serving_records(predictor.cfg)
        predictor.predict_records(records[:2])
        torch.cuda.synchronize()
        reset_counts()
        rows = predictor.predict_records(records)
        torch.cuda.synchronize()
        out["serving_splash"] = read_counts()
        log(f"[serve-splash] launches over 1 forward: {out['serving_splash']}")
        require(out["serving_splash"] == expected(splash_attention=12, capsule_routing=1),
                f"splash serving launches {out['serving_splash']}")
        check_rows("splash batch16", rows, 16)
    finally:
        if before is None:
            os.environ.pop("MMR_ATTN")
        else:
            os.environ["MMR_ATTN"] = before
    check_agree("MMR_ATTN=splash (K4b) vs default (K1)", rows, Predictor(layered, device="cuda").predict_records(records))
    torch.cuda.empty_cache()
    return out


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
    expect = expected(packed_attention=12, capsule_routing=1)
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

    kernels = [phase_k1(dev), phase_k2(dev), phase_k3(dev), *phase_k4(dev)]
    phase_k3_grad(dev)
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_path["serving"] = phase_serving(dev, tmp)
        by_path["train_finetune"] = phase_train_finetune(dev)
        by_path["train_frozen"] = phase_train_frozen(dev)
        by_path["serving_pp"] = phase_serving_pp(dev, tmp)
        by_path["train_pp_finetune"] = phase_train_finetune(
            dev, warmup=1, steps=2, label="pipeline-layout fine-tuned", profile=False,
            per_step={"flash_attention": 12, "flash_attention_bwd": 12, "capsule_routing": 1},
            layer_key="pp_layers.i_kernel", **{"train.pipeline_parallel": True})
        by_path.update(phase_splash(dev, tmp))
        phase_entry_point(dev, tmp)
    for k in kernels:  # each kernel's own main path: the path this slice or an earlier one brought it up on
        k["launches"] = by_path[MAIN_PATH[k["name"]]][k["name"]]
        k["launches_by_path"] = {path: counts.get(k["name"], 0) for path, counts in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
