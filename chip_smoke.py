#!/usr/bin/env python3
"""Drive the PyTorch port's flagship serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It

1. builds the Hopper kernels from multimodalrouting_tpu_torch/csrc/ (one
   nvcc per source, in parallel), prints the build time and ptxas report
   (each kernel's registers and spills) and fails if the bf16 forward
   kernel spills;
2. holds K1 (packed attention) against its plain version at the flagship
   shape [128, 512, 768] in bf16 with masks from the synthetic cohort
   (all-pad chunks included), in fp32 at a smaller N, at head_dim 128 and at
   T = 1024; holds the bf16 forward (K1's and K4's kernel) and its lse
   against the plain version in the kernel's own order at tighter limits,
   shows that both limits reject planted faults, and times it as every
   kernel of one call beside SDPA, with TFLOP/s and its share of the bound;
3. holds K2 (the packed attention's backward: the di kernel, then the dq
   and dk/dv kernels) against its plain version at the same shapes, with a
   cotangent on every row, requires a repeat launch to give the same bits,
   holds the di kernel alone against its plain version, and shows that the
   bf16 limits reject two planted faults;
4. holds K3 (fused capsule routing, a thread-block cluster kernel) against
   its plain version at the mortality ([B, 10, 32] x [10, 32, 2, 64]) and
   phenotype ([B, 10, 32] x [10, 32, 25, 64]) heads, B = 1 and 16, fp32
   and bf16 inputs, and at the 7-route heads (N = 7, M = 2 and 25) at
   B = 16, with a repeat launch giving the same bits, times it as every
   kernel of one call beside an empty kernel's launch (floor_ms), checks
   B = 256, and holds its autograd gradients at the four heads against
   autograd through the plain program;
5. holds K4 (segment attention, the kernel pair of K4a flash and K4b
   splash), forward and backward, against its plain versions on every row at
   the flagship shape, at head_dim 128, at T = 1024 with 3 heads and in
   fp32 (a repeat backward giving the same bits; the bf16 forward also at
   the tight limits), shows that the bf16 limits reject two planted faults
   (K1's key-mask semantics, a dropped key tile) and the tight ones a
   correction factor left out, and times it beside SDPA with the boolean
   segment mask;
6. writes a full-width flagship checkpoint (BERT-base 12 x 768 over 8 x 512
   note chunks, ResNet34 on 224^2, MulT d=256, 10-route capsule head, bf16)
   with seeded random weights, loads it with Predictor(device="cuda") and
   serves one record, a batch of 16, a record without an image and one HTTP
   request, with the kernels' launch counters read around exactly that run;
   the same weights scored in fp32 on the CPU are the reference;
7. trains the full-width flagship with fine-tuned notes (batch 16, note
   packing on): 2 warm-up and 5 timed steps with the launch counters read
   around the timed ones, then one step's profile; from one fresh state,
   one timed step by default and one under MMR_FUSED_QKV=1 (12 / 12 / 1,
   the loss within 2**-8 and every gradient norm within 1e-2 of the
   default step's, fewer GEMMs in the forward, no more peak memory), each
   after a warm-up step; MMR_PACKED_BWD=xla raises in the packed backward
   of CUDA tensors; one step under the frozen-text default; then the
   repo's measuring entry points briefly (phase_bench): bench.py's two legs
   through scripts/torch_bench.py (1 + 2 steps each, K1/K2/K3 = 12/0/1 and
   12/12/1 a step, their JSON lines), each phase of
   scripts/torch_bench_phases.py once, one frozen step traced by
   scripts/torch_trace_report.py with its attention forward and K3
   launches equal to the counters, and Predictor.warmup on the checkpoint
   of 6 (K1 = 12, K3 = 1), then a request launching the same; then the
   JAX repo's last four scripts briefly (phase_scripts):
   scripts/torch_bench_text_cache.py at 1 warm-up and 1 timed step a leg
   (the cache pass K1 = 12, a direct step K1/K2/K3 = 12/0/1, a cached one
   0/0/1), scripts/torch_bench_bert.py at 16 chunks in bf16 and in int8
   (K1 = 12 per forward), scripts/torch_bench_int8.py at m = 4096 (every
   time and error finite) and scripts/torch_demo_families.py --only
   capsule-mort-7 --epochs 1 at full width (rc 0, K3 = 1 per forward);
8. serves the same weights from a train.pipeline_parallel=true config (the
   layers converted to the stacked pp_layers layout on load) at 1 and 16
   records through K4a, against the layered Predictor, and takes two
   fine-tuned steps on that layout (K4a forward and backward);
9. under MMR_ATTN=splash, 1 + 3 fine-tuned steps through K4b forward and
   backward, and one serving forward through K4b against the default one;
10. train_model over 32 + 16 stays for one epoch, whose checkpoint
   Predictor(device="cuda") serves;
11. the 25-phenotype model (configs/pheno_25.yaml on the same encoders):
   a checkpoint served at 1 and 16 records (K1 = 12, K3 = 1 per forward)
   against fp32 on the CPU, then one training step on the config read from
   the YAML and one on that config read back from a checkpoint;
12. the other families at full width on the same encoders (FAMILY_PATHS:
   gated concat with learned and loss-based gates, FAME++ with the learned
   and the loss-based gate on configs/fame_missing.yaml, the 7-route
   capsule head at M = 2 and M = 25, LateFusion, TriMF): each a seeded
   checkpoint served by Predictor(family=..., device="cuda") at 1 and 16
   records (K1 = 12 per forward, K3 = 1 on the capsule paths, nothing
   else) against fp32 on the CPU (probabilities, gates, block weights,
   alpha), its batch-16 profile and peak memory, and one frozen step; then
   one step per curriculum stage, gated step1 (fine-tuned notes: K2 = 12)
   -> step2 -> step3 and FAME++ uni -> bi -> tri under the loss-based
   gate, warm-started as --init-from does, with the frozen parameters (and
   the route-head slices outside the stage) bit-identical and the
   route-loss EMA moving;
13. the port's CLI in-process on configs/trimodal_mort.yaml at full width
   over a 64-stay synthetic cohort (notes clipped to 128 tokens and images
   to 96^2 by the CLI, as the JAX CLI clips them): train one epoch, resume
   to two from the train-state checkpoint (under --profile-dir), eval with
   the drop table and predict the test split, with K3 = 1 launch per
   forward and no attention kernel (T = 128 is below their gate); then the
   FAME++ curriculum uni -> bi -> tri (configs/fame_missing.yaml) and the
   gated one step1 -> step3, each stage with --init-from the last, eval
   --drop-table and predict on FAME++'s tri, one epoch each of LateFusion
   and TriMF, with no K3 and no attention kernel on any of them;
14. the per-route MulT family (configs/pheno_atten_mult.yaml: 25
   phenotypes, every directional route its own MulT stack, the sigmoid
   gate) at full width: a checkpoint served at 1 and 16 records against
   fp32 on the CPU, one frozen step (K1 = 12 per forward and per step, K3
   = 0: the sigmoid gate routes by the plain program), one `cli train`
   epoch and `cli eval` at the CLI's shapes (no kernel);
15. the frozen-BERT text cache (encoder.text_embedding_cache) at full
   width: train_model over 64 + 32 stays with K1 = 72 in the cache passes
   and K1 = 0, K3 = 1 in each step, cached against uncached forwards (fp32
   LayerNorm: within E2E_TOL; bf16: the gap logged), the frozen step timed
   with and without the cache, the epoch with and without it, and `cli eval
   --drop-table` with the cache;
16. a JAX-package checkpoint with no JAX on the machine: the full-width
   flagship's train state after one frozen step written in flax's msgpack
   layout (write_flax_checkpoint; the reader's time and rate logged) and as
   a port checkpoint; Predictor(dir, name=...) at 16 records bit-identical
   to the port checkpoint (K1 = 12, K3 = 1), `cli eval --ckpt DIR --name`,
   and one `cli train --resume` step from each, bit-identical and continuing
   the step counter; a background save (train.ckpt_backend=orbax_async) of
   the same state with one train step while it is written, byte-equal to
   the synchronous save, its blocking time beside the synchronous save's;
   pyarrow's zstd codec, and utils/orbax_reader.py's frame decoder on a
   frame compressed here (the card has no orbax to write a checkpoint);
17. the flagship on DenseNet-121 (encoder.vision_backbone=densenet121) at
   full width: a checkpoint served at 1 and 16 records against fp32 on the
   CPU (K1 = 12, K3 = 1 per forward) with its batch-16 profile and peak
   memory, one frozen and one fine-tuned step (K2 = 12) on the flagship
   training phase's cohort and note pack, each committing new running
   statistics in all 121 BatchNorms and timed, and a batch-16 forward under
   vision_norm=group;
18. pretrained encoder weights: a seeded BERT-base HF state_dict and a
   torchvision densenet121 one, torch.save()d, spliced by train_model into
   the DenseNet flagship on a fresh init (the weights, BatchNorm statistics
   and EMA equal to the files after the cast, bit for bit; both
   [pretrained] lines), and not again by `cli train --init-from`;
19. the unimodal trainers: the wide BEHRT on the stratified multitask split
   and on readmission (focal loss), the note trainer at full width (K1 = 12
   per embedding minibatch, none in the fit; the embedding pass timed), the
   OMOP and CT trainers, and `cli unimodal` for all four modalities, each
   writing finite metrics and fairness reports;
20. serving artifacts (artifact.py: a torch.export program with the kernels
   as custom ops) of the full-width flagship at batch 16: exported on the
   card (time, bytes) and served by ExportedPredictor at 1 and 16 records,
   equal to the live Predictor's forward of the same batch (K1 = 12, K3 = 1
   per call; p50 / p95 beside the live Predictor's; one HTTP request), the
   same weights exported on the CPU and served on the card through the
   kernels, an export under MMR_ATTN=splash (K4b = 12 per call), and `cli
   predict --export-artifact` then `--artifact` at the CLI's shapes;
21. the flagship with the int8 BERT body (encoder.int8_text=true): served at
   1 and 16 records (K1 = 12, K3 = 1 per forward) against fp32 on the CPU,
   the CLS cosine of 16 chunks against the bf16 body, and the batch-16
   forward's profile beside the bf16 body's with the int8 GEMMs by name;
22. the interpretability sweep (audit/sweep.py) over a full-width
   gated-concat forward's pooled outputs (K1 = 12, none in the sweep): its
   logits equal to the model's, f(obs) = G + UC + BI + TI to fp32 rounding,
   against the fp32 sweep on the CPU with the same permutations, then `cli
   interpret --out-csv` with the JAX package's columns;
23. the data layer (phase_data): a seeded raw MIMIC-IV-style csv.gz dump
   of 192 patients through `cli etl varmap | cohort | export --max-len 512
   --max-chunks 8` (stays/s, the tokenizer chosen, the native binner), 320^2
   JPEGs at the exported paths, then `cli train` of the full-width flagship
   on the export (24 x 17 labs) for one epoch, `cli eval --drop-table` and
   `cli predict --split test` (K1 = 12 and K3 = 1 per forward and per frozen
   step; each prediction with its stay_id), has_i exactly where a JPEG
   decoded, a timed frozen step at the export's note pack, one streamed
   epoch over exactly the dense train split's stays (the same launches),
   prefetch_to_device bit-equal to batch_to, the INSPECT note driver with a
   native WordPiece built by g++ (K1 = 12 per embedding minibatch), and `cli
   etl medfuse | inspect | legacy` (no kernel);
24. the process mesh (phase_mesh; parallel/): two ranks of this script
   share cuda:0 over gloo (NCCL puts no two ranks on one card), the
   kernels built here before they start: (a) three fine-tuned data=2 steps
   of the full-width flagship on 16 stays, 8 a rank (K1/K2/K3 = 12/12/1 per
   rank per step, the parameters bit-identical across the ranks, step 1's
   loss and global gradient norm within 2e-2 of the one-process step on
   the same 16, per-rank step ms, peak memory and the gradient reduction's
   bytes and ms), (b) 2 such steps under ZeRO-1 (its parameters within
   1e-6 of (a)'s after one step, each rank's Adam bytes at most 0.55 of
   (a)'s),
   (c) a frozen data=1, model=2 step (K1 = 12 per rank, each rank's BERT
   recorded on half the note pack that one process runs it on, the loss
   within 2e-2 of the one-process frozen step), (d) `cli
   train --mesh data=2` as two processes with the JAX package's variables
   (one epoch, one checkpoint written by rank 0) and `cli eval` of it here
   (K3 = 1 per forward), (e) NCCL chosen by init_multihost in a world of
   one, each collective helper run on a CUDA tensor. Two ranks on one card
   give no scaling figure;
25. logs each phase's seconds, then prints a {"kernels": [...]} line (each
   kernel with its launches on its own path and on every path, the mesh's
   per rank), the card's name and power limit, and the {"ok": true,
   "device": ...} line last.

Any failed check raises, and the script exits non-zero without the last
line. Without a CUDA card it exits 2 before doing anything.

`--mesh-rank RANK WORLD PORT WORKDIR DEVICE` and `--cli-rank ARGV_JSON` run
one rank of phase_mesh; the script starts them itself.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from multimodalrouting_tpu_torch import cli as port_cli
from multimodalrouting_tpu_torch.ckpt import host_copy, load_config, load_meta, save_checkpoint
from multimodalrouting_tpu_torch.configs import apply_overrides, load_cfg, to_dict
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.cxr import BatchNorm
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops import hopper
from multimodalrouting_tpu_torch.ops import flash
from multimodalrouting_tpu_torch.ops.capsule import capsule_weight_init
from multimodalrouting_tpu_torch.ops.flash import (
    attention_fwd_tiled_reference,
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
from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused, capsule_routing_reference, empty_launch
from multimodalrouting_tpu_torch.serve import (
    Predictor,
    batch_from_records,
    calibrate_probs,
    make_http_server,
    probs_from_logits,
)
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket, train_model
from multimodalrouting_tpu_torch.train.state import (
    create_train_state,
    leaf_trainable,
    load_train_state_dict,
    n_route_loss_ema_for,
    serving_state_dict,
    train_state_dict,
)
from multimodalrouting_tpu_torch.train.steps import loss_family, make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
import torch_bench  # noqa: E402
import torch_bench_bert  # noqa: E402
import torch_bench_int8  # noqa: E402
import torch_bench_phases  # noqa: E402
import torch_bench_text_cache  # noqa: E402
import torch_demo_families  # noqa: E402
import torch_trace_report  # noqa: E402

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
# The bf16 forward (K1 and K4 alike) is also held against the plain version
# in its own order (ops/flash.py attention_fwd_tiled_reference: the same key
# tiles, p rounded to bf16 unnormalised against the same running maximum).
# Only fp32 summation order, the log2-domain logits and the hardware ex2
# (~2^-22 relative) differ, so the two land on different sides of a bf16
# rounding of p or of the output only where their fp32 values straddle it:
# - max|got - ref| <= 2**-7 * max|ref|: one bf16 ulp at the output's largest
#   magnitude (a straddled output rounding is one ulp);
# - rms(got - ref) <= 0.25 * rms(ref - exact): a straddle needs an fp32
#   difference of ~1e-6 relative, so few elements move, where the TPU order
#   (p normalised, then rounded) moves every one by an independent rounding
#   (ratio ~1, rejected; phase 2 shows it, and a correction factor left out).
TILED_MAX_REL = 2.0**-7
TILED_RMS_RATIO = 0.25
# The forward's lse (natural log) against the tiled plain version's
# m + log l: the kernel's maximum is taken in the log2 domain and scaled back
# (two roundings of m), l summed in another order with the hardware ex2.
LSE_TOL = (1e-5, 1e-6)
# di = rowsum(o * do) in fp32: the kernel and the plain version sum the same
# products in another order.
DI_TOL = (2e-5, 2e-5)
K3_TOL = (1e-5, 1e-5)  # fp32 routing, sums in another order
# ... or, where the routing's conditioning makes the plain version's own
# fp32 error the larger (k3_errors says when), rms(got - ref) <= 2 *
# rms(ref - exact), exact the plain program in float64: two fp32
# evaluations of the same function that round independently differ by
# ~sqrt(2) times one's own error, as K1_BF16_RMS_RATIO reasons for bf16.
K3_RMS_RATIO = 2.0
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


# The attention forward's kernel (K1 and K4 alike) and the backward's
# kernels (K2 and K4 alike), in launch order.
FWD_KERNELS = {"fwd": "attention_fwd_wgmma_kernel"}
BWD_KERNELS = {"di": "bwd_di_kernel", "dq": "bwd_dq_wgmma_kernel", "dkdv": "bwd_dkdv_wgmma_kernel"}


TRACE_TRIES = 3  # traces of a call's kernels before a short one fails


def call_ms(fn, kernels: dict, iters: int = 20) -> tuple:
    """Device time of one call: every CUDA kernel in a profiler trace of
    `iters` calls, summed and divided by `iters`, with its split into
    `kernels` ({part: name}), each launched once a call. A trace that holds
    fewer than `iters` launches of a part lost events (one such trace gave
    a fifth of the true time, above the card's peak): it is traced again, up
    to TRACE_TRIES times. Fails if a kernel of the call is missing or another
    kernel ran. -> (ms, {part: ms})."""
    for _ in range(TRACE_TRIES):
        spans = device_spans(fn, iters)
        counts = {part: sum(1 for name, _ in spans if key in name) for part, key in kernels.items()}
        if all(c == iters for c in counts.values()):
            break
        log(f"[trace] launches in the trace {counts}, {iters} calls: events lost, tracing again")
    require(all(c == iters for c in counts.values()), f"the trace holds {counts} launches of {iters} calls")
    split = {part: sum(us for name, us in spans if key in name) / iters / 1e3 for part, key in kernels.items()}
    require(all(ms > 0 for ms in split.values()), f"a kernel of the call is missing from the trace: {split}")
    others = sorted({name for name, _ in spans if not any(key in name for key in kernels.values())})
    require(not others, f"the call launched other kernels: {others}")
    return sum(us for _, us in spans) / iters / 1e3, split


def bwd_ms(fn, iters: int = 20) -> tuple:
    return call_ms(fn, BWD_KERNELS, iters)


def fwd_ms(fn, iters: int = 20) -> float:
    return call_ms(fn, FWD_KERNELS, iters)[0]


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


def within_tiled_limits(e: dict) -> bool:
    return e["finite"] and e["max_abs_err"] <= TILED_MAX_REL * e["max_ref"] and e["rms_ratio"] <= TILED_RMS_RATIO


def describe_tiled(e: dict) -> str:
    return (f"max_abs_err={e['max_abs_err']:.3e} = {e['ulps_at_worst']:.1f} bf16 ulp at |ref|={e['ref_at_worst']:.4f} "
            f"(limit 2^-7 * max|ref| = {TILED_MAX_REL * e['max_ref']:.3e}), "
            f"rms_ratio={e['rms_ratio']:.4f} (limit {TILED_RMS_RATIO})")


def tiled_without_correction(q4, k4, v4, m, mode: str, block_k: int) -> torch.Tensor:
    """A planted fault: the forward's tiled plain version with the running
    maximum's correction of acc and l left out."""
    dt = q4.dtype
    if mode == "key_mask":
        s = torch.einsum("bqhd,bkhd->bhqk", q4.float(), k4.float()) + ((1.0 - m) * -1e30)[:, None, None, :]
    else:
        s = flash.segment_logits(q4, k4, m)
    mx = torch.full(s.shape[:-1] + (1,), -float("inf"), device=s.device)
    l, acc = torch.zeros_like(mx), 0.0
    for k0 in range(0, s.shape[-1], block_k):
        sb = s[..., k0 : k0 + block_k]
        mx = torch.maximum(mx, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - mx)
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v4[:, k0 : k0 + block_k].float())
    return (acc / l).transpose(1, 2).to(dt)


def check_fwd_tiled(tag: str, q4, k4, v4, m, mode: str, out, lse=None, faults=()) -> dict:
    """The bf16 forward kernel's output [N, T, H, dh] against the plain
    version in its own order (the tight limits), and its lse, if given,
    against that version's on every row. `faults`: (name, output) pairs that
    the tight limits must reject. -> the output's errors."""
    bk = flash.fwd_block_k(q4.shape[-1])
    ref, ref_lse = attention_fwd_tiled_reference(q4, k4, v4, m, mode, bk)
    exact = attention_fwd_tiled_reference(q4.float(), k4.float(), v4.float(), m, mode, bk)[0]
    e = bf16_errors(out, ref, exact)
    log(f"[check] {tag} against the tiled plain version (block_k {bk}): {describe_tiled(e)}")
    require(within_tiled_limits(e), f"{tag}: outside the tight limits against the tiled plain version")
    if lse is not None:
        check_close(f"{tag} lse", lse, ref_lse, *LSE_TOL)
    for fault, bad in faults:
        fe = bf16_errors(bad, ref, exact)
        log(f"[fault] {tag} planted fault, {fault}: {describe_tiled(fe)}")
        require(not within_tiled_limits(fe), f"the tight limits accept a planted fault: {fault}")
    return e


def fwd_rates(ms: float, flops: float, bound_ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound"


def plain_coarse_p(q, k, v, m, heads: int, bits: int) -> torch.Tensor:
    """A planted fault: the plain version of K1 with p rounded to `bits`
    significant bits instead of bf16's 8."""
    n, t, d = q.shape
    q4, k4, v4 = (x.reshape(n, t, heads, d // heads).float() for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4) + ((1.0 - m) * -1e30)[:, None, None, :]
    mant, ex = torch.frexp(torch.softmax(logits, dim=-1))
    p = torch.ldexp(torch.round(mant * 2**bits) / 2**bits, ex)
    return torch.einsum("bhqk,bkhd->bqhd", p, v4).reshape(n, t, d).to(q.dtype)


TP_K1_TAG = "K1 bf16 [96,512,384] dh=64 (a TP rank's 6 heads)"


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
        out_lse, lse = packed_attention_fwd(q, k, v, m, 12, want_lse=True)
        torch.cuda.synchronize()
        require(torch.equal(out, out_lse), "K1: the output differs with and without the lse write")
        require(torch.equal(out, packed_attention(q, k, v, m, 12)), "K1: a repeat launch gave other bits")
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
        q4, k4, v4 = (heads4(x, 12) for x in (q, k, v))
        check_fwd_tiled("K1 bf16 [128,512,768] dh=64", q4, k4, v4, m, "key_mask", heads4(out, 12), lse, faults=(
            ("correction factor left out", tiled_without_correction(q4, k4, v4, m, "key_mask", 128)),
            ("p normalised before rounding (the TPU order)", heads4(ref, 12))))
        del ref, out_lse, lse
        ms = fwd_ms(lambda: packed_attention(q, k, v, m, 12))
        # under a gradient the forward also writes each row's log-sum-exp for K2
        ms_lse = fwd_ms(lambda: packed_attention_fwd(q, k, v, m, 12, want_lse=True))
        plain_ms = device_time_ms(lambda: packed_attention_reference(q, k, v, m, 12), 5)
        qh, kh, vh = (x.transpose(1, 2) for x in (q4, k4, v4))
        add_mask = ((1.0 - m) * -1e30).to(torch.bfloat16)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = device_time_ms(lambda: sdpa(qh, kh, vh, attn_mask=add_mask, scale=1.0), 20)
        del qh, kh, vh, q4, k4, v4

        q2, k2, v2, m2 = k1_inputs(16, 512, 12, 64, torch.float32, dev, mask)
        check_close("K1 fp32 [16,512,768] dh=64", packed_attention(q2, k2, v2, m2, 12),
                    packed_attention_reference(q2, k2, v2, m2, 12), *K1_FP32_TOL)
        # a tensor-parallel rank's shape at data=1,model=2 (parallel/tp.py): BERT-base's 12 heads split
        # in two, 6 heads of 64, d = 384, on a 96-chunk pack
        q2, k2, v2, m2 = k1_inputs(96, 512, 6, 64, torch.bfloat16, dev, mask)
        out2, lse2 = packed_attention_fwd(q2, k2, v2, m2, 6, want_lse=True)
        require(torch.equal(out2, packed_attention(q2, k2, v2, m2, 6)), "K1 at 6 heads: a repeat gave other bits")
        tp_err = check_bf16(TP_K1_TAG, out2, packed_attention_reference(q2, k2, v2, m2, 6),
                            packed_attention_reference(q2.float(), k2.float(), v2.float(), m2, 6))
        check_fwd_tiled(TP_K1_TAG, heads4(q2, 6), heads4(k2, 6), heads4(v2, 6), m2, "key_mask", heads4(out2, 6), lse2)
        tp_ms = fwd_ms(lambda: packed_attention(q2, k2, v2, m2, 6))
        tp_plain_ms = device_time_ms(lambda: packed_attention_reference(q2, k2, v2, m2, 6), 5)
        qh, kh, vh = (heads4(x, 6).transpose(1, 2) for x in (q2, k2, v2))
        add_mask = ((1.0 - m2) * -1e30).to(torch.bfloat16)[:, None, None, :]
        tp_library_ms = device_time_ms(lambda: sdpa(qh, kh, vh, attn_mask=add_mask, scale=1.0), 20)
        del out2, lse2, qh, kh, vh
        for n2, t2, h2, dh2, m_src in ((32, 512, 6, 128, mask), (8, 1024, 12, 64, None)):
            if m_src is None:  # T = 1024: the cohort's chunks two by two
                m_src = mask[: 2 * n2].reshape(n2, 1024)
            q2, k2, v2, m2 = k1_inputs(n2, t2, h2, dh2, torch.bfloat16, dev, m_src)
            tag = f"K1 bf16 [{n2},{t2},{h2 * dh2}] dh={dh2}"
            out2, lse2 = packed_attention_fwd(q2, k2, v2, m2, h2, want_lse=True)
            check_bf16(tag, out2, packed_attention_reference(q2, k2, v2, m2, h2),
                       packed_attention_reference(q2.float(), k2.float(), v2.float(), m2, h2))
            check_fwd_tiled(tag, heads4(q2, h2), heads4(k2, h2), heads4(v2, h2), m2, "key_mask", heads4(out2, h2), lse2)
    n, t, d, h, dh = 128, 512, 768, 12, 64
    flops = 4 * n * h * t * t * dh
    bound_ms, bound_by = bound(4 * n * t * d * 2 + n * t * 4, flops, "bf16")
    log(f"[k1] kernel_ms={ms:.4f} (with the lse write {ms_lse:.4f}; {fwd_rates(ms, flops, bound_ms)}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} ({fwd_rates(library_ms, flops, bound_ms)}) "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    tp_flops = 4 * 96 * 6 * t * t * dh
    tp_bound_ms, _ = bound(4 * 96 * t * 384 * 2 + 96 * t * 4, tp_flops, "bf16")
    log(f"[k1] {TP_K1_TAG}: kernel_ms={tp_ms:.4f} ({fwd_rates(tp_ms, tp_flops, tp_bound_ms)}) "
        f"plain_ms={tp_plain_ms:.4f} library_ms={tp_library_ms:.4f} bound_ms={tp_bound_ms:.4f}")
    return {
        "name": "packed_attention", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/packed_attention.cu",
        "replaces": "multimodalrouting_tpu/ops/flash_packed.py:58",
        "max_abs_err": err, "ms": ms, "ms_with_lse": ms_lse, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "tp_rank_shape": {"shape": [96, 512, 384], "heads": 6, "max_abs_err": tp_err, "ms": tp_ms,
                          "plain_ms": tp_plain_ms, "bound_ms": tp_bound_ms, "library_ms": tp_library_ms},
    }


def sdpa_bwd_ms(q, k, v, m, do, heads: int) -> float:
    """The library's backward: SDPA on the [N, H, T, dh] view of packed
    [N, T, H*dh] tensors with K1's additive key mask, every kernel of one
    ``autograd.grad`` call summed (20 calls)."""
    q4, k4, v4 = (heads4(x, heads).transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    add_mask = ((1.0 - m) * -1e30).to(torch.bfloat16)[:, None, None, :]
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=add_mask, scale=1.0)
    do4 = heads4(do, heads).transpose(1, 2)
    spans = device_spans(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True), 20)
    return sum(us for _, us in spans) / 20 / 1e3


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
    library_ms = sdpa_bwd_ms(q, k, v, m, do, 12)
    with torch.no_grad():
        q2, k2, v2, m2, do2 = k2_inputs(16, 512, 12, 64, torch.float32, dev, mask)
        check_k2("fp32 [16,512,768] dh=64", q2, k2, v2, m2, do2, 12)
        q2, k2, v2, m2, do2 = k2_inputs(32, 512, 6, 128, torch.bfloat16, dev, mask)
        check_k2("bf16 [32,512,768] dh=128", q2, k2, v2, m2, do2, 6)
        # a tensor-parallel rank's shape at data=1,model=2: 6 heads of 64, d = 384
        q2, k2, v2, m2, do2 = k2_inputs(96, 512, 6, 64, torch.bfloat16, dev, mask)
        tp_err = check_k2("bf16 [96,512,384] dh=64 (a TP rank's 6 heads)", q2, k2, v2, m2, do2, 6)
        out2, lse2 = packed_attention_fwd(q2, k2, v2, m2, 6, want_lse=True)
        tp_ms, tp_split = bwd_ms(lambda: packed_attention_bwd(q2, k2, v2, m2, out2, lse2, do2, 6))
        tp_plain_ms = device_time_ms(lambda: packed_attention_bwd_reference(q2, k2, v2, m2, do2, 6), 5)
    tp_library_ms = sdpa_bwd_ms(q2, k2, v2, m2, do2, 6)
    del q2, k2, v2, m2, do2, out2, lse2
    n, t, d, h, dh = 128, 512, 768, 12, 64
    # reads q, k, v, K1's output o, do, the mask and K1's lse once; writes
    # dq, dk, dv once; five T x T x dh products per head
    bound_ms, bound_by = bound(8 * n * t * d * 2 + n * t * 4 + n * h * t * 4, 10 * n * h * t * t * dh, "bf16")
    log(f"[k2] kernel_ms={ms:.4f} ({describe_split(split)}) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    tp_bound_ms, _ = bound(8 * 96 * t * 384 * 2 + 96 * t * 4 + 96 * 6 * t * 4, 10 * 96 * 6 * t * t * dh, "bf16")
    log(f"[k2] bf16 [96,512,384] dh=64 (a TP rank's 6 heads): kernel_ms={tp_ms:.4f} ({describe_split(tp_split)}) "
        f"plain_ms={tp_plain_ms:.4f} library_ms={tp_library_ms:.4f} bound_ms={tp_bound_ms:.4f}")
    return {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "multimodalrouting_tpu/ops/flash_packed.py:140",
        "max_abs_err": err, "ms": ms, "split_ms": split, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "tp_rank_shape": {"shape": [96, 512, 384], "heads": 6, "max_abs_err": tp_err, "ms": tp_ms,
                          "split_ms": tp_split, "plain_ms": tp_plain_ms, "bound_ms": tp_bound_ms,
                          "library_ms": tp_library_ms},
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


def check_k4(tag: str, q, k, v, m, do, heads: int, plant_faults: bool = False) -> tuple:
    """K4 forward and backward against the plain versions on every row:
    bf16 limits per output (`exact`: the plain versions in fp32 with nothing
    rounded) and the forward's tight limits, or fp32 tolerances. The serving
    forward (no lse) must equal the training one, and a second backward
    launch must give the same bits. `plant_faults`: the tight limits must
    also reject two planted forward faults. -> (forward error, backward
    error)."""
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
    faults = (("correction factor left out", tiled_without_correction(q4, k4, v4, m, "segment", 128)),
              ("p normalised before rounding (the upstream order)", ref)) if plant_faults else ()
    check_fwd_tiled(f"K4 {tag} out", q4, k4, v4, m, "segment", out, lse, faults)
    exact_grads = segment_attention_bwd_reference(qf, kf, vf, m, exact, do4.float())
    bwd = max(check_bf16(f"K4 {tag} {n}", x, y, e) for n, x, y, e in zip(names, grads, ref_grads, exact_grads))
    return fwd, bwd


PP_MICRO_CHUNKS = 48  # a GPipe microbatch of phase_mesh (i): the 96-chunk pack over 2 stages


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
        fwd_err, bwd_err = check_k4("bf16 [128,512,768] dh=64", q, k, v, m, do, h, plant_faults=True)
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
        fwd_times = {w.__name__: fwd_ms(lambda: w(q4, k4, v4, m)) for w in (flash_self_attention, splash_self_attention)}
        ms_lse = fwd_ms(lambda: segment_attention_fwd(q4, k4, v4, m, True, flash_self_attention))
        bwd = {w.__name__: bwd_ms(lambda: segment_attention_bwd(q4, k4, v4, m, out, lse, do4, w))
               for w in (flash_self_attention, splash_self_attention)}
        plain_ms = device_time_ms(lambda: segment_attention_reference(q4, k4, v4, m), 5)
        plain_bwd_ms = device_time_ms(lambda: segment_attention_bwd_reference(q4, k4, v4, m, out, do4), 3)
        # K4a at a GPipe microbatch of the pipelined flagship step (parallel/pp.py): half of a 96-chunk pack,
        # held against the plain versions there, and at the whole pack the one-process reference runs on
        mb = slice(0, PP_MICRO_CHUNKS)
        for rows, what in ((PP_MICRO_CHUNKS, "a GPipe microbatch"), (2 * PP_MICRO_CHUNKS, "the pipeline's pack")):
            check_k4(f"bf16 [{rows},512,768] dh=64 ({what})", q[:rows], k[:rows], v[:rows], m[:rows], do[:rows], h)
        mb_ms = fwd_ms(lambda: flash_self_attention(q4[mb], k4[mb], v4[mb], m[mb]))
        mb_bwd_ms, mb_split = bwd_ms(lambda: segment_attention_bwd(q4[mb], k4[mb], v4[mb], m[mb], out[mb], lse[mb],
                                                                   do4[mb], flash_self_attention))
        # the library: SDPA on the [N, H, T, dh] view with the boolean segment mask [N, 1, T, T]
        same = (m[:, None, :, None] == m[:, None, None, :])
        qh, kh, vh = (x.transpose(1, 2) for x in (q4, k4, v4))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = device_time_ms(lambda: sdpa(qh, kh, vh, attn_mask=same, scale=1.0), 20)
        mb_library_ms = device_time_ms(lambda: sdpa(qh[mb], kh[mb], vh[mb], attn_mask=same[mb], scale=1.0), 20)

    def sdpa_bwd_ms(rows: slice) -> float:
        qg, kg, vg = (x[rows].detach().requires_grad_() for x in (qh, kh, vh))
        out_h = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=same[rows], scale=1.0)
        dout = do4[rows].transpose(1, 2)
        spans = device_spans(lambda: torch.autograd.grad(out_h, (qg, kg, vg), dout, retain_graph=True), 20)
        return sum(us for _, us in spans) / 20 / 1e3

    library_bwd_ms, mb_library_bwd_ms = sdpa_bwd_ms(slice(None)), sdpa_bwd_ms(mb)
    del qh, kh, vh, same, q, k, v, q4, k4, v4, do4, out, lse
    torch.cuda.empty_cache()
    with torch.no_grad():
        check_k4("bf16 [32,512,768] dh=128", *k2_inputs(32, 512, 6, 128, torch.bfloat16, dev, mask), 6)
        check_k4("bf16 [16,1024,192] 3 heads dh=64", *k2_inputs(16, 1024, 3, 64, torch.bfloat16, dev, long_mask), 3)
        check_k4("fp32 [16,512,768] dh=64", *k2_inputs(16, 512, 12, 64, torch.float32, dev, mask), 12)
        check_k4("fp32 [8,1024,256] dh=128", *k2_inputs(8, 1024, 2, 128, torch.float32, dev, long_mask), 2)
    d = h * dh
    flops = 4 * n * h * t * t * dh
    bound_ms, bound_by = bound(4 * n * t * d * 2 + n * t * 4, flops, "bf16")
    # the backward reads q, k, v, o, do, the mask and lse once, writes dq,
    # dk, dv once; five T x T x dh products per head
    bwd_bound_ms, bwd_bound_by = bound(8 * n * t * d * 2 + n * t * 4 + n * h * t * 4,
                                       10 * n * h * t * t * dh, "bf16")
    for w, ms in fwd_times.items():
        log(f"[k4] {w} forward kernel_ms={ms:.4f} ({fwd_rates(ms, flops, bound_ms)})")
    log(f"[k4] forward with the lse write {ms_lse:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"({fwd_rates(library_ms, flops, bound_ms)}) bound_ms={bound_ms:.4f} ({bound_by})")
    for w, (ms, split) in bwd.items():
        log(f"[k4] {w} backward kernel_ms={ms:.4f} ({describe_split(split)}) plain_ms={plain_bwd_ms:.4f} "
            f"library_ms={library_bwd_ms:.4f} bound_ms={bwd_bound_ms:.4f} ({bwd_bound_by})")
    nm = PP_MICRO_CHUNKS
    mb_bound_ms, _ = bound(4 * nm * t * d * 2 + nm * t * 4, 4 * nm * h * t * t * dh, "bf16")
    mb_bwd_bound_ms, _ = bound(8 * nm * t * d * 2 + nm * t * 4 + nm * h * t * 4, 10 * nm * h * t * t * dh, "bf16")
    pp_shape = {"shape": [nm, t, d], "heads": h, "ms": mb_ms, "bound_ms": mb_bound_ms, "library_ms": mb_library_ms,
                "bwd_ms": mb_bwd_ms, "bwd_split_ms": mb_split, "bwd_bound_ms": mb_bwd_bound_ms,
                "bwd_library_ms": mb_library_bwd_ms}
    log(f"[k4] flash_self_attention at a GPipe microbatch [{nm},{t},{d}]: forward kernel_ms={mb_ms:.4f} "
        f"library_ms={mb_library_ms:.4f} bound_ms={mb_bound_ms:.4f}, backward kernel_ms={mb_bwd_ms:.4f} "
        f"({describe_split(mb_split)}) library_ms={mb_library_bwd_ms:.4f} bound_ms={mb_bwd_bound_ms:.4f}")
    rows = []
    for name, wrapper, replaces in (("flash_attention", flash_self_attention, "multimodalrouting_tpu/ops/flash.py:100"),
                                    ("splash_attention", splash_self_attention, "multimodalrouting_tpu/ops/flash.py:48")):
        rows.append({
            "name": name, "route": "cuda", "source": "multimodalrouting_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "max_abs_err": fwd_err, "ms": fwd_times[wrapper.__name__], "ms_with_lse": ms_lse,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            **({"pipeline_microbatch_shape": pp_shape} if name == "flash_attention" else {}),
        })
        rows.append({
            "name": f"{name}_bwd", "route": "cuda", "source": "multimodalrouting_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "max_abs_err": bwd_err, "ms": bwd[wrapper.__name__][0],
            "split_ms": bwd[wrapper.__name__][1], "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
            "library_ms": library_bwd_ms,
        })
    return rows


# K3's two heads: (N, A, M, D) of the mortality (M = 2) and phenotype
# (M = 25) capsule heads; the tables list both at B = 1 (one scored stay)
# and B = 16 (the serving and training batch).
K3_HEADS = {"mortality": (10, 32, 2, 64), "phenotype": (10, 32, 25, 64)}
# The 7-route heads (model.routes=7): at M = 2 the planner gives a cluster of
# 7 x 2 CTAs, one route each; at M = 25 one route group of 16 label CTAs,
# each streaming 7 routes.
K3_HEADS_7 = {"mortality_7": (7, 32, 2, 64), "phenotype_7": (7, 32, 25, 64)}


def k3_inputs(b: int, head: str, dtype, dev, seed: int = SEED):
    """Seeded pose ~ N(0, 1), the head's routing acts (the route mask: some
    stays miss N or I) and w at its init scale, in `dtype`."""
    n, a, m, d = {**K3_HEADS, **K3_HEADS_7}[head]
    rng = np.random.default_rng(seed)
    pose = torch.from_numpy(rng.normal(size=(b, n, a)).astype(np.float32))
    act = torch.from_numpy((rng.random((b, n)) > 0.3).astype(np.float32))
    w = capsule_weight_init(n, a, m, d, torch.Generator().manual_seed(seed))
    return tuple(x.to(device=dev, dtype=dtype) for x in (pose, act, w))


def k3_errors(got, ref, exact) -> dict:
    """K3's outputs against the plain version `ref`, beside the plain
    version's own fp32 rounding error against `exact` (the plain program in
    float64). At M = 25 the routing amplifies rounding: on N(0, 1) poses the
    plain version itself lands up to a few 1e-5 from the exact value
    (this script on an H100, fp32), so where K3_TOL does not hold
    element by element the kernel is held to K3_RMS_RATIO."""
    excess = max(((x - y).abs() - (K3_TOL[0] + K3_TOL[1] * y.abs())).max().item() for x, y in zip(got, ref))
    # pose and coef (the decision act is exact on both sides)
    diff = torch.cat([(x.double() - y.double()).flatten() for x, y in zip(got[::2], ref[::2])])
    own = torch.cat([(y.double() - e).flatten() for y, e in zip(ref[::2], exact[::2])])
    return {
        "finite": all(bool(torch.isfinite(x).all()) for x in got),
        "max_abs_err": max((x - y).abs().max().item() for x, y in zip(got, ref)),
        "plain_err": max((y.double() - e).abs().max().item() for y, e in zip(ref, exact)),
        "rms_ratio": (diff.norm() / own.norm().clamp_min(1e-300)).item(),
        "within_tol": excess <= 0,
    }


def within_k3_limits(e: dict) -> bool:
    return e["finite"] and (e["within_tol"] or e["rms_ratio"] <= K3_RMS_RATIO)


def check_k3(tag: str, pose, act, w, iters: int = 3) -> dict:
    """K3 against its plain version (K3_TOL, or K3_RMS_RATIO against the
    plain version's own error); a second launch must give the same bits."""
    with torch.no_grad():
        got = capsule_routing_fused(pose, act, w, iters)
        again = capsule_routing_fused(pose, act, w, iters)
        torch.cuda.synchronize()
        ref = capsule_routing_reference(pose, act, w, iters)
        exact = capsule_routing_reference(pose, act, w, iters, compute_dtype=torch.float64)
    require(all(torch.equal(x, y) for x, y in zip(got, again)), f"K3 {tag}: a repeat launch gave other bits")
    e = k3_errors(got, ref, exact)
    log(f"[check] K3 {tag}: max_abs_err={e['max_abs_err']:.3e} (within {K3_TOL} elementwise: {e['within_tol']}; "
        f"the plain version's own error {e['plain_err']:.3e}, rms ratio {e['rms_ratio']:.3f}), repeat bit-identical")
    require(within_k3_limits(e), f"K3 {tag}: outside its limits")
    return e


def phase_k3_grad(dev) -> None:
    """The K3 autograd Function's gradients (kernel forward, the plain
    program's VJP backward) against autograd through the plain program, at
    both heads, 10 and 7 routes."""
    for head in {**K3_HEADS, **K3_HEADS_7}:
        pose, act, w = k3_inputs(16, head, torch.float32, dev, SEED + 2)
        b, n, a = pose.shape
        m, d = w.shape[2:]
        rng = np.random.default_rng(SEED + 3)
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
            check_close(f"K3 {head} gradient d{name}", x, y, *K3_TOL)


def k3_bound(b: int, n: int, a: int, m: int, d: int, es: int, iters: int = 3):
    """Each input read once (in its own type), each fp32 output written
    once; the votes' and each iteration's products (agreement and decision
    pose, 2 FLOPs a term each)."""
    flops = 2 * b * n * a * m * d + iters * (2 * b * n * m * d * 2)
    bytes_moved = es * (b * n * a + b * n + n * a * m * d) + 4 * (b * m * d + b * m + b * n * m)
    return bound(bytes_moved, flops, "fp32")


def phase_k3(dev) -> dict:
    """K3 at both heads, B = 1 and 16, and at the 7-route heads, B = 16, fp32
    and bf16 inputs: errors, repeat bits, time as every kernel of one call
    beside the empty kernel's (floor_ms), the plain version's and the bound;
    also B = 256 (errors only). -> the kernels-line row (the phenotype head
    at B = 16 in bf16, the model's path, with every row in `rows`)."""
    floor_ms = call_ms(lambda: empty_launch(dev), {"empty": "capsule_routing_empty_kernel"}, 50)[0]
    rows = []
    for head, (n, a, m, d) in {**K3_HEADS, **K3_HEADS_7}.items():
        for b in ((1, 16) if head in K3_HEADS else (16,)):
            for dtype in (torch.float32, torch.bfloat16):
                pose, act, w = k3_inputs(b, head, dtype, dev)
                tag = f"{head} [{b},{n},{a}] x [{n},{a},{m},{d}] {str(dtype)[6:]}"
                e = check_k3(tag, pose, act, w)
                with torch.no_grad():
                    ms = call_ms(lambda: capsule_routing_fused(pose, act, w, 3), {"k3": "capsule_routing_kernel"}, 50)[0]
                    plain_ms = device_time_ms(lambda: capsule_routing_reference(pose, act, w, 3), 20)
                bound_ms, bound_by = k3_bound(b, n, a, m, d, pose.element_size())
                log(f"[k3] {tag}: kernel_ms={ms:.5f} floor_ms={floor_ms:.5f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound_ms:.6f} ({bound_by})")
                rows.append({"head": head, "b": b, "dtype": str(dtype)[6:], "max_abs_err": e["max_abs_err"],
                             "plain_err": e["plain_err"], "rms_ratio": e["rms_ratio"], "within_tol": e["within_tol"], "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    for head in {**K3_HEADS, **K3_HEADS_7}:  # beyond one cluster's tile
        for dtype in (torch.float32, torch.bfloat16):
            check_k3(f"{head} B=256 {str(dtype)[6:]}", *k3_inputs(256, head, dtype, dev, SEED + 4))
    main = next(r for r in rows if r["head"] == "phenotype" and r["b"] == 16 and r["dtype"] == "bfloat16")
    return {
        "name": "capsule_routing", "route": "cuda",
        "source": "multimodalrouting_tpu_torch/csrc/capsule_routing.cu",
        "replaces": "multimodalrouting_tpu/ops/pallas_capsule.py:41",
        "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "floor_ms": floor_ms, "library_ms": None,
        "rows": rows,
    }


def seed_signal(model, family: str) -> torch.Generator:
    """Seeded nonzero values where initialisation leaves zeros or ones that
    would hide a difference: BatchNorm running statistics and the capsule
    head's class embedding and bias. -> the generator, for more draws."""
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
        if family == "capsule":
            head = model.capsule_head
            head.embedding.copy_(torch.randn(head.embedding.shape, generator=g).to(head.embedding.device))
            head.bias.copy_(0.1 * torch.randn(head.bias.shape, generator=g).to(head.bias.device))
    return g


def family_checkpoint(ckpt_dir: str, cfg, family: str) -> None:
    """A seeded random checkpoint of `family` at `cfg`, temperature 1.25 and
    threshold 0.4 (nonzero BatchNorm running statistics and capsule head
    embedding; under the loss-based sMRO gate a seeded route-loss EMA in the
    meta)."""
    torch.manual_seed(SEED)
    model = build_model(cfg, family, device="cpu")
    g = seed_signal(model, family)
    save_checkpoint(ckpt_dir, model.state_dict(), cfg, temperature=1.25, thresholds=[0.4])
    if n_route_loss_ema_for(cfg, loss_family(family)):  # the meta a trained run writes
        meta = load_meta(ckpt_dir)
        meta["route_loss_ema"] = (0.3 + 0.7 * torch.rand(7, generator=g)).tolist()
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump(meta, f)


def flagship_checkpoint(ckpt_dir: str, cfg=None):
    """Full-width flagship config (or `cfg`) at the real serving shapes (a
    real-cohort checkpoint: synthetic off, data_root set — never read),
    seeded random weights (family_checkpoint)."""
    cfg = cfg or flagship_cfg()
    family_checkpoint(ckpt_dir, cfg, "capsule")
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


def check_rows(name: str, rows, n: int, labels: int = 1, routes: int = 10) -> None:
    """Probabilities of the checkpoint's labels, and the route audit of
    `routes` routes (0: the family has none, and no row may carry one)."""
    require(len(rows) == n, f"{name}: {len(rows)} rows for {n} records")
    for row in rows:
        p = np.asarray(row["probs"], np.float64)
        require(p.size == labels and bool(np.isfinite(p).all() and ((0 <= p) & (p <= 1)).all()),
                f"{name}: bad probs {p}")
        if routes:
            require(len(row["alpha"]) == routes and len(row["top_routes"]) == 3, f"{name}: bad route audit")
        else:
            require("alpha" not in row, f"{name}: a route audit from a family without one")


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


def profile_forward(predictor, batch, top: int = 15) -> dict:
    """Where one serving forward's device time goes: kernel time by name from
    a torch.profiler trace, the device's busy share of the wall time.
    -> {kernel name: (calls, ms)}."""
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
    for rank, (name, (n, total)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][1])):
        if rank < top or "attn::" in name:  # the top rows and every attention kernel
            log(f"[profile] {total:9.3f} ms {100 * total / busy_ms:5.1f}% x{n:<5d} {name[:110]}")
    return by_name


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


def flagship_cfg(yaml: str = "trimodal_mort.yaml", **overrides):
    """configs/trimodal_mort.yaml (or `yaml`) on the defaults, as a
    real-cohort run (so a checkpoint serves the full L=512 and 224^2 shapes;
    data_root is never read)."""
    return load_cfg(
        os.path.join(ROOT, "configs", yaml),
        overrides={"data.synthetic": False, "data.data_root": "real-cohort", **overrides},
        environ={},
    )


def full_width_cohort(cfg, n: int, seed: int):
    e = cfg.encoder
    return make_synthetic_cohort(
        n, t=e.structured_seq_len, f=e.structured_n_feats, s=e.notes_max_chunks, l=e.text_max_len,
        image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=seed, task=cfg.model.task,
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
    "capsule_routing": "train_pheno", "flash_attention": "serving_pp",
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


GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def forward_gemms(model, batch) -> tuple:
    """(GEMM ops, GEMM kernels) of one forward without a gradient:
    torch.profiler's aten matrix-product calls and the device kernels whose
    names are cuBLAS's or CUTLASS's GEMMs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU and e.name in GEMM_OPS)
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                  and re.search(r"gemm|nvjet|xmma", e.name, re.IGNORECASE))
    return ops, kernels


def phase_switches(dev) -> dict:
    """The two attention switches on the card. MMR_PACKED_BWD=xla raises in
    the packed backward of CUDA tensors (the port's backward there is K2).
    MMR_FUSED_QKV=1 on the full-width fine-tuned flagship, one step from the
    state a default step starts from (batch 16, note packing on, dropout
    drawn from one seed): k and v one product at each self-attention site
    (K1 / K2 / K3 = 12 / 12 / 1, fewer GEMMs in the forward), its loss and
    gradient norms beside the default step's, and no more peak memory. Each
    step is timed after a warm-up step from the same state.
    -> {path: launches}."""
    from multimodalrouting_tpu_torch.train import steps as tsteps

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn(2, 256, 768, generator=g).to(dev, torch.bfloat16).requires_grad_() for _ in range(3))
    out = packed_attention(q, k, v, torch.ones(2, 256, device=dev), 12)
    os.environ["MMR_PACKED_BWD"] = "xla"
    try:
        out.sum().backward()
        raise SystemExit("MMR_PACKED_BWD=xla: the packed backward of CUDA tensors did not raise")
    except ValueError as e:
        require("port's packed backward is K2" in str(e), f"MMR_PACKED_BWD=xla raised {e!r}")
        log(f"[switches] MMR_PACKED_BWD=xla on CUDA tensors raises: {e}")
    finally:
        del os.environ["MMR_PACKED_BWD"]
    del q, k, v, out

    cfg = flagship_cfg(**{"encoder.finetune_text": True})
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    seed_signal(model, "capsule")  # a fresh head gives the encoders no gradient
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED)
    cap = note_pack_bucket(cfg, cohort)
    batch = batch_to(cohort, dev)
    snapshot = host_copy(train_state_dict(state))  # its own copy, on the CPU too
    real_apply = tsteps.apply_gradients
    norms: dict = {}

    def spy(st, grads, **kw):
        groups = {"bert": [], "vision": [], "rest": []}
        for n, g in grads.items():
            key = "bert" if ".bert." in n else "vision" if n.startswith("encoders.imgenc.") else "rest"
            groups[key].append(g.float().norm())
        norms.clear()
        norms.update({k: float(torch.stack(v).norm()) for k, v in groups.items() if v})
        norms["all"] = math.sqrt(sum(v * v for k, v in norms.items()))
        return real_apply(st, grads, **kw)

    def one_step(env: dict) -> dict:
        os.environ.update(env)
        tsteps.apply_gradients = spy
        try:
            step = make_train_step(cfg, model)

            def from_snapshot():
                load_train_state_dict(state, snapshot)
                gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
                return lambda: step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap)

            from_snapshot()()  # the warm-up step
            timed_step = from_snapshot()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t1 = time.perf_counter()
            m = timed_step()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            out = {"loss": float(m.loss), "finite": m.grad_finite, "norms": dict(norms), "step_ms": secs * 1e3,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": read_counts(),
                   "gemms": forward_gemms(model, batch)}
        finally:
            tsteps.apply_gradients = real_apply
            for k in env:
                del os.environ[k]
        log(f"[switches] {env or 'default'}: loss {out['loss']:.6f}, step_ms={out['step_ms']:.1f}, "
            f"peak_memory_gb={out['peak_gb']:.2f}, launches {out['launches']}, "
            f"grad norms {', '.join(f'{k}={v:.6e}' for k, v in out['norms'].items())}, "
            f"forward GEMM ops / kernels {out['gemms']}")
        require(out["finite"] and np.isfinite(out["loss"]), f"{env}: non-finite loss or gradient")
        return out

    base, fused = one_step({}), one_step({"MMR_FUSED_QKV": "1"})
    layers = cfg.encoder.bert_layers
    require(base["launches"] == expected(packed_attention=layers, packed_attention_bwd=layers, capsule_routing=1),
            f"default step launches {base['launches']}")
    require(fused["launches"] == base["launches"], f"MMR_FUSED_QKV=1 launches {fused['launches']}")
    # k and v from one GEMM over two weights in bf16: rounding in the
    # products' last bits only, so the loss within 2**-8 of the default
    # step's and each gradient norm within 1e-2 (bf16's 2**-8 relative
    # rounding, summed over millions of elements)
    rel = abs(fused["loss"] - base["loss"]) / abs(base["loss"])
    log(f"[switches] MMR_FUSED_QKV=1: loss {fused['loss']:.6f} vs {base['loss']:.6f} (rel {rel:.2e}); forward GEMM "
        f"ops {fused['gemms'][0]} vs {base['gemms'][0]}, kernels {fused['gemms'][1]} vs {base['gemms'][1]}; "
        f"step {fused['step_ms']:.1f} vs {base['step_ms']:.1f} ms; "
        f"peak memory {fused['peak_gb']:.2f} vs {base['peak_gb']:.2f} GB")
    require(rel <= 2**-8, f"MMR_FUSED_QKV=1 loss off by {rel:.2e} (limit 2**-8)")
    for k, v in base["norms"].items():
        rel = abs(fused["norms"][k] - v) / max(v, 1e-30)
        require(rel <= 1e-2, f"MMR_FUSED_QKV=1: {k} gradient norm off by {rel:.2e} (limit 1e-2)")
    # the aten calls are host events; a later profiler session in one
    # process has dropped device events (170 GEMM kernels read as 72), so
    # the kernel count is logged and not required
    require(fused["gemms"][0] < base["gemms"][0],
            f"MMR_FUSED_QKV=1 forward GEMM ops {fused['gemms'][0]}, not fewer than {base['gemms'][0]}")
    # k and v keep their own product alive for the backward, and nothing of q
    require(fused["peak_gb"] <= base["peak_gb"] * 1.005,
            f"MMR_FUSED_QKV=1 peak memory {fused['peak_gb']:.2f} GB above the default's {base['peak_gb']:.2f} GB")
    del model, state, batch, snapshot
    torch.cuda.empty_cache()
    log(f"[switches] phase done in {time.perf_counter() - t0:.1f}s")
    return {"train_fused_qkv": fused["launches"]}


def checkpoint_variant(src: str, dst: str, section: str, key: str, value, also=()) -> str:
    """The checkpoint `src` under other config values: its weights, meta and
    train state (where it has one) hard-linked into `dst`, config.json with
    cfg[section][key] = value and each (section, key, value) of `also`."""
    os.makedirs(dst)
    for name in ("weights.pt", "meta.json", "train_state.pt"):
        if os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "config.json")) as f:
        cfg_dict = json.load(f)
    for sec, k, v in ((section, key, value), *also):
        cfg_dict[sec][k] = v
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
    backward (1 warm-up, 3 timed steps), then one serving forward of the
    layered checkpoint through K4b. -> {path: launches}."""
    before = os.environ.get("MMR_ATTN")
    os.environ["MMR_ATTN"] = "splash"
    try:
        out = {"train_splash": phase_train_finetune(
            dev, warmup=1, steps=3, label="splash fine-tuned", profile=False,
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


def phase_bench(dev, tmp: str) -> dict:
    """The repo's measuring scripts on the card, briefly: bench.py's two
    legs through scripts/torch_bench.py (1 warm-up and 2 timed steps each),
    each phase of scripts/torch_bench_phases.py once, the trace report of one
    frozen step, and Predictor.warmup on phase_serving's checkpoint."""
    by_path = {}
    e = flagship_cfg().encoder
    for finetune in (False, True):
        label = "bench_finetune" if finetune else "bench_frozen"
        k = torch_bench.Knobs(steps=2, warmup=1, finetune=finetune)
        reset_counts()
        res = torch_bench.run_bench(k, dev)
        torch.cuda.synchronize()
        by_path[label] = read_counts()
        log(f"[bench] {label}: {json.dumps(res['line'])}")
        per_step = {"K1": e.bert_layers, "K2": e.bert_layers if finetune else 0, "K3": 1, "K4": 0}
        require(res["launches"] == {n: c * k.steps for n, c in per_step.items()},
                f"{label}: launches {res['launches']} over {k.steps} steps, expected {per_step} a step")
        runs = k.warmup + k.steps
        require(by_path[label] == expected(**{name: c * runs for name, c in (
            ("packed_attention", per_step["K1"]), ("packed_attention_bwd", per_step["K2"]),
            ("capsule_routing", 1))}), f"{label}: launches {by_path[label]} over {runs} steps")
        require(all(np.isfinite(res["losses"])) and res["line"]["value"] > 0, f"{label}: {res['losses']}")
        if not finetune:  # the trace report of one frozen step, held to the counters
            w = res["workload"]
            reset_counts()
            window = torch_trace_report.trace_window(lambda: w.force(w.step_once()), 1, dev)
            by_path["bench_trace"] = read_counts()
            report = torch_trace_report.report("step", window, 1, dev, top=8)
            log(f"[bench] trace of one frozen step: {json.dumps({key: v for key, v in report.items() if key != 'top_ops'})}")
            for row in report["top_ops"]:
                log(f"[bench] {row['ms']:9.3f} ms x{row['calls']:<5d} {row['cat']:24s} {row['op'][:90]}")
            held = {"attention_fwd_wgmma_kernel": e.bert_layers, "capsule_routing_kernel": 1}
            require(window["traced"] == window["counted"] == held,
                    f"trace launches {window['traced']}, counted {window['counted']}, expected {held}")
            del w
        del res
        torch.cuda.empty_cache()

    k = torch_bench.Knobs()
    w = torch_bench.build_workload(torch_bench.phase_overrides(k.batch, {}), k, dev)
    reset_counts()
    table = torch_bench_phases.run_phases(w, steps=1, warmup=0, device=dev)
    by_path["bench_phases"] = read_counts()
    log(f"[bench] phases, one call each: {json.dumps(table)}")
    times = [v for key, v in table.items() if key.endswith("_ms")]
    require(all(np.isfinite(times)) and min(times) > 0, f"a phase took no time: {table}")
    require(by_path["bench_phases"] == expected(packed_attention=3 * e.bert_layers, capsule_routing=2),
            f"phases: launches {by_path['bench_phases']}, expected K1 = 12 in each of bert_fwd, model_fwd "
            "and train_step and K3 = 1 in each of the last two")
    del w
    torch.cuda.empty_cache()

    cfg = load_config(os.path.join(tmp, "flagship"))
    predictor = Predictor(os.path.join(tmp, "flagship"), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    predictor.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    by_path["serving_warmup"] = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    check_rows("after warm-up", predictor.predict_records(serving_records(cfg)[:1]), 1)
    first_ms = (time.perf_counter() - t0) * 1e3
    log(f"[bench] Predictor.warmup {warm_s:.2f}s launched {by_path['serving_warmup']}; the first request "
        f"{first_ms:.2f} ms launched {read_counts()}")
    one = expected(packed_attention=cfg.encoder.bert_layers, capsule_routing=1)
    require(by_path["serving_warmup"] == one == read_counts(), "the warm-up's launches are not a request's")
    return by_path


SCRIPTS_BERT_N = 16  # phase_scripts: chunks of torch_bench_bert.py's forward
SCRIPTS_INT8_M = 4096  # phase_scripts: rows of torch_bench_int8.py's product


def phase_scripts(dev, tmp: str) -> dict:
    """The JAX repo's last four scripts through their port copies, briefly:
    the text-cache bench at 1 warm-up and 1 timed step a leg, the BERT
    forward at SCRIPTS_BERT_N chunks in bf16 and int8, the int8 product at
    SCRIPTS_INT8_M rows, and one full-width family run of the families
    sweep (capsule-mort-7, one epoch over CLI_N stays a split)."""
    by_path = {}
    layers = flagship_cfg().encoder.bert_layers
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    k = torch_bench.Knobs(steps=1, warmup=1)
    reset_counts()
    res = torch_bench_text_cache.run_text_cache(k, dev)
    torch.cuda.synchronize()
    by_path["text_cache_bench"] = read_counts()
    log(f"[scripts] text cache: {json.dumps(res['line'])}; launches {json.dumps(res['launches'])}")
    held = {"cache_build": {**none, "K1": layers}, "direct": {**none, "K1": layers * k.steps, "K3": k.steps},
            "cached": {**none, "K3": k.steps}}
    require(res["launches"] == held, f"text cache: launches {res['launches']}, expected {held}")
    runs = k.warmup + k.steps
    require(by_path["text_cache_bench"] == expected(packed_attention=layers * (1 + runs), capsule_routing=2 * runs),
            f"text cache: launches {by_path['text_cache_bench']} over the pass and {runs} steps a leg")
    line = res["line"]
    require(all(np.isfinite(list(res["losses"].values()))) and min(
        line["direct_stays_per_sec"], line["cached_stays_per_sec"]) > 0, f"text cache: {line}, {res['losses']}")
    del res
    torch.cuda.empty_cache()

    steps = 2
    for int8 in (False, True):
        label = f"bench_bert_{'int8' if int8 else 'bf16'}"
        reset_counts()
        r = torch_bench_bert.run_bert(SCRIPTS_BERT_N, steps, int8, "poly", dev)
        torch.cuda.synchronize()
        by_path[label] = read_counts()
        log(f"[scripts] {label}: n={SCRIPTS_BERT_N} {r['ms']:.3f} ms/fwd {r['tflops']:.2f} TFLOP/s "
            f"MFU={r['mfu_pct']:.2f}%; launches of one forward {json.dumps(r['launches'])}")
        require(r["launches"] == {**none, "K1": layers}, f"{label}: launches {r['launches']} in one forward")
        require(by_path[label] == expected(packed_attention=layers * (1 + steps)),
                f"{label}: launches {by_path[label]} over {1 + steps} forwards")
        require(bool(torch.isfinite(r["cls"]).all()) and r["ms"] > 0, f"{label}: non-finite CLS rows")
    torch.cuda.empty_cache()

    r = torch_bench_int8.run_int8(SCRIPTS_INT8_M, torch_bench_int8.K, torch_bench_int8.N, dev, steps=3)
    log(f"[scripts] bench_int8 at [{SCRIPTS_INT8_M}, {torch_bench_int8.K}] x [{torch_bench_int8.K}, "
        f"{torch_bench_int8.N}]: ms {json.dumps({n: t * 1e3 for n, t in r['seconds'].items()})}, "
        f"dynamic dense rel err mean={r['rel_mean']:.4f} p99={r['rel_p99']:.4f}")
    values = [*r["seconds"].values(), r["rel_mean"], r["rel_p99"]]
    require(all(np.isfinite(values)) and min(r["seconds"].values()) > 0, f"bench_int8: {r}")
    x32, w32, _, _ = torch_bench_int8.operands(SCRIPTS_INT8_M, torch_bench_int8.K, torch_bench_int8.N)
    x, w = torch.from_numpy(x32), torch.from_numpy(w32)
    ref = torch_bench_int8.quant_dense(x, w).float()  # the same prototype on the CPU
    diff = float((torch_bench_int8.quant_dense(x.to(dev), w.to(dev)).float().cpu() - ref).abs().max())
    log(f"[scripts] bench_int8: the dynamic dense on the card against the CPU: max |diff| {diff:.3e} "
        f"of max |ref| {float(ref.abs().max()):.3e}")
    require(diff <= 2.0**-7 * float(ref.abs().max()), f"bench_int8: the card's dynamic dense is {diff} off the CPU's")

    out = os.path.join(tmp, "families")
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = torch_demo_families.main(["--only", "capsule-mort-7", "--epochs", "1", "--n", str(CLI_N),
                                       "--out", out])
    torch.cuda.synchronize()
    by_path["families_capsule_mort_7"] = read_counts()
    with open(os.path.join(out, "summary.json")) as f:
        row = json.load(f)[0]
    log(f"[scripts] torch_demo_families.py capsule-mort-7: rc={rc} {json.dumps(row)}")
    forwards = CLI_N // CLI_BATCH + 2 * -(-CLI_N // CLI_BATCH)  # the steps, validation and test
    require(rc == 0 and row["rc"] == 0 and row["epochs"] == 1 and np.isfinite(row["val_auroc_best"]),
            f"families run: rc {rc}, {row}")
    require(by_path["families_capsule_mort_7"] == expected(capsule_routing=forwards),
            f"families run: launches {by_path['families_capsule_mort_7']}, expected K3 = {forwards}")
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    return by_path


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


def pheno_step(cfg, dev, label: str) -> dict:
    """One training step of the full-width phenotype model on `cfg`, frozen
    notes (the default), batch 16 of the synthetic phenotype cohort:
    launches, loss. -> launches."""
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED + 6)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    batch = batch_to(cohort, dev)
    reset_counts()
    m = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=note_pack_bucket(cfg, cohort))
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[pheno] {label}: pos_weight_clip={cfg.train.pos_weight_clip!r} loss={float(m.loss):.5f} "
        f"task_loss={float(m.task_loss):.5f} launches {launches}")
    require(np.isfinite(float(m.loss)) and m.grad_finite, f"{label}: non-finite loss or gradient")
    expect = expected(packed_attention=cfg.encoder.bert_layers, capsule_routing=1)
    require(launches == expect, f"{label} launches {launches}, expected {expect}")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


def phase_pheno(dev, tmp: str) -> dict:
    """configs/pheno_25.yaml (25 phenotype labels, 10 routes) on the
    flagship's encoder defaults at full width: a seeded-random checkpoint
    served by Predictor(device="cuda") at 1 and 16 records through K1 and K3
    (M = 25), against the same weights in fp32 on the CPU; then one
    training step on the config load_cfg reads from the YAML and one on
    that config read back from a checkpoint (ckpt.load_config): both take
    train.pos_weight_clip as a tuple (fault F1 fixed). -> {path: launches}."""
    cfg = flagship_cfg("pheno_25.yaml")
    require(cfg.model.task == "pheno" and cfg.model.num_classes == 25 and cfg.train.pos_weight_clip == (0.1, 5.0),
            f"pheno_25.yaml loaded as {cfg.model.task}, {cfg.model.num_classes}, {cfg.train.pos_weight_clip!r}")
    ckpt = os.path.join(tmp, "pheno")
    flagship_checkpoint(ckpt, cfg)
    predictor = Predictor(ckpt, device="cuda")
    records = serving_records(cfg)
    predictor.predict_records(records[:2])
    torch.cuda.synchronize()
    reset_counts()
    single = predictor.predict_records(records[:1])
    batch = predictor.predict_records(records)
    torch.cuda.synchronize()
    out = {"serving_pheno": read_counts()}
    log(f"[pheno] serving launches over 2 forwards: {out['serving_pheno']}")
    layers = cfg.encoder.bert_layers
    require(out["serving_pheno"] == expected(packed_attention=2 * layers, capsule_routing=2),
            f"phenotype serving launches {out['serving_pheno']}")
    check_rows("pheno single", single, 1, labels=25)
    check_rows("pheno batch16", batch, 16, labels=25)
    out16 = predictor.predict(batch_from_records(cfg, records))
    require(out16["r_matrix"].shape == (16, 10, 25), f"bad r_matrix shape {out16['r_matrix'].shape}")
    ref_dir = checkpoint_variant(ckpt, os.path.join(tmp, "pheno_fp32"), "model", "dtype", "float32")
    ref_rows = Predictor(ref_dir, device="cpu").predict_records(records[:2])
    dp = max(float(np.abs(np.asarray(g["probs"]) - np.asarray(r["probs"])).max()) for g, r in zip(batch, ref_rows))
    da = max(abs(g["alpha"][k] - r["alpha"][k]) for g, r in zip(batch, ref_rows) for k in r["alpha"])
    log(f"[pheno] card bf16 vs CPU fp32: max|dprob|={dp:.3e} over 25 labels x 2 records, "
        f"max|dalpha|={da:.3e} (tol {E2E_TOL})")
    require(dp <= E2E_TOL and da <= E2E_TOL, "phenotype serving disagrees with the fp32 CPU reference")
    profile_forward(predictor, batch_from_records(cfg, records), top=8)
    del predictor
    torch.cuda.empty_cache()
    out["train_pheno"] = pheno_step(cfg, dev, "step on configs/pheno_25.yaml")
    save_checkpoint(os.path.join(tmp, "pheno_cfg"), {}, cfg)
    again = load_config(os.path.join(tmp, "pheno_cfg"))
    require(again == cfg, "the phenotype config did not survive a checkpoint's config.json")
    out["train_pheno_ckpt"] = pheno_step(again, dev, "step on the config read back by ckpt.load_config")
    return out


# The other families on the flagship's encoders at full width: (path, family,
# config YAML, overrides). fame runs on configs/fame_missing.yaml (BASELINE.json
# configs[4]: multitask, 3 heads, route dropout 0.25, fairness gamma 0.1).
FAMILY_PATHS = (
    ("gated_learned", "gated_concat", "trimodal_mort.yaml", {"model.gate_mode": "learned"}),
    ("gated_loss_based", "gated_concat", "trimodal_mort.yaml", {"model.gate_mode": "loss_based"}),
    ("fame_learned", "fame", "fame_missing.yaml", {"model.smro_gate_mode": "learned"}),
    ("fame_loss_based", "fame", "fame_missing.yaml", {"model.smro_gate_mode": "loss_based"}),
    ("capsule7_mort", "capsule", "trimodal_mort.yaml", {"model.routes": "7"}),
    ("capsule7_pheno", "capsule", "pheno_25.yaml", {"model.routes": "7", "model.bi_fusion_mode": "linear"}),
    ("late_fusion", "late_fusion", "trimodal_mort.yaml", {}),
    ("trimf", "trimf", "trimodal_mort.yaml", {}),
)


def max_diff(a, b) -> float:
    return float((a.detach().float().cpu() - b.detach().float().cpu()).abs().max())


def serve_family(label: str, family: str, cfg, tmp: str) -> dict:
    """A seeded checkpoint of the path served by Predictor(family=...,
    device="cuda") at 1 and 16 records (launches read around exactly those
    two forwards), against the same weights in fp32 on the CPU (2 records):
    probabilities of every label, and gates, block weights and alpha where
    the family has them. Then the batch-16 forward's profile and peak memory."""
    ckpt = os.path.join(tmp, label)
    t0 = time.perf_counter()
    family_checkpoint(ckpt, cfg, family)
    predictor = Predictor(ckpt, family, device="cuda")
    records = serving_records(cfg)
    predictor.predict_records(records[:2])
    torch.cuda.synchronize()
    reset_counts()
    single = predictor.predict_records(records[:1])
    rows = predictor.predict_records(records)
    torch.cuda.synchronize()
    launches = read_counts()
    layers = cfg.encoder.bert_layers
    k3 = 2 * k3_per_forward(cfg, family)
    log(f"[families] {label}: serving launches over 2 forwards: {launches}")
    require(launches == expected(packed_attention=2 * layers, capsule_routing=k3),
            f"{label} serving launches {launches}, expected K1 = {2 * layers}, K3 = {k3}")
    labels = cfg.model.num_classes if cfg.model.task != "mort" else 1
    routes = len(predictor.routes) if family == "capsule" else 0
    check_rows(f"{label} single", single, 1, labels, routes)
    check_rows(f"{label} batch16", rows, 16, labels, routes)

    ref_dir = checkpoint_variant(ckpt, os.path.join(tmp, label + "_fp32"), "model", "dtype", "float32")
    ref = Predictor(ref_dir, family, device="cpu")
    two = batch_from_records(cfg, records[:2])
    out, ref_out = predictor.forward(two), ref.forward(two)
    ref_probs = calibrate_probs(probs_from_logits(ref_out.logits.numpy(), cfg.model.task), ref.temperature)
    diffs = {"prob": float(np.abs(np.asarray([r["probs"] for r in rows[:2]], np.float64).reshape(2, -1)
                                  - np.asarray(ref_probs, np.float64).reshape(2, -1)).max())}
    for name in ("gates", "block_w", "alpha"):
        if getattr(ref_out, name) is not None:
            diffs[name] = max_diff(getattr(out, name), getattr(ref_out, name))
    log(f"[families] {label}: card bf16 vs CPU fp32 over 2 records: "
        + ", ".join(f"max|d{k}|={v:.3e}" for k, v in diffs.items()) + f" (tol {E2E_TOL}); "
        f"checkpoint and references in {time.perf_counter() - t0:.1f}s")
    require(all(v <= E2E_TOL for v in diffs.values()), f"{label}: serving disagrees with the fp32 CPU reference")
    del ref
    torch.cuda.reset_peak_memory_stats()
    profile_forward(predictor, batch_from_records(cfg, records), top=8)
    log(f"[families] {label}: batch-16 forward peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del predictor
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)
    shutil.rmtree(ref_dir)
    return launches


def k3_per_forward(cfg, family: str) -> int:
    """K3 launches per forward: one on the capsule family's softmax_out
    routing; none under the sigmoid gate (configs/pheno_atten_mult.yaml),
    which routes by the plain program, as the JAX head does, nor on the
    other families."""
    return int(family == "capsule" and cfg.model.capsule_act_type != "sigmoid_gate")


def family_step(label: str, family: str, cfg, dev) -> dict:
    """One frozen training step at batch 16 -> launches (K1 = 12, K3 as
    k3_per_forward, nothing else)."""
    torch.manual_seed(SEED)
    model = build_model(cfg, family, device="cuda", train=True)
    lf = loss_family(family)
    state = create_train_state(cfg, model, n_route_loss_ema=n_route_loss_ema_for(cfg, lf))
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED + 7)
    step = make_train_step(cfg, model, lf)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    batch = batch_to(cohort, dev)
    torch.cuda.synchronize()
    reset_counts()
    m = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=note_pack_bucket(cfg, cohort))
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[families] {label}: frozen step loss={float(m.loss):.5f} launches {launches}")
    require(np.isfinite(float(m.loss)) and m.grad_finite, f"{label}: non-finite loss or gradient")
    expect = expected(packed_attention=cfg.encoder.bert_layers, capsule_routing=k3_per_forward(cfg, family))
    require(launches == expect, f"{label} step launches {launches}, expected {expect}")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


def stage_chain(dev, family: str, yaml: str, stages, overrides: dict, finetune_first: bool) -> dict:
    """One training step per curriculum stage at batch 16, each stage's
    state warm-started from the last one's as --init-from does (weights,
    EMA and route-loss EMA; a fresh optimizer). The first stage with
    fine-tuned notes where `finetune_first` (K2 = 12 on it). Every stage:
    the parameters leaf_trainable freezes stay bit-identical; under the
    loss-based sMRO gate the route-head slices outside the stage's block too
    (weight decay on) and the route-loss EMA moves. -> {path: launches}."""
    out, saved = {}, None
    for i, stage in enumerate(stages):
        finetune = finetune_first and i == 0
        cfg = flagship_cfg(yaml, **{**overrides, "encoder.finetune_text": finetune})
        lf = loss_family(family)
        torch.manual_seed(SEED)
        model = build_model(cfg, family, device="cuda", train=True)
        state = create_train_state(cfg, model, stage=stage, n_route_loss_ema=n_route_loss_ema_for(cfg, lf))
        if saved is not None:
            load_train_state_dict(state, saved, params_only=True)
        named = dict(model.named_parameters())
        frozen = {n: p.detach().clone() for n, p in named.items() if n not in state.names}
        watched = state.names[-1]
        watched_before = named[watched].detach().clone()
        require(all(not leaf_trainable(n, finetune, stage) for n in frozen), f"{stage}: frozen set")
        blocks = {"uni": [0, 1, 2], "bi": [3, 4, 5], "tri": [6]}
        head_frozen = {}
        if state.route_loss_ema is not None:
            keep = [r for r in range(7) if r not in blocks[stage]]
            head_frozen = {n: named[n].detach()[keep].clone() for n in named if n.startswith("route_heads.")}
            ema_before = state.route_loss_ema.clone()
        cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED + 8 + i)
        step = make_train_step(cfg, model, lf, stage=stage)
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
        batch = batch_to(cohort, dev)
        torch.cuda.synchronize()
        reset_counts()
        m = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=note_pack_bucket(cfg, cohort))
        torch.cuda.synchronize()
        launches = read_counts()
        label = f"chain_{family}_{stage}"
        log(f"[families] {label}: {len(state.names)} of {len(named)} parameter tensors trained, "
            f"{len(frozen)} frozen; loss={float(m.loss):.5f} launches {launches}")
        require(np.isfinite(float(m.loss)) and m.grad_finite, f"{label}: non-finite loss or gradient")
        expect = expected(packed_attention=12, packed_attention_bwd=12 if finetune else 0)
        require(launches == expect, f"{label} launches {launches}, expected {expect}")
        moved = [n for n, p in frozen.items() if not torch.equal(named[n].detach(), p)]
        require(not moved, f"{label}: frozen parameters moved: {moved[:4]}")
        require(not torch.equal(named[watched].detach(), watched_before), f"{label}: {watched} did not move")
        if state.route_loss_ema is not None:
            keep = [r for r in range(7) if r not in blocks[stage]]
            still = [n for n, p in head_frozen.items() if not torch.equal(named[n].detach()[keep], p)]
            require(not still, f"{label}: route-head slices outside {stage} moved: {still}")
            require(not torch.equal(state.route_loss_ema, ema_before), f"{label}: the route-loss EMA did not move")
            log(f"[families] {label}: route_loss_ema {np.round(state.route_loss_ema.cpu().numpy(), 4).tolist()}")
        out[label] = launches
        saved = train_state_dict(state)
        del model, state, batch, frozen, head_frozen
        torch.cuda.empty_cache()
    return out


def phase_families(dev, tmp: str) -> dict:
    """The other routing families at full width (flagship_cfg: 512-token
    notes, 224^2 images; seeded random weights): for each FAMILY_PATHS path
    a checkpoint served at 1 and 16 records and one frozen step at batch 16;
    then the curricula gated step1 -> step2 -> step3 (step1 with fine-tuned
    notes) and fame uni -> bi -> tri under the loss-based gate (weight decay
    0.05, so that a frozen slice that took decay would move). -> {path:
    launches}."""
    out = {}
    for label, family, yaml, overrides in FAMILY_PATHS:
        t0 = time.perf_counter()
        cfg = flagship_cfg(yaml, **overrides)
        out[f"serving_{label}"] = serve_family(label, family, cfg, tmp)
        out[f"train_{label}"] = family_step(label, family, cfg, dev)
        log(f"[families] {label}: path done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out.update(stage_chain(dev, "gated_concat", "trimodal_mort.yaml", ("step1", "step2", "step3"), {}, True))
    out.update(stage_chain(dev, "fame", "fame_missing.yaml", ("uni", "bi", "tri"),
                           {"model.smro_gate_mode": "loss_based", "train.weight_decay": 0.05}, False))
    log(f"[families] stage chains done in {time.perf_counter() - t0:.1f}s")
    return out



CLI_N, CLI_BATCH = 64, 16  # stays per split, batch: 4 steps an epoch at full width


def run_cli(argv: list) -> list:
    """port_cli.main(argv) in-process on the card, its time logged; -> (the
    lines it printed, which it logs too; the launches it made)."""
    torch.cuda.synchronize()
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port_cli.main(argv)
    torch.cuda.synchronize()
    secs, launches = time.perf_counter() - t0, read_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[cli] {line}")
    log(f"[cli] {argv[0]}: rc={rc} in {secs:.1f}s, launches {launches}")
    require(rc == 0, f"cli {argv[0]} exited {rc}")
    torch.cuda.empty_cache()
    return lines, launches


def phase_cli(dev, tmp: str) -> dict:
    """The north star's command, `cli train --family capsule --task mort
    --routes 10`, through the port's CLI at full width (BERT-base, ResNet34,
    MulT d=256, the 10-route head; configs/trimodal_mort.yaml) on the
    synthetic cohort, which the CLI clips to 128-token notes and 96^2
    images: one epoch with train-state checkpoints, a resume to two epochs
    under --profile-dir, eval with the drop table, predict. K3 must launch
    once per forward (training steps, validation, calibration, test, drop
    table, predict) and no attention kernel at all. Then the other
    families' commands at the same shapes, with no kernel launched at all.
    -> launches summed."""
    yaml = os.path.join(ROOT, "configs", "trimodal_mort.yaml")
    out, trace = os.path.join(tmp, "cli"), os.path.join(tmp, "cli_trace")
    sets = []
    for kv in (f"data.synthetic_n={CLI_N}", f"train.batch_size={CLI_BATCH}", "train.min_epochs=0"):
        sets += ["--set", kv]
    train = ["train", "--family", "capsule", "--task", "mort", "--routes", "10", "--config", yaml, "--out", out,
             "--device", "cuda", *sets]
    steps = CLI_N // CLI_BATCH
    batches = -(-CLI_N // CLI_BATCH)  # validation, test and predict
    epoch_fwd = steps + batches  # training steps, then the validation pass
    total = expected()

    def check(label: str, launches: dict, k3: int) -> None:
        expect = expected(capsule_routing=k3)
        require(launches == expect, f"cli {label} launches {launches}, expected {expect}")
        for name in total:
            total[name] += launches[name]

    # ckpt_every=1 writes best, best_f1 and last; the resume reads last
    lines, launches = run_cli([*train, "--epochs", "1", "--set", "train.ckpt_every=1"])
    summary = json.loads(lines[-1])
    require(summary["epochs_ran"] == 1 and np.isfinite(summary["best_val_auroc"]), f"cli train: {summary}")
    check("train", launches, epoch_fwd + batches)
    step = load_meta(os.path.join(out, "last"))["step"]
    require(step == steps, f"last checkpoint at step {step}, expected {steps}")

    # ckpt_every=0: only final, which eval and predict read
    lines, launches = run_cli([*train, "--epochs", "2", "--resume", out, "--set", "train.ckpt_every=0",
                               "--profile-dir", trace])
    require(f"[resume] {out}/last at step {steps}" in lines, "cli resume: restored step not reported")
    summary = json.loads(lines[-1])
    with open(os.path.join(out, "history.json")) as f:
        history = json.load(f)
    require(summary["epochs_ran"] == 1 and [r["epoch"] for r in history] == [1]
            and np.isfinite(history[0]["train_loss"]), f"cli resume: {summary}, history {history}")
    check("resume", launches, epoch_fwd + batches)
    traces = os.listdir(trace)
    require(len(traces) == 1, f"--profile-dir wrote {traces}")
    log(f"[cli] resumed epoch: train_loss={history[0]['train_loss']:.5f} sec={history[0]['sec']:.2f}; "
        f"trace {traces[0]} {os.path.getsize(os.path.join(trace, traces[0]))} bytes")

    lines, launches = run_cli(["eval", "--ckpt", out, "--drop-table", "--device", "cuda"])
    metrics = json.loads("\n".join(lines[lines.index("{"): lines.index("}") + 1]))
    rows = [line.split()[0] for line in lines if line.split()[:1] and line.split()[0] in
            ("full", "dropL", "dropN", "dropI", "rand1")]
    require(np.isfinite(metrics["auroc"]) and rows == ["full", "dropL", "dropN", "dropI", "rand1"],
            f"cli eval: auroc {metrics.get('auroc')}, drop-table rows {rows}")
    require(os.path.exists(os.path.join(out, "test_route_audit.json")), "cli eval wrote no test_route_audit.json")
    check("eval", launches, batches + 5 * (CLI_N // CLI_BATCH))

    lines, launches = run_cli(["predict", "--ckpt", out, "--split", "test", "--device", "cuda"])
    with open(os.path.join(out, "predictions_test.jsonl")) as f:
        preds = [json.loads(line) for line in f]
    require(len(preds) == CLI_N and all(0.0 <= p["probs"] <= 1.0 for p in preds),
            f"cli predict wrote {len(preds)} rows for {CLI_N} stays")
    check("predict", launches, batches)

    # the other families at the same shapes: each curriculum chained stage by
    # stage with --init-from (final checkpoints only), eval with the drop
    # table and predict on the last fame stage, the baselines for one epoch;
    # no K3 and no attention kernel on any of them
    once = []
    for kv in (f"data.synthetic_n={CLI_N}", f"train.batch_size={CLI_BATCH}", "train.min_epochs=0",
               "train.ckpt_every=0"):
        once += ["--set", kv]
    fame_yaml = os.path.join(ROOT, "configs", "fame_missing.yaml")
    chains = (("fame", ("uni", "bi", "tri"), ["--config", fame_yaml, "--set", "model.smro_gate_mode=loss_based"]),
              ("gated_concat", ("step1", "step2", "step3"), ["--config", yaml, "--task", "mort"]))
    for family, stages, extra in chains:
        prev = None
        for stage in stages:
            dst = os.path.join(tmp, f"cli_{family}_{stage}")
            lines, launches = run_cli(["train", "--family", family, "--stage", stage, *extra, "--out", dst,
                                       "--epochs", "1", "--device", "cuda", *once,
                                       *(["--init-from", prev] if prev else [])])
            summary = json.loads(lines[-1])
            require(summary["family"] == family and summary["stage"] == stage and summary["epochs_ran"] == 1
                    and np.isfinite(summary["best_val_auroc"]), f"cli {family} {stage}: {summary}")
            check(f"{family} {stage}", launches, 0)
            if prev is not None:
                shutil.rmtree(prev)  # keep the disk small: ~1.4 GB a checkpoint
            prev = dst
        if family == "fame":
            lines, launches = run_cli(["eval", "--ckpt", prev, "--family", "fame", "--drop-table", "--device", "cuda"])
            rows = [line.split()[0] for line in lines if line.split()[:1] and line.split()[0] in
                    ("full", "dropL", "dropN", "dropI", "rand1")]
            require(rows == ["full", "dropL", "dropN", "dropI", "rand1"], f"cli fame eval: drop-table rows {rows}")
            check("fame eval", launches, 0)
            lines, launches = run_cli(["predict", "--ckpt", prev, "--family", "fame", "--split", "test",
                                       "--device", "cuda"])
            with open(os.path.join(prev, "predictions_test.jsonl")) as f:
                preds = [json.loads(line) for line in f]
            require(len(preds) == CLI_N and all(len(p["probs"]) == 3 for p in preds),
                    f"cli fame predict wrote {len(preds)} rows")
            check("fame predict", launches, 0)
        shutil.rmtree(prev)
    for family in ("late_fusion", "trimf"):
        dst = os.path.join(tmp, f"cli_{family}")
        lines, launches = run_cli(["train", "--family", family, "--config", yaml, "--task", "mort", "--out", dst,
                                   "--epochs", "1", "--device", "cuda", *once])
        summary = json.loads(lines[-1])
        require(summary["family"] == family and np.isfinite(summary["best_val_auroc"]), f"cli {family}: {summary}")
        check(family, launches, 0)
        shutil.rmtree(dst)
    log(f"[cli] launches over every command: {total}")
    return total


def set_args(*pairs) -> list:
    """--set KEY=VALUE for each pair."""
    return [arg for kv in pairs for arg in ("--set", kv)]


# the CLI's synthetic cohort at full width, one epoch, no checkpoint but final
CLI_ONCE = (f"data.synthetic_n={CLI_N}", f"train.batch_size={CLI_BATCH}", "train.min_epochs=0", "train.ckpt_every=0")


def phase_route_mult(dev, tmp: str) -> dict:
    """The per-route MulT family, configs/pheno_atten_mult.yaml (25
    phenotypes, 10 routes, every directional route its own MulT stack with
    cross_attn_layers=1 and the native-length causal bias, the sigmoid
    gate), on the flagship's encoders at full width: a seeded checkpoint
    served at 1 and 16 records against fp32 on the CPU, its batch-16 profile
    and peak memory, one frozen step (K1 = 12 per forward and per step; K3 =
    0: the sigmoid gate routes by the plain program, as the JAX head does;
    no K2, no K4); then one `cli train` epoch on the YAML at the CLI's
    synthetic shapes and `cli eval` of its checkpoint, with no kernel at all
    (T = 128). -> {path: launches}."""
    t0 = time.perf_counter()
    yaml = os.path.join(ROOT, "configs", "pheno_atten_mult.yaml")
    cfg = flagship_cfg("pheno_atten_mult.yaml")
    m = cfg.model
    require((m.task, m.num_classes, m.routes, m.bi_fusion_mode, m.cross_attn_layers, m.cross_attn_mask,
             m.capsule_act_type) == ("pheno", 25, "10", "mult", 1, True, "sigmoid_gate"),
            f"pheno_atten_mult.yaml loaded as {m}")
    out = {"serving_route_mult": serve_family("route_mult", "capsule", cfg, tmp),
           "train_route_mult": family_step("route_mult", "capsule", cfg, dev)}
    dst = os.path.join(tmp, "cli_route_mult")
    lines, launches = run_cli(["train", "--family", "capsule", "--task", "pheno", "--routes", "10", "--config", yaml,
                               "--out", dst, "--epochs", "1", "--device", "cuda", *set_args(*CLI_ONCE)])
    summary = json.loads(lines[-1])
    require(summary["epochs_ran"] == 1 and np.isfinite(summary["best_val_auroc"]), f"cli route_mult: {summary}")
    require(launches == expected(), f"cli route_mult train launches {launches}")
    lines, launches = run_cli(["eval", "--ckpt", dst, "--device", "cuda"])
    metrics = json.loads("\n".join(lines[lines.index("{"): lines.index("}") + 1]))
    require(np.isfinite(metrics["auroc_macro"]) and launches == expected(),
            f"cli route_mult eval: auroc_macro {metrics.get('auroc_macro')}, launches {launches}")
    shutil.rmtree(dst)
    log(f"[route-mult] phase done in {time.perf_counter() - t0:.1f}s")
    return out


def timed_steps(step, state, batch, gen, cap: int, warmup: int = 3, steps: int = 5) -> float:
    """ms per train step: `warmup` steps, then `steps` ended by synchronize."""
    lr = 1e-4
    for _ in range(warmup):
        step(state, batch, gen, lr, lr, note_pack=cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, batch, gen, lr, lr, note_pack=cap)
    torch.cuda.synchronize()
    require(np.isfinite(float(m.loss)), "non-finite loss in a timed step")
    return (time.perf_counter() - t0) / steps * 1e3


def phase_text_cache(dev, tmp: str) -> dict:
    """encoder.text_embedding_cache on configs/trimodal_mort.yaml at full
    width: train_model over 64 + 32 stays, batch 16, one epoch, with the
    launch counters read around the cache passes (K1 = 12 x (4 + 2) = 72,
    nothing else) and around each train step (K1 = 0, K3 = 1); the same run
    without the cache for its epoch time; cached against uncached forwards
    of the same weights (with the cache's own fp32 LayerNorm: |dprob| <=
    E2E_TOL; under the default bf16 LayerNorm the gap is logged); the frozen
    step timed with and without the cache; `cli eval --drop-table` with the
    cache on the trained checkpoint at the CLI's synthetic shapes. -> {path:
    launches}."""
    import multimodalrouting_tpu_torch.train.loop as loop_mod
    from multimodalrouting_tpu_torch.train.text_cache import attach_note_cache

    t0 = time.perf_counter()
    cfg = flagship_cfg(**{"encoder.text_embedding_cache": True, "train.epochs": 1, "train.min_epochs": 0,
                          "train.ckpt_every": 0})
    train_b, val_b = full_width_cohort(cfg, 64, SEED + 10), full_width_cohort(cfg, 32, SEED + 11)
    passes, steps = [], []

    def counted(fn, into):
        def run(*a, **k):
            torch.cuda.synchronize()
            reset_counts()
            result = fn(*a, **k)
            torch.cuda.synchronize()
            into.append(read_counts())
            return result
        return run

    real_attach, real_make = loop_mod.attach_note_cache, loop_mod.make_train_step
    loop_mod.attach_note_cache = counted(real_attach, passes)
    loop_mod.make_train_step = lambda *a, **k: counted(real_make(*a, **k), steps)
    try:
        torch.manual_seed(SEED)
        model = build_model(cfg, device="cuda", train=True)
        cached = train_model(cfg, model, train_b, val_b, log_fn=log, ckpt_dir=os.path.join(tmp, "cache_run"))
    finally:
        loop_mod.attach_note_cache, loop_mod.make_train_step = real_attach, real_make
    out = {"text_cache_pass": {k: sum(c[k] for c in passes) for k in COUNTED},
           "train_text_cache": {k: sum(c[k] for c in steps) for k in COUNTED}}
    layers = cfg.encoder.bert_layers
    log(f"[text-cache] cache passes {passes}; {len(steps)} steps, launches summed {out['train_text_cache']}")
    require(out["text_cache_pass"] == expected(packed_attention=layers * (64 // 16 + 32 // 16)),
            f"cache pass launches {out['text_cache_pass']}, expected K1 = {layers * 6}")
    require(len(steps) == 4 and all(c == expected(capsule_routing=1) for c in steps), f"cached step launches {steps}")
    del model
    torch.cuda.empty_cache()
    uncached_cfg = flagship_cfg(**{"train.epochs": 1, "train.min_epochs": 0})
    torch.manual_seed(SEED)
    model = build_model(uncached_cfg, device="cuda", train=True)
    plain = train_model(uncached_cfg, model, train_b, val_b, log_fn=lambda line: None)
    log(f"[text-cache] epoch of 64 stays (4 steps, then 32 validation stays): cached {cached.history[0]['sec']:.2f}s "
        f"(train loss {cached.history[0]['train_loss']:.5f}), uncached {plain.history[0]['sec']:.2f}s "
        f"(train loss {plain.history[0]['train_loss']:.5f})")
    del model
    torch.cuda.empty_cache()

    cohort = full_width_cohort(cfg, 16, SEED + 12)
    for ln in ("fp32", "bf16"):
        c = flagship_cfg(**{"encoder.bert_ln": ln})
        torch.manual_seed(SEED)
        model = build_model(c, device="cuda")
        seed_signal(model, "capsule")
        with torch.inference_mode():
            ref = model(batch_to(cohort, dev))
            got = model(batch_to(attach_note_cache(c, model, cohort), dev))
        dp = float(np.abs(probs_from_logits(got.logits.cpu().numpy(), "mort")
                          - probs_from_logits(ref.logits.cpu().numpy(), "mort")).max())
        log(f"[text-cache] cached vs uncached forward, bert_ln={ln}: max|dprob|={dp:.3e} over 16 stays"
            + (f" (tol {E2E_TOL})" if ln == "fp32" else " (the cache's fp32 LayerNorm against the model's bf16 one)"))
        require(ln != "fp32" or dp <= E2E_TOL, "cached and uncached forwards disagree under the same LayerNorm")
        del model
    torch.cuda.empty_cache()

    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    with_cache = attach_note_cache(cfg, model, cohort)
    cap = note_pack_bucket(cfg, cohort)
    ms = {"uncached": timed_steps(step, state, batch_to(cohort, dev), gen, cap),
          "cached": timed_steps(step, state, batch_to(with_cache, dev), gen, 0)}
    log(f"[text-cache] frozen step at batch 16 (3 warm-up, 5 timed): uncached {ms['uncached']:.2f} ms "
        f"(note_pack={cap} of {cohort.chunk_mask.size} chunks, {int(cohort.chunk_mask.sum())} valid), "
        f"cached {ms['cached']:.2f} ms")
    del model, state
    torch.cuda.empty_cache()

    synth = checkpoint_variant(os.path.join(tmp, "cache_run", "final"), os.path.join(tmp, "cache_synth", "final"),
                               "data", "synthetic", True, also=(("data", "synthetic_n", CLI_N),))
    lines, launches = run_cli(["eval", "--ckpt", os.path.dirname(synth), "--drop-table", "--device", "cuda"])
    rows = [line.split()[0] for line in lines if line.split()[:1] and line.split()[0] in
            ("full", "dropL", "dropN", "dropI", "rand1")]
    batches = -(-CLI_N // CLI_BATCH)
    require(rows == ["full", "dropL", "dropN", "dropI", "rand1"] and launches == expected(capsule_routing=6 * batches),
            f"cli eval with the cache: drop-table rows {rows}, launches {launches}")
    out["cli_text_cache_eval"] = launches
    shutil.rmtree(os.path.join(tmp, "cache_run"))
    shutil.rmtree(os.path.join(tmp, "cache_synth"))
    log(f"[text-cache] phase done in {time.perf_counter() - t0:.1f}s")
    return out


def _msgpack_head(n: int, small: int, fix: int, codes: tuple) -> bytes:
    """A msgpack length header in its shortest form: `fix | n` below
    `small`, else the 8- (where `codes` has one), 16- or 32-bit code."""
    if n < small:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I")[3 - len(codes):], (1 << 8, 1 << 16, 1 << 32)[3 - len(codes):]):
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _msgpack(obj, write) -> None:
    """obj as msgpack through `write`, as flax's msgpack_serialize writes
    it (the msgpack package's shortest forms): maps with string keys, nil,
    booleans, integers, floats, strings, bin, and tensors as ext 1 (a
    msgpack array of shape, dtype name and C-order bytes; bfloat16 by
    name)."""
    if obj is None:
        write(b"\xc0")
    elif isinstance(obj, bool):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if -32 <= obj < 128:
            write(struct.pack(">b" if obj < 0 else ">B", obj))
        else:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if obj > 0 else (
                    (0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                try:
                    write(bytes([code]) + struct.pack(fmt, obj))
                    break
                except struct.error:
                    continue
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode()
        write(_msgpack_head(len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, bytes):
        write(_msgpack_head(len(obj), 0, 0, (0xC4, 0xC5, 0xC6)) + obj)
    elif isinstance(obj, dict):
        write(_msgpack_head(len(obj), 16, 0x80, (0xDE, 0xDF)))
        for k in sorted(obj):  # flax rebuilds every dict through jax.tree_util: sorted keys
            _msgpack(str(k), write)
            _msgpack(obj[k], write)
    elif isinstance(obj, (list, tuple)):
        write(_msgpack_head(len(obj), 16, 0x90, (0xDC, 0xDD)))
        for v in obj:
            _msgpack(v, write)
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        bf16 = t.dtype == torch.bfloat16
        name = "bfloat16" if bf16 else t.numpy().dtype.name
        parts = []
        _msgpack([list(t.shape), name, (t.view(torch.int16) if bf16 else t).numpy().tobytes()], parts.append)
        payload = b"".join(parts)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(payload))
        head = bytes([fixext]) if fixext else _msgpack_head(len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
        write(head + b"\x01" + payload)
    else:
        raise TypeError(f"no msgpack form for {type(obj)}")


def flax_tree(model, sd: dict) -> tuple:
    """A state_dict of `model` (or a subset of its parameters) as flax trees
    (params, batch_stats): bridge.py's rules inverted by module type (Dense
    weight [out, in] -> kernel [in, out], Conv OIHW -> HWIO, Embed weight ->
    embedding, LayerNorm / BatchNorm / GroupNorm weight -> scale, BatchNorm
    running statistics -> batch_stats mean / var); other leaves by name."""
    from multimodalrouting_tpu_torch.models.cxr import BatchNorm, Conv, GroupNorm
    from multimodalrouting_tpu_torch.models.layers import Dense, Embed
    from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm

    modules = dict(model.named_modules())
    params, stats = {}, {}
    for key, value in sd.items():
        mod_name, _, leaf = key.rpartition(".")
        mod, tree = modules[mod_name], params
        if leaf in ("running_mean", "running_var"):
            tree, leaf = stats, leaf[len("running_"):]
        elif leaf == "weight" and isinstance(mod, Dense):
            leaf, value = "kernel", value.t()
        elif leaf == "weight" and isinstance(mod, Conv):
            leaf, value = "kernel", value.permute(2, 3, 1, 0)
        elif leaf == "weight" and isinstance(mod, Embed):
            leaf = "embedding"
        elif leaf == "weight" and isinstance(mod, (LayerNorm, BatchNorm, GroupNorm)):
            leaf = "scale"
        for part in mod_name.split("."):
            tree = tree.setdefault(part, {})
        tree[leaf] = value
    return params, stats


def write_flax_checkpoint(ckpt_dir: str, name: str, state, cfg, meta: dict) -> str:
    """`state` as the JAX package's save_checkpoint writes a train state,
    ``<name>.msgpack`` + ``<name>.meta.json``: {step, params, batch_stats,
    opt_state (optax's multi_transform state as a restored tree: tuples and
    NamedTuples keyed by index and field, the Adam moments with empty dicts
    at the masked frozen leaves), ema_params (every leaf: the trainable
    ones' EMA, the frozen ones as they are)}. -> the msgpack's path."""
    model = state.model
    params, stats = flax_tree(model, model.state_dict())
    ema, _ = flax_tree(model, {k: v for k, v in serving_state_dict(state).items() if "running_" not in k})
    named = dict(model.named_parameters())

    def moments(d):
        tree, _ = flax_tree(model, {n: d.get(n, named[n]) for n in named})
        frozen, _ = flax_tree(model, {n: named[n] for n in named if n not in d})

        def mask(t, f):
            return {k: (mask(v, f[k]) if isinstance(v, dict) else {}) if k in f else v for k, v in t.items()}
        return mask(tree, frozen)

    adam = {"count": torch.tensor(state.count, dtype=torch.int32), "mu": moments(state.mu), "nu": moments(state.nu)}
    opt_state = {"inner_states": {"frozen": {"inner_state": {}},
                                  "train": {"inner_state": {"0": {}, "1": adam, "2": {}, "3": {}}}}}
    tree = {"step": torch.tensor(state.step, dtype=torch.int32), "params": params, "batch_stats": stats,
            "opt_state": opt_state, "ema_params": ema}
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.msgpack")
    with open(path, "wb") as f:
        _msgpack(tree, f.write)
    with open(os.path.join(ckpt_dir, f"{name}.meta.json"), "w") as f:
        json.dump({"config": to_dict(cfg), "step": state.step, **meta}, f)
    return path


def background_save(path: str, sync_path: str, sync_secs: float, cfg, state, meta: dict, next_step) -> None:
    """train.ckpt_backend=orbax_async's save of `state`, the state the
    synchronous checkpoint at `sync_path` holds: the loop's blocking time
    (the gather and the host copy), one more train step while the write
    runs, then ckpt.wait_for_saves; every file equals the synchronous
    save's, byte for byte."""
    from multimodalrouting_tpu_torch.ckpt import wait_for_saves

    written = []
    t1 = time.perf_counter()
    save_checkpoint(path, serving_state_dict(state), cfg, train_state=train_state_dict(state), background=True,
                    on_written=lambda p, secs: written.append(secs), **meta)
    blocked = time.perf_counter() - t1
    m = next_step()
    torch.cuda.synchronize()
    stepped = time.perf_counter() - t1
    wait_for_saves()
    landed = time.perf_counter() - t1
    require(m.grad_finite and state.step == 2, "the step during the background write failed")
    differ = []
    for name in ("config.json", "meta.json", "weights.pt", "train_state.pt"):
        with open(os.path.join(path, name), "rb") as f, open(os.path.join(sync_path, name), "rb") as g:
            if f.read() != g.read():
                differ.append(name)
    log(f"[ckpt-async] the loop blocked {blocked:.3f}s (gather and host copy) against {sync_secs:.3f}s for the "
        f"synchronous save; a train step during the write ended at {stepped:.3f}s, the write "
        f"({written[0]:.3f}s in its thread) landed at {landed:.3f}s; files differing from the synchronous "
        f"save: {differ or 'none'}")
    require(not differ, f"the background save differs from the synchronous one in {differ}")
    shutil.rmtree(os.path.dirname(path))


def check_zstd_codec(model) -> None:
    """The orbax reader's codec on this machine: pyarrow's zstd is there,
    and utils/orbax_reader's frame decoder takes back a frame pyarrow
    compresses here (one BERT weight's bytes; the size stated in the frame
    and, as in a large B-tree node, streamed)."""
    import pyarrow as pa

    from multimodalrouting_tpu_torch.utils.orbax_reader import zstd_content_size, zstd_decompress

    require(pa.Codec.is_available("zstd"), f"pyarrow {pa.__version__} has no zstd codec")
    w = model.state_dict()["encoders.bbert.bert.layer_0.intermediate.weight"]
    payload = w.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    frame = pa.Codec("zstd", compression_level=1).compress(payload, asbytes=True)
    t1 = time.perf_counter()
    sized = zstd_decompress(frame)
    secs = time.perf_counter() - t1
    streamed = pa.CompressedInputStream(pa.BufferReader(frame), "zstd").read()
    log(f"[orbax-reader] pyarrow {pa.__version__}: zstd frame of {len(payload) / 1e6:.1f} MB "
        f"({len(frame) / 1e6:.1f} MB compressed, stated size {zstd_content_size(frame)}) decoded in "
        f"{secs * 1e3:.1f} ms; round trip exact: {sized == payload and streamed == payload}")
    require(sized == payload and streamed == payload, "the zstd frame did not round-trip")


def phase_jax_ckpt(dev, tmp: str) -> dict:
    """A JAX-package checkpoint on the card with no JAX: the full-width
    flagship's frozen-default train state (bf16 BERT body) after one step,
    written in flax's msgpack layout (write_flax_checkpoint) and as a port
    checkpoint of the same state. The reader's time and rate;
    Predictor(dir, name=...) at 16 records (K1 = 12, K3 = 1) bit-identical to
    the port checkpoint's; `cli eval --ckpt DIR --name NAME`; and one `cli
    train --resume` step from each, which must continue the step counter and
    give bit-identical train states. Between them, a background save of the
    same state (background_save) and the orbax reader's codec
    (check_zstd_codec). -> {path: launches}."""
    import importlib.util

    from multimodalrouting_tpu_torch.bridge import state_dict_from_jax
    from multimodalrouting_tpu_torch.utils.flax_msgpack import read_msgpack

    t0 = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("jax", "flax", "msgpack", "ml_dtypes", "orbax", "tensorstore", "pyarrow")}
    log(f"[jax-ckpt] on this machine's import path (found by importlib, none imported): {found}")
    cfg = flagship_cfg()
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    seed_signal(model, "capsule")
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED + 13)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    step, batch, cap = make_train_step(cfg, model), batch_to(cohort, dev), note_pack_bucket(cfg, cohort)
    m = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap)
    require(m.grad_finite and state.step == 1, "the step before the checkpoint failed")
    port_root, jax_root = os.path.join(tmp, "port_ckpt"), os.path.join(tmp, "jax_ckpt")
    meta = {"temperature": 1.25, "thresholds": [0.4]}
    t1 = time.perf_counter()
    save_checkpoint(os.path.join(port_root, "last"), serving_state_dict(state), cfg, train_state=train_state_dict(state),
                    **meta)
    sync_secs = time.perf_counter() - t1
    t1 = time.perf_counter()
    path = write_flax_checkpoint(jax_root, "last", state, cfg, meta)
    size = os.path.getsize(path)
    log(f"[jax-ckpt] {path}: {size / 1e9:.3f} GB written in {time.perf_counter() - t1:.2f}s")
    t1 = time.perf_counter()
    tree = read_msgpack(path)
    secs = time.perf_counter() - t1
    log(f"[jax-ckpt] read_msgpack: {secs:.3f}s, {size / 1e9 / secs:.2f} GB/s")
    bert = tree["params"]["encoders"]["bbert"]["bert"]["layer_0"]["intermediate"]["kernel"]
    require(bert.dtype == torch.bfloat16, f"the frozen BERT body was written as {bert.dtype}")
    back = state_dict_from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]}, model)
    require(all(torch.equal(back[k], v.cpu()) for k, v in model.state_dict().items()),
            "the flax tree does not map back onto the model's state_dict")
    del tree, back
    background_save(os.path.join(tmp, "async_ckpt", "last"), os.path.join(port_root, "last"), sync_secs, cfg, state,
                    meta, lambda: step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap))
    check_zstd_codec(model)
    del model, state, batch
    torch.cuda.empty_cache()

    records = serving_records(cfg)
    port = Predictor(os.path.join(port_root, "last"), device="cuda")
    ref = port.predict(batch_from_records(cfg, records))
    del port
    torch.cuda.empty_cache()
    jax_pred = Predictor(jax_root, name="last", device="cuda")
    jax_pred.predict(batch_from_records(cfg, records[:2]))
    torch.cuda.synchronize()
    reset_counts()
    got = jax_pred.predict(batch_from_records(cfg, records))
    torch.cuda.synchronize()
    out = {"serving_jax_ckpt": read_counts()}
    require(out["serving_jax_ckpt"] == expected(packed_attention=cfg.encoder.bert_layers, capsule_routing=1),
            f"JAX-checkpoint serving launches {out['serving_jax_ckpt']}")
    same = all(np.array_equal(got[k], ref[k]) for k in ("probs", "alpha", "r_matrix"))
    log(f"[jax-ckpt] Predictor(name='last') vs the port checkpoint, 16 records: bit-identical={same}, "
        f"temperature={jax_pred.temperature}, launches {out['serving_jax_ckpt']}")
    require(same, "the JAX checkpoint serves other probabilities than the port checkpoint of the same state")
    del jax_pred
    torch.cuda.empty_cache()

    # the CLI reads synthetic-cohort configs: the same msgpack under a meta
    # whose config is the synthetic cohort's
    os.link(path, os.path.join(jax_root, "cli.msgpack"))
    cli_cfg = apply_overrides(cfg, {"data.synthetic": True, "data.synthetic_n": CLI_N})
    with open(os.path.join(jax_root, "cli.meta.json"), "w") as f:
        json.dump({"config": to_dict(cli_cfg), "step": 1, **meta}, f)
    lines, launches = run_cli(["eval", "--ckpt", jax_root, "--name", "cli", "--device", "cuda"])
    metrics = json.loads("\n".join(lines[lines.index("{"): lines.index("}") + 1]))
    require(np.isfinite(metrics["auroc"]) and metrics["temperature"] == 1.25, f"cli eval --name cli: {metrics}")
    out["cli_jax_ckpt_eval"] = launches

    yaml = os.path.join(ROOT, "configs", "trimodal_mort.yaml")
    states = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two resumes must give the same bits
    try:
        for label, root in (("jax", jax_root), ("port", port_root)):
            dst = os.path.join(tmp, f"resumed_{label}")
            lines, _ = run_cli(["train", "--family", "capsule", "--task", "mort", "--routes", "10", "--config", yaml,
                                "--resume", root, "--out", dst, "--epochs", "2", "--device", "cuda",
                                *set_args(f"data.synthetic_n={CLI_BATCH}", f"train.batch_size={CLI_BATCH}",
                                          "train.min_epochs=0", "train.ckpt_every=0")])
            require(f"[resume] {root}/last at step 1" in lines, f"cli resume from the {label} checkpoint: no step 1")
            states[label] = torch.load(os.path.join(dst, "final", "train_state.pt"), map_location="cpu",
                                       weights_only=True)
            require(states[label]["step"] == 2, f"resumed from {label}: step {states[label]['step']}, expected 2")
            shutil.rmtree(dst)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = states["jax"], states["port"]
    diff = [f"{part}.{k}" for part in ("model", "mu", "nu", "ema") for k in b[part]
            if not torch.equal(a[part][k], b[part][k])]
    log(f"[jax-ckpt] one resumed step from each: step {a['step']} / {b['step']}, "
        f"{len(diff)} of {sum(len(b[p]) for p in ('model', 'mu', 'nu', 'ema'))} tensors differ")
    require(not diff, f"the resumed updates differ: {diff[:4]}")
    shutil.rmtree(jax_root)
    shutil.rmtree(port_root)
    log(f"[jax-ckpt] phase done in {time.perf_counter() - t0:.1f}s")
    return out


# --- DenseNet-121, pretrained encoder weights (F3), the unimodal trainers -----

DENSENET = {"encoder.vision_backbone": "densenet121"}


def densenet_step(cfg, dev, label: str, steps: int = 3) -> dict:
    """One training step of the DenseNet flagship at batch 16 with the launch
    counters read around it (K1 = 12, K3 = 1, and K2 = 12 with fine-tuned
    notes), every one of the 121 BatchNorms committing new running
    statistics; then `steps` timed steps, the peak memory and one step's
    profile, on the flagship training phase's cohort (seed SEED, so the
    note pack and the BERT work are the same as there). -> launches."""
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    cohort = full_width_cohort(cfg, cfg.train.batch_size, SEED)
    cap = note_pack_bucket(cfg, cohort)
    log(f"[densenet] {label}: note_pack={cap} of {cohort.chunk_mask.size} chunks "
        f"({int(cohort.chunk_mask.sum())} valid)")
    batch = batch_to(cohort, dev)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    bns = {name: mod for name, mod in model.named_modules() if isinstance(mod, BatchNorm)}
    before = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
    torch.cuda.synchronize()
    reset_counts()
    m = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[densenet] {label} step: loss={float(m.loss):.5f} launches {launches}")
    require(np.isfinite(float(m.loss)) and m.grad_finite, f"densenet {label} step: non-finite loss or gradient")
    finetune = cfg.encoder.finetune_text
    expect = expected(packed_attention=12, packed_attention_bwd=12 if finetune else 0, capsule_routing=1)
    require(launches == expect, f"densenet {label} step launches {launches}, expected {expect}")
    stale = [n for n, mod in bns.items()
             if torch.equal(mod.running_mean, before[n][0]) or torch.equal(mod.running_var, before[n][1])]
    require(len(bns) == 121 and not stale, f"densenet {label}: {len(bns)} BatchNorms, stale statistics in {stale[:4]}")
    torch.cuda.reset_peak_memory_stats()
    ms = timed_steps(step, state, batch, gen, cap, warmup=1, steps=steps)
    log(f"[densenet] {label} step at batch 16 (1 warm-up, {steps} timed): step_ms={ms:.1f} "
        f"stays_per_s={cfg.train.batch_size * 1e3 / ms:.2f} "
        f"peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"all {len(bns)} BatchNorms committed new running statistics")
    profile_step(lambda: step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap),
                 f"one densenet {label} training step", top=10)
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


def phase_densenet(dev, tmp: str) -> dict:
    """The flagship on DenseNet-121 (encoder.vision_backbone=densenet121,
    MedFuse's default CXR backbone) at full width: a seeded checkpoint
    served at 1 and 16 records against fp32 on the CPU with its batch-16
    profile and peak memory (serve_family: K1 = 12, K3 = 1 per forward), one
    frozen and one fine-tuned step (densenet_step: K2 = 12 on the second;
    every BatchNorm commits new statistics; step times), and one batch-16
    forward under encoder.vision_norm=group. -> {path: launches}."""
    t0 = time.perf_counter()
    cfg = flagship_cfg(**DENSENET)
    out = {"serving_densenet": serve_family("densenet", "capsule", cfg, tmp),
           "train_densenet_frozen": densenet_step(cfg, dev, "frozen"),
           "train_densenet_finetune": densenet_step(flagship_cfg(**DENSENET, **{"encoder.finetune_text": True}),
                                                    dev, "fine-tuned")}
    group = flagship_cfg(**DENSENET, **{"encoder.vision_norm": "group"})
    ckpt = os.path.join(tmp, "densenet_group")
    family_checkpoint(ckpt, group, "capsule")
    predictor = Predictor(ckpt, device="cuda")
    records = serving_records(group)
    predictor.predict_records(records[:2])
    torch.cuda.synchronize()
    reset_counts()
    rows = predictor.predict_records(records)
    torch.cuda.synchronize()
    out["serving_densenet_group"] = read_counts()
    check_rows("densenet group batch16", rows, 16)
    require(out["serving_densenet_group"] == expected(packed_attention=12, capsule_routing=1),
            f"densenet group serving launches {out['serving_densenet_group']}")
    log(f"[densenet] vision_norm=group: batch-16 forward served, launches {out['serving_densenet_group']}")
    del predictor
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)
    log(f"[densenet] phase done in {time.perf_counter() - t0:.1f}s")
    return out


def hf_bert_state_dict(e, seed: int) -> dict:
    """A seeded state_dict in HF BertModel's layout at the encoder's dims,
    the pooler included (nothing is downloaded)."""
    g = torch.Generator().manual_seed(seed)
    h, i = e.bert_hidden, e.bert_intermediate

    def rnd(*shape, scale: float = 0.02):
        return torch.randn(shape, generator=g) * scale

    sd = {"embeddings.word_embeddings.weight": rnd(e.bert_vocab_size, h),
          "embeddings.position_embeddings.weight": rnd(e.bert_max_position, h),
          "embeddings.token_type_embeddings.weight": rnd(e.bert_type_vocab, h),
          "embeddings.LayerNorm.weight": 1 + rnd(h, scale=0.1), "embeddings.LayerNorm.bias": rnd(h)}
    for layer in range(e.bert_layers):
        p = f"encoder.layer.{layer}"
        for name, (d_out, d_in) in {"attention.self.query": (h, h), "attention.self.key": (h, h),
                                    "attention.self.value": (h, h), "attention.output.dense": (h, h),
                                    "intermediate.dense": (i, h), "output.dense": (h, i)}.items():
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = rnd(d_out, d_in), rnd(d_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = 1 + rnd(h, scale=0.1), rnd(h)
    sd["pooler.dense.weight"], sd["pooler.dense.bias"] = rnd(h, h), rnd(h)
    return sd


def torchvision_densenet121_state_dict(seed: int) -> dict:
    """A seeded state_dict in torchvision's densenet121 layout (its key names
    and shapes, the classifier and num_batches_tracked included)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, c_out, c_in, k):
        sd[f"{name}.weight"] = torch.randn(c_out, c_in, k, k, generator=g) * (2.0 / (c_in * k * k)) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("features.conv0", 64, 3, 7)
    bn("features.norm0", 64)
    c = 64
    for i, n_layers in enumerate((6, 12, 24, 16), start=1):
        for j in range(1, n_layers + 1):
            base = f"features.denseblock{i}.denselayer{j}"
            bn(f"{base}.norm1", c)
            conv(f"{base}.conv1", 128, c, 1)
            bn(f"{base}.norm2", 128)
            conv(f"{base}.conv2", 32, 128, 3)
            c += 32
        if i < 4:
            bn(f"features.transition{i}.norm", c)
            conv(f"features.transition{i}.conv", c // 2, c, 1)
            c //= 2
    bn("features.norm5", c)
    sd["classifier.weight"], sd["classifier.bias"] = 0.01 * torch.randn(1000, c, generator=g), torch.zeros(1000)
    return sd


def phase_pretrained(dev, tmp: str) -> dict:
    """encoder.bert_weights / encoder.vision_weights on the card (fault F3):
    a seeded BERT-base HF BertModel state_dict and a torchvision densenet121
    one, torch.save()d; train_model over 32 + 16 stays of the DenseNet
    flagship with both keys set, the model and EMA captured as the train
    state is created: the BERT weights (held in bf16 under the frozen-text
    default), the DenseNet weights and BatchNorm statistics must equal the
    files after the cast bit for bit, and the EMA too; both [pretrained] log
    lines. Then `cli train --init-from` that run's checkpoint with both keys
    still set must not apply them again. -> {path: launches}."""
    import multimodalrouting_tpu_torch.train.loop as loop_mod
    from multimodalrouting_tpu_torch.models.clinbert import import_hf_bert_params
    from multimodalrouting_tpu_torch.models.cxr import import_torchvision_backbone_params

    t0 = time.perf_counter()
    e = flagship_cfg(**DENSENET).encoder
    bert_sd, tv_sd = hf_bert_state_dict(e, SEED), torchvision_densenet121_state_dict(SEED + 1)
    bert_path, vision_path = os.path.join(tmp, "bio_clinicalbert.pt"), os.path.join(tmp, "densenet121.pt")
    torch.save(bert_sd, bert_path)
    torch.save(tv_sd, vision_path)
    log(f"[pretrained] wrote {bert_path} ({os.path.getsize(bert_path)} bytes) and {vision_path} "
        f"({os.path.getsize(vision_path)} bytes) in {time.perf_counter() - t0:.1f}s")
    keys = (f"encoder.bert_weights={bert_path}", f"encoder.vision_weights={vision_path}")
    cfg = flagship_cfg(**DENSENET, **{"encoder.bert_weights": bert_path, "encoder.vision_weights": vision_path,
                                      "train.epochs": 1, "train.min_epochs": 0, "train.ckpt_every": 0})
    snap, lines = {}, []
    create = loop_mod.create_train_state

    def capture(cfg_, model_, **kw):
        state = create(cfg_, model_, **kw)
        snap["model"] = {k: v.detach().clone() for k, v in model_.state_dict().items()}
        snap["ema"] = {k: v.clone() for k, v in state.ema.items()}
        return state

    def log_line(line: str) -> None:
        lines.append(line)
        log(line)

    run_dir = os.path.join(tmp, "pretrained_run")
    loop_mod.create_train_state = capture
    try:
        torch.manual_seed(SEED)
        model = build_model(cfg, device="cuda", train=True)
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        result = train_model(cfg, model, full_width_cohort(cfg, 32, SEED + 12), full_width_cohort(cfg, 16, SEED + 13),
                             log_fn=log_line, ckpt_dir=run_dir)
        torch.cuda.synchronize()
    finally:
        loop_mod.create_train_state = create
    out = {"train_pretrained": read_counts()}
    log(f"[pretrained] train_model: {len(result.history)} epoch in {time.perf_counter() - t1:.1f}s, "
        f"launches {out['train_pretrained']}")
    require(f"[pretrained] note encoder <- {bert_path}" in lines
            and f"[pretrained] vision backbone <- {vision_path}" in lines, "train_model logged no [pretrained] lines")
    # 2 frozen steps, the epoch's validation forward and the calibration forward
    require(out["train_pretrained"] == expected(packed_attention=4 * e.bert_layers, capsule_routing=4),
            f"train_model launches {out['train_pretrained']}")
    want = {f"encoders.bbert.bert.{k}": v for k, v in import_hf_bert_params(bert_sd, e.bert_layers).items()}
    want.update({f"encoders.imgenc.backbone.{k}": v
                 for k, v in import_torchvision_backbone_params(tv_sd, "densenet121").items()})
    got = snap["model"]
    differ = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v.to(got[k].dtype))]
    in_ema = [k for k in want if k in snap["ema"]]
    ema_differ = [k for k in in_ema if not torch.equal(snap["ema"][k].cpu(), want[k].to(snap["ema"][k].dtype))]
    backbone_params = [k for k in want if k.startswith("encoders.imgenc.") and not k.endswith(("running_mean",
                                                                                                "running_var"))]
    dtypes = sorted({str(got[k].dtype) for k in want if k.startswith("encoders.bbert.")})
    log(f"[pretrained] at init: {len(want)} tensors compared bit for bit ({len(want) - len(backbone_params)} BERT "
        f"in {dtypes} and BatchNorm statistics, {len(backbone_params)} DenseNet parameters), {len(differ)} differ; "
        f"EMA: {len(in_ema)} tensors, {len(ema_differ)} differ")
    require(not differ, f"weights at init differ from the files: {differ[:4]}")
    require(sorted(in_ema) == sorted(backbone_params) and not ema_differ, f"the EMA at init differs: {ema_differ[:4]}")
    del model, result, snap
    torch.cuda.empty_cache()

    dst = os.path.join(tmp, "cli_pretrained")
    yaml = os.path.join(ROOT, "configs", "trimodal_mort.yaml")
    cli_lines, launches = run_cli(["train", "--family", "capsule", "--task", "mort", "--routes", "10", "--config", yaml,
                                   "--out", dst, "--epochs", "1", "--device", "cuda", "--init-from", run_dir,
                                   *set_args(*CLI_ONCE, "encoder.vision_backbone=densenet121", *keys)])
    require(not any("[pretrained]" in line for line in cli_lines), "cli train --init-from applied the files again")
    require(launches["capsule_routing"] > 0 and launches["packed_attention"] == 0, f"cli launches {launches}")
    out["cli_init_from_pretrained"] = launches
    shutil.rmtree(run_dir)
    shutil.rmtree(dst)
    log(f"[pretrained] phase done in {time.perf_counter() - t0:.1f}s")
    return out


def unimodal_reports(label: str, out_dir: str, tasks) -> None:
    """unimodal_metrics.json and fairness.json: every task, finite losses,
    AUROCs and EDDIs."""
    with open(os.path.join(out_dir, "unimodal_metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out_dir, "fairness.json")) as f:
        fair = json.load(f)
    numbers = [h[k] for h in metrics["history"] for k in ("train_loss", "val_loss")]
    numbers += [metrics["metrics"][t]["auroc"] for t in tasks]
    numbers += [fair[t]["combined_eddi"] for t in tasks]
    numbers += [fair[t]["attributes"]["sens"]["eddi_overall"] for t in tasks]
    require(metrics["tasks"] == list(tasks) and sorted(fair) == sorted(tasks) and bool(np.isfinite(numbers).all()),
            f"{label}: bad reports {metrics['tasks']}, {sorted(fair)}, {numbers}")
    log(f"[unimodal] {label}: " + ", ".join(f"{t} AUROC {metrics['metrics'][t]['auroc']:.4f}" for t in tasks)
        + f"; {len(metrics['history'])} epochs, last val loss {metrics['history'][-1]['val_loss']:.4f}")


def phase_unimodal(dev, tmp: str) -> dict:
    """The unimodal trainers on the card, each writing its reports:
    train_unimodal on behrt / multitask (the stratified re-split) and behrt /
    readmit (the focal loss), two epochs each; the note trainer at full width
    (BERT-base over 8 x 512 chunks, 64 + 32 + 32 stays, batch 16), then its
    encoder's build and its embedding pass, each timed alone: K1 = 12 per
    minibatch, 96 in all, in the trainer and in the pass (the fit launches
    none); train_omop and train_ct on the CLI's synthetic cohorts; then `cli unimodal` in-process
    for all four modalities at the CLI's shapes (notes clipped to 128
    tokens), no kernel launched. -> {path: launches}."""
    from multimodalrouting_tpu_torch.data.batches import concat_batches, take_batch
    from multimodalrouting_tpu_torch.data.stratified import stratified_three_way
    from multimodalrouting_tpu_torch.train import unimodal as uni

    t0 = time.perf_counter()
    cfg = flagship_cfg(**{"train.epochs": 2, "train.batch_size": 16})
    e, t = cfg.encoder, cfg.train
    out = {}
    for label, task in (("behrt_multitask", "multitask"), ("behrt_readmit", "readmit")):
        splits = [make_synthetic_cohort(n, t=e.structured_seq_len, f=e.structured_n_feats, s=2, l=16, image_size=32,
                                        vocab_size=e.bert_vocab_size, seed=SEED + 20 + i, task=task)
                  for i, n in enumerate((64, 32, 32))]
        if task == "multitask":
            pooled = concat_batches(splits)
            splits = [take_batch(pooled, idx) for idx in stratified_three_way(np.asarray(pooled.y), seed=t.seed)]
        dst = os.path.join(tmp, f"uni_{label}")
        torch.cuda.synchronize()
        reset_counts()
        res = uni.train_unimodal(cfg, *splits, modality="behrt", task=task, out_dir=dst, log_fn=log, device="cuda")
        torch.cuda.synchronize()
        out[f"unimodal_{label}"] = read_counts()
        require(len(res.history) == 2 and out[f"unimodal_{label}"] == expected(),
                f"{label}: {len(res.history)} epochs, launches {out[f'unimodal_{label}']}")
        unimodal_reports(label, dst, list(res.metrics))

    notes = [full_width_cohort(cfg, n, SEED + 30 + i) for i, n in enumerate((64, 32, 32))]
    minibatches = sum(-(-b.batch_size // t.batch_size) for b in notes)
    stays = sum(b.batch_size for b in notes)
    dst = os.path.join(tmp, "uni_note")
    torch.cuda.synchronize()
    reset_counts()
    res = uni.train_unimodal(cfg, *notes, modality="note", out_dir=dst, log_fn=log, device="cuda")
    torch.cuda.synchronize()
    out["unimodal_note"] = read_counts()
    unimodal_reports("note", dst, list(res.metrics))
    # the embedding pass alone: all of the trainer's K1 launches, so the fit made none.
    # The encoder's build (a CPU init under the seed, then the copy to the card)
    # is timed apart from the pass.
    t1 = time.perf_counter()
    enc = uni._note_encoder(cfg, t.seed, "cuda")
    torch.cuda.synchronize()
    build_secs = time.perf_counter() - t1
    reset_counts()
    t1 = time.perf_counter()
    embs = uni._embed_notes(enc, notes, t.batch_size)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    out["unimodal_note_embeddings"] = read_counts()
    del enc
    log(f"[unimodal] full-width note embeddings: {stays} stays in {minibatches} minibatches of {t.batch_size} x "
        f"{e.notes_max_chunks} x {e.text_max_len} tokens in {secs:.3f}s, {stays / secs:.1f} stays/s, launches "
        f"{out['unimodal_note_embeddings']}; the encoder's build apart {build_secs:.3f}s; "
        f"the whole trainer {out['unimodal_note']}")
    k1 = expected(packed_attention=e.bert_layers * minibatches)
    require(out["unimodal_note_embeddings"] == k1 and out["unimodal_note"] == k1,
            f"note trainer launches {out['unimodal_note']}, its embedding pass {out['unimodal_note_embeddings']}: "
            f"expected K1 = {e.bert_layers * minibatches} in the pass and none in the fit")
    require([x.shape for x in embs] == [(b.batch_size, e.d) for b in notes]
            and all(np.isfinite(x).all() for x in embs), "bad note embeddings")
    del notes, embs

    for label, split, train in (("omop", port_cli.synthetic_omop_split, uni.train_omop),
                                ("ct", port_cli.synthetic_ct_split, uni.train_ct)):
        dst = os.path.join(tmp, f"uni_{label}")
        kw = {"vocab_sizes": (64, 48, 56)} if label == "omop" else {"backbone": e.vision_backbone}
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        res = train(port_cli.synthetic_splits(cfg, split), hidden=cfg.model.d, lr=t.lr,
                    weight_decay=t.weight_decay, batch_size=t.batch_size, epochs=t.epochs,
                    patience=t.early_stop_patience, seed=t.seed, out_dir=dst, log_fn=log, device="cuda", **kw)
        torch.cuda.synchronize()
        out[f"unimodal_{label}"] = read_counts()
        log(f"[unimodal] {label}: {len(res.history)} epochs in {time.perf_counter() - t1:.1f}s")
        require(out[f"unimodal_{label}"] == expected(), f"{label} launches {out[f'unimodal_{label}']}")
        unimodal_reports(label, dst, list(res.metrics))

    yaml = os.path.join(ROOT, "configs", "trimodal_mort.yaml")
    for modality, extra in (("behrt", ["--task", "multitask"]), ("behrt", ["--task", "readmit"]), ("note", []),
                            ("omop", []), ("ct", [])):
        dst = os.path.join(tmp, f"cli_uni_{modality}{''.join(extra[1:])}")
        lines, launches = run_cli(["unimodal", "--modality", modality, *extra, "--config", yaml, "--out", dst,
                                   "--epochs", "2", "--device", "cuda",
                                   *set_args(f"data.synthetic_n={CLI_N}", f"train.batch_size={CLI_BATCH}")])
        summary = json.loads(lines[-1])
        require(sorted(summary) == ["auroc", "modality", "out_dir", "tasks"] and summary["modality"] == modality
                and all(np.isfinite(summary["auroc"][k]) for k in summary["tasks"]) and launches == expected(),
                f"cli unimodal {modality} {extra}: {summary}, launches {launches}")
        require(("[stratify] multilabel-stratified split" in " ".join(lines)) == ("multitask" in extra),
                f"cli unimodal {modality} {extra}: stratification")
        unimodal_reports(f"cli {modality} {' '.join(extra)}".strip(), dst, summary["tasks"])
        out[f"cli_unimodal_{modality}{''.join(extra[1:])}"] = launches
    log(f"[unimodal] phase done in {time.perf_counter() - t0:.1f}s")
    return out


# --- serving artifacts, the int8 BERT body, the interpretability sweep -------

# the JAX package's interpret CSV columns (audit/sweep.py:sweep_to_rows)
SWEEP_COLUMNS = ["logit", "uc", "bi", "ti", "block_uni", "block_bi", "block_tri"] + [
    f"{key}__{route}" for route in ("L", "N", "I", "LN", "LI", "NI", "LNI")
    for key in ("gate", "route_contrib", "route_emb_norm")]


def flagship_records(cfg, n: int = 16) -> list:
    """`n` records of the flagship training phase's cohort (seed SEED)."""
    return records_from_cohort(full_width_cohort(cfg, n, SEED), n)


def counted_call(fn):
    """fn() with the launch counters read around exactly it -> (result, counts)."""
    torch.cuda.synchronize()
    reset_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, read_counts()


def output_diff(got: dict, ref: dict) -> dict:
    """max |got - ref| of each served array both carry."""
    return {k: float(np.abs(np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64)).max())
            for k in ("probs", "alpha", "r_matrix") if k in ref}


def timed_requests(label: str, predict_records, records, singles: int = 20) -> None:
    """Host-clock latency of `singles` single-record requests and 5 of 16
    records."""
    single, batch = [], []
    for i in range(singles):
        t = time.perf_counter()
        predict_records(records[i % 16 : i % 16 + 1])
        single.append((time.perf_counter() - t) * 1e3)
    for _ in range(5):
        t = time.perf_counter()
        predict_records(records)
        batch.append((time.perf_counter() - t) * 1e3)
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    log(f"[artifact] {label}: single-record p50_ms={pct(single, 50):.2f} p95_ms={pct(single, 95):.2f}; "
        f"batch-16 p50_ms={pct(batch, 50):.2f} p95_ms={pct(batch, 95):.2f} "
        f"stays_per_s={16e3 * len(batch) / sum(batch):.2f}")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)


def cli_checkpoint(family: str, tmp: str, name: str) -> str:
    """A seeded `family` checkpoint at the CLI's synthetic shapes (notes of 128
    tokens, images of 96^2, CLI_N stays a split) under DIR/final -> DIR."""
    cfg = load_cfg(os.path.join(ROOT, "configs", "trimodal_mort.yaml"),
                   overrides={"data.synthetic_n": CLI_N, "train.batch_size": CLI_BATCH}, environ={})
    out = os.path.join(tmp, name)
    family_checkpoint(os.path.join(out, "final"), cfg, family)
    return out


def phase_artifact(dev, tmp: str) -> dict:
    """Serving artifacts (artifact.py) of the full-width flagship, batch 16:
    exported on the card (time, bytes) and served by ExportedPredictor at 1
    and 16 records against the live Predictor on the same forward (<= 1e-6,
    bit-identity logged), K1 = 12 and K3 = 1 per call (a single record pads
    to one call of the static batch); p50 / p95 of both; one HTTP request;
    the same weights exported on the CPU (platforms cpu,cuda) and served on
    the card through the kernels (K1 = 12, K3 = 1, within E2E_TOL); an
    export under MMR_ATTN=splash (K4b = 12 per call); `cli predict
    --export-artifact` then `--artifact` at the CLI's shapes (K3 only).
    -> {path: launches}."""
    from multimodalrouting_tpu_torch.artifact import ExportedPredictor, export_serving_artifact

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "artifact_flagship")  # phase_int8 reads it too, then deletes it
    cfg = flagship_checkpoint(ckpt)
    layers = cfg.encoder.bert_layers
    one_call = expected(packed_attention=layers, capsule_routing=1)
    live = Predictor(ckpt, device="cuda")
    records = flagship_records(cfg)
    batch16, batch1 = batch_from_records(cfg, records), batch_from_records(cfg, records[:1])
    out = {}

    def export(predictor, name: str, platforms=None):
        dst = os.path.join(tmp, name)
        t = time.perf_counter()
        _, launches = counted_call(lambda: export_serving_artifact(predictor, dst, platforms=platforms))
        secs = time.perf_counter() - t
        require(launches == expected(), f"export launched {launches}: tracing must run no kernel")
        t = time.perf_counter()
        ex = ExportedPredictor(dst, device="cuda")
        ex.predict_records(records[:2])  # warm-up
        torch.cuda.synchronize()
        log(f"[artifact] {name}: exported on {predictor.device.type} in {secs:.1f}s, {dir_bytes(dst)} bytes, "
            f"platforms {ex.platforms}, attention={ex.attention}; loaded and warmed on the card in "
            f"{time.perf_counter() - t:.1f}s")
        return ex, dst

    live.predict_records(records[:2])
    ex, dst = export(live, "artifact_card")
    require(ex.attention == "packed", f"the card export traced attention={ex.attention}")
    got16, out["artifact_card"] = counted_call(lambda: ex.predict(batch16))
    got1, out["artifact_card_single"] = counted_call(lambda: ex.predict(batch1))
    log(f"[artifact] launches: 16 records {out['artifact_card']}, 1 record {out['artifact_card_single']}")
    require(out["artifact_card"] == one_call and out["artifact_card_single"] == one_call,
            f"artifact launches {out['artifact_card']}, {out['artifact_card_single']}: expected {one_call} a call")
    ref16 = live.predict(batch16)
    rerun = output_diff(live.predict(batch16), ref16)
    # the live forward of the single record's padded batch (its row repeated), as the artifact pads it
    ref1 = {k: v[:1] for k, v in live.predict(batch_from_records(cfg, records[:1] * live.batch_size)).items()}
    log(f"[artifact] live Predictor run to run at 16 records: max|d| {rerun}")
    for label, got, ref in (("16 records", got16, ref16), ("1 record", got1, ref1)):
        d = output_diff(got, ref)
        same = all(v == 0.0 for v in d.values())
        log(f"[artifact] {label}: ExportedPredictor vs the live Predictor's forward of the same batch: max|d| {d} "
            f"({'bit-identical' if same else 'not bit-identical'}; tol 1e-6)")
        require(max(d.values()) <= 1e-6, f"{label}: the artifact disagrees with the live Predictor")
    d = output_diff(got1, live.predict(batch1))
    log(f"[artifact] 1 record, artifact (padded to batch 16) vs the live batch-1 forward: max|d| {d} (tol {E2E_TOL})")
    require(max(d.values()) <= E2E_TOL, "the padded single record disagrees with the batch-1 forward")
    timed_requests("live Predictor", live.predict_records, records)
    timed_requests("ExportedPredictor", ex.predict_records, records, singles=10)  # each pads to 16: ~0.33 s
    check_rows("artifact http", http_roundtrip(ex, records[:2])["predictions"], 2)
    del ex
    shutil.rmtree(dst)

    cpu_live = Predictor(ckpt, device="cpu")
    ex, dst = export(cpu_live, "artifact_cpu", platforms=("cpu", "cuda"))
    del cpu_live
    require(ex.platforms == ["cpu", "cuda"], f"meta.json platforms {ex.platforms}")
    got, out["artifact_cpu_export"] = counted_call(lambda: ex.predict(batch16))
    d = output_diff(got, ref16)
    log(f"[artifact] exported on the CPU, served on the card: launches {out['artifact_cpu_export']}, "
        f"max|d| against the live card Predictor {d} (tol {E2E_TOL})")
    require(out["artifact_cpu_export"] == one_call, f"CPU-exported artifact launches {out['artifact_cpu_export']}")
    require(max(d.values()) <= E2E_TOL, "the CPU-exported artifact disagrees on the card")
    del ex
    shutil.rmtree(dst)

    before = os.environ.get("MMR_ATTN")
    os.environ["MMR_ATTN"] = "splash"
    try:
        ex, dst = export(live, "artifact_splash")
    finally:
        if before is None:
            os.environ.pop("MMR_ATTN")
        else:
            os.environ["MMR_ATTN"] = before
    require(ex.attention == "splash", f"the splash export traced attention={ex.attention}")
    got, out["artifact_splash"] = counted_call(lambda: ex.predict(batch16))
    d = output_diff(got, ref16)
    log(f"[artifact] exported under MMR_ATTN=splash (BERT depth {layers}): launches {out['artifact_splash']}, "
        f"max|d| against the default live Predictor {d} (tol {E2E_TOL})")
    require(out["artifact_splash"] == expected(splash_attention=layers, capsule_routing=1),
            f"splash artifact launches {out['artifact_splash']}")
    require(max(d.values()) <= E2E_TOL, "the splash artifact disagrees with the default forward")
    del ex, live
    shutil.rmtree(dst)
    torch.cuda.empty_cache()

    cli_ckpt = cli_checkpoint("capsule", tmp, "artifact_cli")
    art = os.path.join(tmp, "artifact_cli_art")
    _, launches = run_cli(["predict", "--ckpt", cli_ckpt, "--export-artifact", art, "--device", "cuda"])
    require(launches == expected() and os.path.exists(os.path.join(art, "program.pt2")), "cli export")
    served = {}
    for flag, src in (("--artifact", art), ("--ckpt", cli_ckpt)):
        path = os.path.join(tmp, f"predictions{flag}.jsonl")
        _, launches = run_cli(["predict", flag, src, "--out", path, "--device", "cuda"])
        with open(path) as f:
            served[flag] = [json.loads(line)["probs"] for line in f]
        out[f"cli_predict{flag.replace('--', '_')}"] = launches
        require(launches == expected(capsule_routing=-(-CLI_N // CLI_BATCH)), f"cli predict {flag} launches {launches}")
    d = float(np.abs(np.asarray(served["--artifact"]) - np.asarray(served["--ckpt"])).max())
    log(f"[artifact] cli predict --artifact vs --ckpt over {len(served['--ckpt'])} stays: max|dprob|={d:.3e}")
    require(len(served["--artifact"]) == CLI_N and np.allclose(served["--artifact"], served["--ckpt"], rtol=1e-5,
                                                                 atol=1e-6), "cli predict --artifact disagrees")
    shutil.rmtree(cli_ckpt)
    shutil.rmtree(art)
    log(f"[artifact] phase done in {time.perf_counter() - t0:.1f}s")
    return out


INT8_GEMM = re.compile(r"gemm_s8|s8s8|igemm|imma|int8", re.IGNORECASE)


def phase_int8(dev, tmp: str) -> dict:
    """The flagship with encoder.int8_text=true (the frozen BERT body's six
    matmuls a layer as int8 products, ops/quant.py) on phase_artifact's
    checkpoint: served at 1 and 16 records (K1 = 12, K3 = 1 per forward),
    |dprob| against the same weights in fp32 on the CPU without int8, the
    CLS cosine of 16 chunks against the bf16 body (> 0.995, the JAX
    package's bound), and the batch-16 forward's profile beside the bf16
    body's, the int8 GEMMs by name. -> {path: launches}."""
    t0 = time.perf_counter()
    base = os.path.join(tmp, "artifact_flagship")
    ckpt = checkpoint_variant(base, os.path.join(tmp, "int8"), "encoder", "int8_text", True)
    cfg = load_config(ckpt)
    layers = cfg.encoder.bert_layers
    p8 = Predictor(ckpt, device="cuda")
    bert8 = p8.model.encoders.bbert.bert
    require(type(bert8.layer_0.intermediate).__name__ == "QuantDense"
            and bert8.layer_0.intermediate.weight.dtype == torch.float32, "the int8 body is not built")
    records = flagship_records(cfg)
    p8.predict_records(records[:2])
    rows1, c1 = counted_call(lambda: p8.predict_records(records[:1]))
    rows16, c16 = counted_call(lambda: p8.predict_records(records))
    out = {"int8_serving": c16, "int8_serving_single": c1}
    log(f"[int8] launches: 1 record {c1}, 16 records {c16}")
    require(c1 == c16 == expected(packed_attention=layers, capsule_routing=1), "int8 forward launches")
    check_rows("int8 single", rows1, 1)
    check_rows("int8 batch16", rows16, 16)

    ref_dir = checkpoint_variant(base, os.path.join(tmp, "int8_ref_fp32"), "model", "dtype", "float32")
    t1 = time.perf_counter()
    ref = Predictor(ref_dir, device="cpu").predict_records(records[:2])
    bf16 = Predictor(base, device="cuda")
    for label, rows in (("int8", rows16[:2]), ("bf16", bf16.predict_records(records[:2]))):
        dp = max(abs(float(np.asarray(g["probs"]).reshape(-1)[0]) - float(np.asarray(r["probs"]).reshape(-1)[0]))
                 for g, r in zip(rows, ref))
        da = max(abs(g["alpha"][k] - r["alpha"][k]) for g, r in zip(rows, ref) for k in r["alpha"])
        log(f"[int8] card {label} body vs CPU fp32 without int8 over 2 records: max|dprob|={dp:.3e} "
            f"max|dalpha|={da:.3e} (tol {E2E_TOL})")
        require(dp <= E2E_TOL and da <= E2E_TOL, f"the {label} forward disagrees with fp32 on the CPU")
    log(f"[int8] CPU fp32 reference in {time.perf_counter() - t1:.1f}s")

    cohort = full_width_cohort(cfg, 16, SEED)
    valid = np.flatnonzero(cohort.chunk_mask.reshape(-1) > 0)[:16]
    ids = torch.from_numpy(cohort.note_ids.reshape(-1, cohort.note_ids.shape[-1])[valid]).to(dev)
    attn = torch.from_numpy(cohort.note_attn.reshape(-1, cohort.note_attn.shape[-1])[valid]).to(dev)
    with torch.inference_mode():
        h8 = bert8(ids, attn)[:, 0].float()
        hb = bf16.model.encoders.bbert.bert(ids, attn)[:, 0].float()
    cos = ((h8 * hb).sum(-1) / (h8.norm(dim=-1) * hb.norm(dim=-1) + 1e-9)).cpu().numpy()
    log(f"[int8] CLS cosine against the bf16 body over {len(valid)} chunks: min {cos.min():.6f} mean {cos.mean():.6f}")
    require(float(cos.min()) > 0.995, "int8 CLS states drift from the bf16 body")

    batch16 = batch_from_records(cfg, records)
    times = {}
    for label, pred in (("int8", p8), ("bf16", bf16)):
        log(f"[int8] batch-16 forward of the {label} body:")
        by_name = profile_forward(pred, batch16, top=8)
        times[label] = sum(ms for _, ms in by_name.values())
        if label == "int8":
            gemms = {name: v for name, v in by_name.items() if INT8_GEMM.search(name)}
            for name, (n, ms) in sorted(gemms.items(), key=lambda kv: -kv[1][1]):
                log(f"[int8] int8 GEMM kernel {ms:9.3f} ms x{n:<4d} {name[:110]}")
            require(gemms, "no int8 GEMM kernel in the int8 forward's profile")
    log(f"[int8] batch-16 forward device busy: int8 {times['int8']:.2f} ms, bf16 {times['bf16']:.2f} ms")
    del p8, bf16, bert8
    torch.cuda.empty_cache()
    for d in (ckpt, ref_dir, base):
        shutil.rmtree(d)
    log(f"[int8] phase done in {time.perf_counter() - t0:.1f}s")
    return out


def phase_interpret(dev, tmp: str) -> dict:
    """The interpretability sweep (audit/sweep.py) on a seeded full-width
    gated-concat checkpoint (learned gate): a 16-record forward (K1 = 12, K3
    = 0), then gated_model_sweep over its pooled outputs with 20 fixed
    permutations (no kernel): its logits equal to the model's, f(obs) = G +
    UC + BI + TI to fp32 rounding, and logits, gates, route contributions
    and UC/BI/TI against the fp32 sweep of the same weights on the CPU over
    the same pooled outputs and permutations (gates within E2E_TOL, the
    logit-valued arrays within E2E_TOL of the logits' scale); then `cli interpret
    --out-csv` at the CLI's shapes (no kernel) with the JAX package's
    columns. -> {path: launches}."""
    import csv

    from multimodalrouting_tpu_torch.audit.attribution import compute_uc_bi_ti, draw_permutations
    from multimodalrouting_tpu_torch.audit.sweep import gated_model_sweep, head_forward_from_pooled
    from multimodalrouting_tpu_torch.routes import ROUTES_7, route_mask_from_presence

    t0 = time.perf_counter()
    cfg = flagship_cfg(**{"model.gate_mode": "learned"})
    ckpt = os.path.join(tmp, "interpret_gated")
    family_checkpoint(ckpt, cfg, "gated_concat")
    pred = Predictor(ckpt, "gated_concat", device="cuda")
    cohort = full_width_cohort(cfg, 16, SEED)
    pred.forward(cohort)
    fwd, launches = counted_call(lambda: pred.forward(cohort))
    out = {"interpret_forward": launches}
    require(launches == expected(packed_attention=cfg.encoder.bert_layers), f"gated forward launches {launches}")
    has = [torch.from_numpy(getattr(cohort, f)).to(dev) for f in ("has_l", "has_n", "has_i")]
    avail = route_mask_from_presence(*has, ROUTES_7)
    perms = draw_permutations(16, 20, torch.Generator().manual_seed(SEED))
    t1 = time.perf_counter()
    sweep, out["interpret_sweep"] = counted_call(
        lambda: gated_model_sweep(cfg, pred.model, fwd.pooled, avail=avail, permutations=perms))
    log(f"[interpret] sweep of 16 stays, 20 draws in {time.perf_counter() - t1:.2f}s, launches {out['interpret_sweep']}")
    require(out["interpret_sweep"] == expected(), "the sweep launched a kernel")
    d = float(np.abs(sweep["logits"] - fwd.logits.float().cpu().numpy()).max())
    log(f"[interpret] sweep logits vs the model's: max|d|={d:.3e}")
    require(d <= 1e-6, "the sweep's logits differ from the model's")

    calls = []  # each call's first-label logits, as the sweep's f returns them

    def f(l, n, i):
        calls.append(head_forward_from_pooled(cfg, pred.model, l, n, i, avail)[0][:, 0].float())
        return calls[-1]

    with torch.inference_mode():
        zl, zn, zi = (fwd.pooled[k] for k in ("L", "N", "I"))
        uc, bi, ti = compute_uc_bi_ti(f, zl, zn, zi, permutations=perms)
        full, draws = calls[0], calls[1:]
        g = full * 0.0
        for vals in draws:
            g = g + vals[:16]  # E_all: the first of each draw's seven
        g = g / len(draws)
        resid = float((full - (g + uc + bi + ti)).abs().max())
    same = all(np.array_equal(sweep[k], x.cpu().numpy()) for k, x in (("uc", uc), ("bi", bi), ("ti", ti)))
    scale = float(full.abs().max())
    log(f"[interpret] f(obs) - (G + UC + BI + TI): max|.|={resid:.3e} (|f| up to {scale:.3f}; tol 1e-5 x max(1, |f|)); "
        f"UC/BI/TI recomputed {'bit-identical' if same else 'NOT bit-identical'} to the sweep's")
    require(resid <= 1e-5 * max(1.0, scale) and same, "the UC/BI/TI identity does not hold on the card")

    ref_dir = checkpoint_variant(ckpt, os.path.join(tmp, "interpret_gated_fp32"), "model", "dtype", "float32")
    t1 = time.perf_counter()
    ref_pred = Predictor(ref_dir, "gated_concat", device="cpu")
    pooled = {k: v.float().cpu() for k, v in fwd.pooled.items()}
    ref = gated_model_sweep(ref_pred.cfg, ref_pred.model, pooled, avail=avail.cpu(), permutations=perms)
    # gates are shares (E2E_TOL as served probabilities); the logit-valued
    # arrays carry bf16's ~3 significant digits of the logits' own scale
    scale = max(1.0, float(np.abs(ref["logits"]).max()))
    diffs = {k: float(np.abs(sweep[k] - ref[k]).max()) for k in ("logits", "gates", "route_contrib", "uc", "bi", "ti")}
    limits = {k: E2E_TOL * (1.0 if k == "gates" else scale) for k in diffs}
    log(f"[interpret] card bf16 sweep vs the CPU fp32 sweep of the same weights, pooled outputs and permutations "
        f"({time.perf_counter() - t1:.1f}s): max|d| {diffs}; limits: gates {E2E_TOL}, the logit-valued arrays "
        f"{E2E_TOL} x max(1, max|logit|) = {limits['logits']:.4f}")
    require(all(diffs[k] <= limits[k] for k in diffs), "the card sweep disagrees with the CPU fp32 sweep")
    del pred, ref_pred, fwd
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)
    shutil.rmtree(ref_dir)

    cli_ckpt = cli_checkpoint("gated_concat", tmp, "interpret_cli")
    path = os.path.join(tmp, "interpret.csv")
    lines, launches = run_cli(["interpret", "--ckpt", cli_ckpt, "--out-csv", path, "--device", "cuda"])
    with open(path) as fh:
        table = list(csv.reader(fh))
    require(table[0] == SWEEP_COLUMNS and len(table) == 1 + CLI_N and launches == expected()
            and any(line.startswith("block means:") for line in lines),
            f"cli interpret: header {table[0][:4]}..., {len(table) - 1} rows, launches {launches}")
    out["cli_interpret"] = launches
    shutil.rmtree(cli_ckpt)
    log(f"[interpret] phase done in {time.perf_counter() - t0:.1f}s")
    return out


# --- the data layer: raw csv.gz -> cli etl -> cli train | eval | predict ----

# the 17 canonical variables' dictionary rows (data/varmap.py:VAR_CFG's
# patterns), each with a plausible value range and unit
CHART_ITEMS = (  # (itemid, label, abbreviation, unit, low, high)
    (220045, "Heart Rate", "HR", "bpm", 55, 130),
    (220179, "Systolic Blood Pressure", "NBPs", "mmHg", 85, 170),
    (220180, "Diastolic Blood Pressure", "NBPd", "mmHg", 40, 95),
    (220181, "Mean Blood Pressure", "NBPm", "mmHg", 55, 115),
    (220210, "Respiratory Rate", "RR", "insp/min", 10, 32),
    (223762, "Temperature Celsius", "Temp C", "°C", 35.5, 39.5),
    (220277, "O2 saturation pulseoxymetry", "SpO2", "%", 86, 100),
)
LAB_ITEMS = (  # (itemid, label, unit, low, high)
    (50983, "Sodium", "mEq/L", 128, 150), (50971, "Potassium", "mEq/L", 3.0, 5.6),
    (50902, "Chloride", "mEq/L", 94, 112), (50882, "Bicarbonate", "mEq/L", 16, 32),
    (51006, "Urea Nitrogen", "mg/dL", 6, 60), (50912, "Creatinine", "mg/dL", 0.5, 4.0),
    (50931, "Glucose", "mg/dL", 70, 260), (51221, "Hematocrit", "%", 22, 48),
    (51301, "White Blood Cells", "K/uL", 3, 22), (51265, "Platelet Count", "K/uL", 60, 420),
)
NOTE_WORDS = ("patient", "admitted", "with", "acute", "on", "chronic", "respiratory", "failure", "and", "sepsis",
              "blood", "pressure", "stable", "overnight", "metoprolol", "mg", "po", "bid", "prn", "iv", "daily",
              "dose", "history", "of", "no", "known", "drug", "allergies", "intubated", "sedated", "lungs",
              "clear", "bilateral", "infiltrates", "effusion", "cxr", "shows", "improved", "worsened", "plan",
              "continue", "monitor", "lactate", "creatinine", "urine", "output", "fluids", "pressors",
              "weaned", "extubated", "tolerating", "diet", "family", "meeting", "goals", "care", "the", "a")
DATA_PATIENTS = 192


def write_raw_mimic_dump(d: str, seed: int, n: int = DATA_PATIENTS) -> dict:
    """A raw MIMIC-IV-style csv.gz dump under `d`, from `seed` with numpy,
    as tests/test_etl.py builds one but at a cohort's mix: `n` patients
    (~95% adults), ICU stays of 50-240 h (~8% shorter than 48 h), ~12%
    in-hospital deaths after the observation window, ICD-9 diagnoses,
    d_items / d_labitems rows for all 17 canonical variables with chart
    events every ~2 h and lab events every ~8 h over the first 50 h, notes
    of ~300-4,000 words in 1-3 parts (~10% of admissions without one,
    de-identification brackets included) and CXR metadata (one study in the
    first 48 h) for about half of the patients. -> counts of what it wrote."""
    import pandas as pd

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = pd.Timestamp("2150-01-01")
    sid, hadm, stay = np.arange(n) + 10000, np.arange(n) + 20000, np.arange(n) + 30000
    intime = base + pd.to_timedelta(rng.integers(0, 24 * 365, n), "h")
    los_h = np.where(rng.random(n) < 0.08, rng.uniform(20, 47, n), rng.uniform(50, 240, n))
    outtime = intime + pd.to_timedelta(np.round(los_h * 60), "m")
    dead = rng.random(n) < 0.12
    frames = {
        "patients": pd.DataFrame({"subject_id": sid, "gender": rng.choice(["M", "F"], n), "anchor_year": 2150,
                                  "anchor_age": np.where(rng.random(n) < 0.05, rng.integers(15, 18, n),
                                                         rng.integers(18, 91, n))}),
        "icustays": pd.DataFrame({"subject_id": sid, "hadm_id": hadm, "stay_id": stay, "intime": intime,
                                  "outtime": outtime}),
        "admissions": pd.DataFrame({"subject_id": sid, "hadm_id": hadm, "admittime": intime - pd.Timedelta(hours=6),
                                    "dischtime": outtime + pd.Timedelta(hours=30),
                                    "deathtime": pd.Series(outtime).where(dead), "hospital_expire_flag": dead.astype(int)}),
        "diagnoses_icd": pd.DataFrame({"hadm_id": np.repeat(hadm, 2), "icd_version": 9,
                                       "icd_code": rng.choice(["4280", "49121", "5849", "0389", "4019"], 2 * n)}),
        "d_items": pd.DataFrame([{"itemid": i, "label": lab, "abbreviation": ab, "linksto": "chartevents",
                                  "unitname": u} for i, lab, ab, u, _, _ in CHART_ITEMS]),
        "d_labitems": pd.DataFrame([{"itemid": i, "label": lab, "fluid": "Blood", "unitname": u}
                                    for i, lab, u, _, _ in LAB_ITEMS]).assign(fluid="blood"),
    }
    ce, le = [], []
    for k in range(n):
        hours = np.arange(0.0, 50.0, 2.0) + rng.uniform(0, 1.5, 25)
        for i, _, _, u, lo, hi in CHART_ITEMS:
            ce.append(pd.DataFrame({"stay_id": stay[k], "itemid": i, "valueuom": u,
                                    "charttime": intime[k] + pd.to_timedelta(np.round(hours * 60), "m"),
                                    "valuenum": np.round(rng.uniform(lo, hi, len(hours)), 1)}))
        hours = np.arange(1.0, 50.0, 8.0) + rng.uniform(0, 3, 7)
        for i, _, u, lo, hi in LAB_ITEMS:
            le.append(pd.DataFrame({"hadm_id": hadm[k], "itemid": i, "valueuom": u,
                                    "charttime": intime[k] + pd.to_timedelta(np.round(hours * 60), "m"),
                                    "valuenum": np.round(rng.uniform(lo, hi, len(hours)), 2)}))
    frames["chartevents"], frames["labevents"] = pd.concat(ce), pd.concat(le)
    notes = []
    for k in np.flatnonzero(rng.random(n) >= 0.10):
        words = int(rng.uniform(300, 4000))
        parts = np.array_split(rng.choice(NOTE_WORDS, words), int(rng.integers(1, 4)))
        for j, part in enumerate(parts):
            text = " ".join(part) + f". Seen by [**Doctor {k}**] on [**2150-01-0{j + 1}**]."
            notes.append({"hadm_id": hadm[k], "charttime": intime[k] + pd.Timedelta(hours=float(rng.uniform(1, 46))),
                          "text": text})
    frames["notes"] = pd.DataFrame(notes)
    with_cxr = np.flatnonzero(rng.random(n) < 0.5)
    study = intime[with_cxr] + pd.to_timedelta(np.round(rng.uniform(1, 46, len(with_cxr)) * 60), "m")
    frames["cxr_metadata"] = pd.DataFrame({
        "subject_id": sid[with_cxr], "study_id": 50000000 + with_cxr, "dicom_id": [f"d{k:05d}cxr" for k in with_cxr],
        "StudyDate": study.strftime("%Y%m%d").astype(int), "StudyTime": study.strftime("%H%M%S").astype(float)})
    for name, df in frames.items():
        df.to_csv(os.path.join(d, f"{name}.csv.gz"), index=False, compression="gzip")
    return {name: len(df) for name, df in frames.items()}


def write_cxr_jpegs(export_dir: str, image_root: str, seed: int, size: int = 320) -> int:
    """A size^2 grayscale JPEG at every exported cxr_path under `image_root`
    (MIMIC-CXR-JPG's layout) -> how many."""
    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    n = 0
    for p in pd.read_parquet(os.path.join(export_dir, "images_48h.parquet"))["cxr_path"]:
        if isinstance(p, str) and p:
            full = os.path.join(image_root, p)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            lungs = 120 + 60 * np.cos((xx - size / 2) / size * 6) * np.exp(-((yy - size / 2) / size) ** 2 * 4)
            arr = np.clip(lungs + rng.normal(0, 18, (size, size)), 0, 255).astype(np.uint8)
            Image.fromarray(arr, mode="L").save(full, format="JPEG", quality=90)
            n += 1
    return n


def write_impressions(d: str, seed: int, n: int = 96) -> tuple:
    """An INSPECT impressions CSV of `n` patients (1-2 impressions each, a few
    hundred words over a written vocab.txt's words) and that vocab.txt, in
    BERT's special-token layout -> (csv path, vocab path)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    pieces = ["##s", "##ed", "##ing", "##al", "##ly", "##ion"]
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += sorted(set(NOTE_WORDS) | {"pulmonary", "embolism", "segmental", "artery", "filling", "defect",
                                        "scan", "no", "evidence", "emboli", "right", "left", "lobe", ".", ","}) + pieces
    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(tokens) + "\n")
    rows = []
    for pid in range(n):
        pe = int(pid % 2)
        for r in range(1 + int(rng.random() < 0.4)):
            head = "filling defect in segmental pulmonary artery emboli seen" if pe else "no evidence of emboli"
            words = " ".join(rng.choice(NOTE_WORDS, int(rng.integers(200, 700))))
            rows.append({"person_id": pid, "impression_text": f"{head} . {words} , scan {r} .",
                         "pe_positive_nlp": pe, "1_month_mortality": int(rng.random() < 0.3),
                         "12_month_PH": int(rng.random() < 0.2), "year_of_birth": int(2130 - rng.integers(20, 95))})
    csv = os.path.join(d, "radiology_impressions_with_all_labels.csv.gz")
    pd.DataFrame(rows).to_csv(csv, index=False, compression="gzip")
    return csv, vocab


def write_medfuse_tree(d: str, seed: int, per_split: int = 12) -> str:
    """A MedFuse benchmark directory (phenotyping: listfiles and per-stay
    timeseries CSVs; val stays under train/, as MedFuse lays them) -> its
    root."""
    rng = np.random.default_rng(seed)
    root = os.path.join(d, "ehr")
    classes = ("Acute renal failure", "Septicemia", "Shock")
    for folder in ("train", "test"):
        os.makedirs(os.path.join(root, "phenotyping", folder))
    sid = 1000
    for split in ("train", "val", "test"):
        folder = "test" if split == "test" else "train"
        lines = ["stay,period_length,stay_id," + ",".join(classes)]
        for k in range(per_split):
            name = f"{sid}_episode1_timeseries.csv"
            hours = np.sort(rng.uniform(0, 47, 30))
            with open(os.path.join(root, "phenotyping", folder, name), "w") as f:
                f.write("Hours,Heart Rate,Glascow coma scale total\n")
                f.writelines(f"{h:.2f},{rng.uniform(60, 110):.1f},{rng.integers(3, 16)}\n" for h in hours)
            lines.append(f"{name},48.0,{sid}," + ",".join(str(int(x)) for x in rng.random(3) < 0.3))
            sid += 1
        with open(os.path.join(root, "phenotyping", f"{split}_listfile.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "channels.json"), "w") as f:
        json.dump({"id_to_channel": ["Heart Rate", "Glascow coma scale total"],
                   "is_categorical_channel": {"Heart Rate": False, "Glascow coma scale total": True},
                   "possible_values": {"Glascow coma scale total": [str(v) for v in range(3, 16)]},
                   "normal_values": {"Heart Rate": "86", "Glascow coma scale total": "15"}}, f)
    return root


def write_inspect_tree(d: str, seed: int, n: int = 64) -> list:
    """INSPECT's cohort inputs (metadata / mapping / labels / splits as TSV,
    impressions, an OMOP condition table) -> `cli etl inspect`'s arguments."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "omop"))
    imp = np.arange(n) + 1
    study = pd.Timestamp("2130-01-01") + pd.to_timedelta(rng.integers(0, 3000, n), "D")
    for name, df in (
        ("metadata", pd.DataFrame({"impression_id": imp, "modality": "CT"})),
        ("mapping", pd.DataFrame({"impression_id": imp, "person_id": imp + 700,
                                  "procedure_DATETIME": study.strftime("%Y-%m-%d")})),
        ("labels", pd.DataFrame({"impression_id": imp, "person_id": imp + 700, "pe_positive_nlp": imp % 2,
                                 "1_month_mortality": (rng.random(n) < 0.2).astype(int)})),
        ("splits", pd.DataFrame({"impression_id": imp[: n // 2], "split_name": rng.choice(["test", "valid"], n // 2)})),
    ):
        df.to_csv(os.path.join(d, f"{name}.tsv"), sep="\t", index=False)
    pd.DataFrame({"impression_id": imp, "impressions": ["PE seen" if i % 2 else "clear" for i in imp]}).to_csv(
        os.path.join(d, "impressions.csv"), index=False)
    m = 8 * n
    pd.DataFrame({"person_id": rng.choice(imp + 700, m), "condition_concept_id": rng.integers(100, 400, m),
                  "condition_start_DATETIME": (pd.Timestamp("2129-06-01") + pd.to_timedelta(
                      rng.integers(0, 3600, m), "D")).strftime("%Y-%m-%d")}).to_csv(
        os.path.join(d, "omop", "condition_occurrence.csv"), index=False)
    return [a for k in ("metadata", "mapping", "labels", "splits") for a in (f"--{k}", os.path.join(d, f"{k}.tsv"))] + [
        "--impressions", os.path.join(d, "impressions.csv"), "--omop-dir", os.path.join(d, "omop")]


def timed_cli(label: str, argv: list) -> tuple:
    """run_cli(argv) -> (lines, launches, seconds)."""
    t0 = time.perf_counter()
    lines, launches = run_cli(argv)
    secs = time.perf_counter() - t0
    log(f"[data] {label}: {secs:.2f}s")
    return lines, launches, secs


def phase_data(dev, tmp: str) -> dict:
    """The data layer on the card: a raw MIMIC-style csv.gz dump
    (write_raw_mimic_dump, DATA_PATIENTS patients) through `cli etl varmap |
    cohort | export --max-len 512 --max-chunks 8` (timed, stays/s, the
    tokenizer the export chose, the native binner), 320^2 JPEGs at the
    exported paths, then `cli train` of the flagship (configs/trimodal_mort
    .yaml at full width on the export's 24 x 17 labs, one epoch): K1 = 12
    and K3 = 1 per forward and per frozen step, nothing else; `cli eval
    --drop-table` and `cli predict --split test` (one row per test stay,
    each with its stay_id); has_i exactly where a JPEG decoded, with
    non-zero pixels; load_split's time; a frozen step at the export's note
    pack, timed; one streaming epoch (data.stream=true, the identity
    sampler) whose stream holds exactly the dense train split's stays, with
    the same launch counts; prefetch_to_device bit-equal to batch_to over the
    dense split's batches, both timed; the INSPECT note driver (`cli unimodal
    --impressions-csv --vocab`, the native WordPiece built by g++ here) at
    512 x 8 (K1 = 12 per embedding minibatch); then `cli etl medfuse |
    inspect | legacy` on small written trees (rows, s, no kernel).
    -> {path: launches}."""
    import pandas as pd

    from multimodalrouting_tpu_torch.data import images as image_io
    from multimodalrouting_tpu_torch.data import native_binner, streaming
    from multimodalrouting_tpu_torch.data.batches import slice_batch
    from multimodalrouting_tpu_torch.data.loader import prefetch_to_device

    t0 = time.perf_counter()
    out, none = {}, expected()
    raw, work = os.path.join(tmp, "data_raw"), os.path.join(tmp, "data")
    t1 = time.perf_counter()
    wrote = write_raw_mimic_dump(raw, SEED + 40)
    log(f"[data] raw dump of {DATA_PATIENTS} patients in {time.perf_counter() - t1:.2f}s: {wrote}")

    # --- ETL, in-process through the CLI ---
    varmap, cohort, export, images = (os.path.join(work, x) for x in ("varmap.csv", "cohort", "export", "cxr"))
    lines, launches, secs = timed_cli("etl varmap", ["etl", "varmap", "--data-dir", raw, "--out", varmap])
    summary = json.loads(lines[-1])
    require(summary["variables"] == 17 and launches == none, f"etl varmap: {summary}, launches {launches}")
    lines, launches, secs = timed_cli("etl cohort", [
        "etl", "cohort", "--data-dir", raw, "--out", cohort, "--varmap", varmap,
        "--cxr-meta", os.path.join(raw, "cxr_metadata.csv.gz"), "--notes", os.path.join(raw, "notes.csv.gz")])
    summary = json.loads(lines[-1])
    stays = summary["stays"]
    require(native_binner._LIB is not None, "etl cohort did not load the native binner (build/native/libbinner.so)")
    require(stays > 0.75 * DATA_PATIENTS and launches == none, f"etl cohort: {summary}, launches {launches}")
    log(f"[data] etl cohort: {stays} stays {summary['splits']}, {stays / secs:.1f} stays/s, native binner")
    lines, launches, secs = timed_cli("etl export", ["etl", "export", "--cohort", cohort, "--out", export,
                                                     "--max-len", "512", "--max-chunks", "8"])
    chosen = [line for line in lines if line.startswith("[tokenizer]")]
    require(len(chosen) == 1 and launches == none, f"etl export: tokenizer lines {chosen}, launches {launches}")
    log(f"[data] etl export: {stays / secs:.1f} stays/s; {chosen[0]}")
    notes = pd.read_parquet(os.path.join(export, "notes_48h.parquet"))
    struct = pd.read_parquet(os.path.join(export, "structured_48h.parquet"))
    require(int(struct["bin"].max()) + 1 == 24 and struct.shape[1] == 2 + 17, f"structured {struct.shape}")
    log(f"[data] note chunks per stay: {notes['n_chunks'].value_counts().sort_index().to_dict()} "
        f"(shape {notes['shape_s'].iloc[0]} x {notes['shape_l'].iloc[0]})")
    t1 = time.perf_counter()
    n_jpeg = write_cxr_jpegs(export, images, SEED + 41)
    log(f"[data] {n_jpeg} JPEGs (320^2 grayscale) written in {time.perf_counter() - t1:.2f}s")

    # --- the flagship on the export ---
    yaml = os.path.join(ROOT, "configs", "trimodal_mort.yaml")
    sets = set_args("data.synthetic=false", f"data.data_root={export}", f"data.image_root={images}",
                    "encoder.structured_n_feats=17", "encoder.structured_seq_len=24", "train.epochs=1",
                    "train.min_epochs=0", "train.ckpt_every=0")
    cfg = load_cfg(yaml, overrides=dict(kv.split("=", 1) for kv in sets[1::2]), environ={})
    bs = cfg.train.batch_size
    with open(os.path.join(export, "splits.json")) as f:
        split_ids = {k: [int(x) for x in v] for k, v in json.load(f).items()}
    n_tr, n_va, n_te = (len(split_ids[k]) for k in ("train", "val", "test"))
    steps, val_b, test_b = n_tr // bs, -(-n_va // bs), -(-n_te // bs)
    run_dir = os.path.join(work, "run")
    train = ["train", "--family", "capsule", "--task", "mort", "--routes", "10", "--config", yaml, "--out", run_dir,
             "--device", "cuda", *sets]

    def per_forward(k3: int) -> dict:
        return expected(packed_attention=12 * k3, capsule_routing=k3)

    # the host seconds spent decoding and transforming images, per command
    decode = {"s": 0.0, "n": 0}
    real_loader = image_io.make_image_loader

    def timed_loader(*args, **kw):
        load = real_loader(*args, **kw)

        def timed(row):
            t = time.perf_counter()
            try:
                return load(row)
            finally:
                decode["s"] += time.perf_counter() - t
                decode["n"] += 1
        return timed

    image_io.make_image_loader = timed_loader
    try:
        lines, launches, secs = timed_cli("cli train", train)
    finally:
        image_io.make_image_loader = real_loader
    summary = json.loads(lines[-1])
    with open(os.path.join(run_dir, "history.json")) as f:
        epoch = json.load(f)[0]
    ckpt = [line for line in lines if line.startswith("[ckpt] final")]
    log(f"[data] train: {n_tr} stays, {steps} frozen steps of {bs}, epoch {epoch['sec']:.2f}s "
        f"({steps * bs / epoch['sec']:.1f} stays/s), train_loss {epoch['train_loss']:.5f}; {ckpt}; "
        f"{decode['n']} image rows decoded in {decode['s']:.3f}s, all in load_split before the epoch "
        f"({100 * decode['s'] / secs:.1f}% of the command)")
    require(np.isfinite(epoch["train_loss"]) and np.isfinite(summary["best_val_auroc"]), f"cli train: {summary}")
    require(launches == per_forward(steps + 2 * val_b),
            f"cli train launches {launches}, expected K3 = {steps} steps + 2 x {val_b} validation forwards, "
            f"K1 = 12 per forward")
    out["data_train"] = launches

    lines, launches, secs = timed_cli("cli eval --drop-table", ["eval", "--ckpt", run_dir, "--drop-table",
                                                                "--device", "cuda"])
    rows = [line.split()[0] for line in lines if line.split()[:1] and line.split()[0] in
            ("full", "dropL", "dropN", "dropI", "rand1")]
    n_full = (n_te // bs) * bs or n_te
    require(rows == ["full", "dropL", "dropN", "dropI", "rand1"]
            and launches == per_forward(test_b + 5 * -(-n_full // bs)), f"cli eval: rows {rows}, launches {launches}")
    out["data_eval"] = launches

    preds_path = os.path.join(work, "predictions_test.jsonl")
    lines, launches, secs = timed_cli("cli predict --split test", ["predict", "--ckpt", run_dir, "--split", "test",
                                                                   "--out", preds_path, "--device", "cuda"])
    with open(preds_path) as f:
        preds = [json.loads(line) for line in f]
    require([p["stay_id"] for p in preds] == split_ids["test"] and all(0.0 <= p["probs"] <= 1.0 for p in preds),
            f"cli predict: {len(preds)} rows for {n_te} test stays, or stay ids out of order")
    require(launches == per_forward(test_b), f"cli predict launches {launches}")
    out["data_predict"] = launches
    shutil.rmtree(os.path.join(run_dir, "final"))  # ~1 GB of train state, read by eval and predict

    # has_i exactly where a JPEG decoded; load_split's time per split
    image_rows = pd.read_parquet(os.path.join(export, "images_48h.parquet")).set_index("stay_id")
    dense = {}
    for split in ("train", "test"):
        t1 = time.perf_counter()
        dense[split], sids = port_cli._load_split(cfg, "mort", split)
        secs = time.perf_counter() - t1
        b = dense[split]
        jpeg = np.array([isinstance(image_rows.loc[s, "cxr_path"], str)
                         and os.path.exists(os.path.join(images, image_rows.loc[s, "cxr_path"])) for s in sids])
        pix = np.abs(np.asarray(b.image, np.float32)).reshape(len(sids), -1).sum(1)
        require(np.array_equal(np.asarray(b.has_i) > 0, jpeg) and bool((pix[jpeg] > 0).all())
                and bool((pix[~jpeg] == 0).all()), f"{split}: has_i differs from the decoded JPEGs")
        log(f"[data] load_split {split}: {len(sids)} stays in {secs:.2f}s ({len(sids) / secs:.1f} stays/s), "
            f"{int(jpeg.sum())} images decoded, {int(np.asarray(b.has_n).sum())} with notes, "
            f"image {b.image.dtype} {tuple(b.image.shape[1:])}")

    # the frozen step at the export's note pack (the first 16 train stays)
    sub = slice_batch(dense["train"], 0, bs)
    cap = note_pack_bucket(cfg, sub)
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    ms = timed_steps(step, state, batch_to(sub, dev), gen, cap, warmup=2, steps=5)
    log(f"[data] frozen step at the export's pack: {ms:.2f} ms, note_pack={cap} of {sub.chunk_mask.size} chunk "
        f"slots ({int(sub.chunk_mask.sum())} valid), as the flagship training phase's cohort packs 96")
    del model, state, step
    torch.cuda.empty_cache()

    # prefetch_to_device against batch_to over the dense split's batches
    batches = [slice_batch(dense["train"], i, bs) for i in range(0, steps * bs, bs)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = [batch_to(b, dev) for b in batches]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3 / len(batches)
    t1 = time.perf_counter()
    fetched = list(prefetch_to_device(iter(batches), size=2, device=dev))
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t1) * 1e3 / len(batches)
    same = all((g is None and r is None) or (g.dtype == r.dtype and torch.equal(g, r))
               for got, ref in zip(fetched, plain) for g, r in zip(got, ref))
    require(len(fetched) == len(plain) and same, "prefetch_to_device differs from batch_to")
    log(f"[data] prefetch_to_device: {len(batches)} batches bit-equal to batch_to; {pre_ms:.3f} ms a batch "
        f"against batch_to's {plain_ms:.3f} ms ({sum(t.numel() * t.element_size() for t in plain[0] if t is not None) / 1e6:.1f} MB a batch)")
    del plain, fetched, batches, dense

    # one streaming epoch: the same command with data.stream=true
    calls, pulled = [], []
    real = streaming.iter_split_batches

    def recording(*args, **kw):
        calls.append((args, kw))
        for batch, sids in real(*args, **kw):
            pulled.extend(int(s) for s in sids)
            yield batch, sids

    streaming.iter_split_batches = recording
    image_io.make_image_loader = timed_loader
    decode.update(s=0.0, n=0)
    try:
        lines, launches, secs = timed_cli("cli train data.stream=true",
                                          [*train, *set_args("data.stream=true", "train.sampler_mode=none")])
    finally:
        streaming.iter_split_batches = real
        image_io.make_image_loader = real_loader
    decoded = dict(decode)  # the command's own, before the replay below decodes again
    shutil.rmtree(os.path.join(run_dir, "final"))
    (args, kw), = calls
    stream = [int(s) for _, sids in real(*args, **{**kw, "drop_remainder": False, "stats": None}) for s in sids]
    require(sorted(stream) == sorted(split_ids["train"]) and len(set(stream)) == len(stream)
            and pulled == stream[:len(pulled)] and len(pulled) == steps * bs,
            f"streaming epoch: {len(stream)} stays streamed ({len(set(stream))} distinct) for {n_tr} train stays, "
            f"{len(pulled)} pulled")
    require(launches == per_forward(steps + 2 * val_b), f"streaming cli train launches {launches}")
    with open(os.path.join(run_dir, "history.json")) as f:
        epoch = json.load(f)[0]
    log(f"[data] streaming epoch: the dense train split's {n_tr} stays exactly, {len(pulled)} in {steps} steps "
        f"(the remainder dropped), epoch {epoch['sec']:.2f}s, train_loss {epoch['train_loss']:.5f}; "
        f"{decoded['n']} image rows decoded in {decoded['s']:.3f}s (val's in load_split among them), the epoch's "
        f"host share from decoding at most {100 * decoded['s'] / epoch['sec']:.1f}%")
    out["data_stream"] = launches

    # the INSPECT note driver with the native WordPiece, at 512 x 8
    csv, vocab = write_impressions(work, SEED + 42)
    dst = os.path.join(work, "uni_note")
    lines, launches, secs = timed_cli("cli unimodal --impressions-csv", [
        "unimodal", "--modality", "note", "--impressions-csv", csv, "--vocab", vocab, "--config", yaml,
        "--out", dst, "--epochs", "2", "--device", "cuda"])
    summary = json.loads(lines[-1])
    chosen = [line for line in lines if line.startswith("[tokenizer]")]
    require(len(chosen) == 1 and chosen[0].startswith("[tokenizer] native WordPiece"),
            f"note driver tokenizer: {chosen}")
    patients = 96
    test_n, val_n = max(int(round(patients * 0.15)), 1), max(int(round(patients * 0.05)), 1)
    minibatches = sum(-(-n // bs) for n in (patients - test_n - val_n, val_n, test_n))
    require(launches == expected(packed_attention=12 * minibatches),
            f"note driver launches {launches}, expected K1 = 12 x {minibatches} minibatches")
    require(summary["tasks"] == ["pe_positive_nlp", "1_month_mortality", "12_month_PH"], f"note driver: {summary}")
    unimodal_reports("cli unimodal --impressions-csv", dst, summary["tasks"])
    log(f"[data] note driver: {chosen[0]}; {patients} patients, {minibatches} embedding minibatches of {bs} x 8 x 512")
    out["data_note_driver"] = launches

    # the host-only ETLs
    for label, argv, rows_key in (
        ("etl medfuse", ["medfuse", "--ehr-data-dir", write_medfuse_tree(os.path.join(work, "mf"), SEED + 43),
                         "--task", "phenotyping", "--out", os.path.join(work, "mf_out"), "--channels-config",
                         os.path.join(work, "mf", "channels.json"), "--data-pairs", "partial_ehr"], "splits"),
        ("etl inspect", ["inspect", *write_inspect_tree(os.path.join(work, "insp"), SEED + 44),
                         "--out", os.path.join(work, "insp_out")], "ehr_rows"),
        ("etl legacy", ["legacy", "--data-dir", raw, "--out", os.path.join(work, "legacy")], "rows"),
    ):
        lines, launches, secs = timed_cli(label, ["etl", *argv])
        summary = json.loads(lines[-1])
        require(launches == none and summary.get(rows_key), f"{label}: {summary}, launches {launches}")
        log(f"[data] {label}: {rows_key} {summary[rows_key]} in {secs:.2f}s, no kernel")
    shutil.rmtree(work)
    log(f"[data] phase done in {time.perf_counter() - t0:.1f}s")
    return out


# --- the process mesh (phase_mesh): two ranks sharing the card over gloo ------

# every dropout 0, so that the two ranks' step equals the one-process step
MESH_DET = {"model.attn_dropout": 0.0, "model.relu_dropout": 0.0, "model.res_dropout": 0.0,
            "model.embed_dropout": 0.0, "encoder.dropout": 0.0, "train.route_dropout_p": 0.0}
MESH_BATCH = 16  # the global batch: 8 stays a rank at data=2
MESH_TOL = 2e-2  # a two-rank bf16 step against the one-process bf16 step (E2E_TOL)
# (b)'s and (f)'s steps: their checks read step 1 and the ranks' bits, the
# step time step 2
ZERO_STEPS, TP_STEPS = 2, 2
TP_CLI_N = 32  # (h)'s synthetic stays per split: 2 steps an epoch
# ZeRO against replicated moments after one step, fp32 masters: only the
# clip norm's sum runs in another order, and Adam's update is invariant to
# that scale but for eps; an element moves by lr * O(1) at most
ZERO_ATOL = 1e-6


def step_spies(norms: list, reduces: list):
    """Wrap steps.apply_gradients to record the global norm of the gradients
    it receives (averaged over the world on a mesh; a model-sharded leaf's
    slices gathered whole first), and the gradient reduction to record its
    (bytes, ms), synchronised on both sides; -> undo."""
    from multimodalrouting_tpu_torch.train import steps as train_steps

    real_apply, real_reduce = train_steps.apply_gradients, train_steps.average_gradients

    def apply(state, grads, **kw):
        whole = grads if state.shards is None else state.shards.full_dict(grads)
        norms.append(float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in whole.values()]))))
        return real_apply(state, grads, **kw)

    def reduce(grads, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(grads, *args)
        torch.cuda.synchronize()
        reduces.append((sum(g.numel() * g.element_size() for g in grads), (time.perf_counter() - t0) * 1e3))

    train_steps.apply_gradients, train_steps.average_gradients = apply, reduce

    def undo():
        train_steps.apply_gradients, train_steps.average_gradients = real_apply, real_reduce

    return undo


def hop_spies(hops: list):
    """Wrap the GPipe schedule's point-to-point hop (``pp.exchange``) and its
    replication of the last stage's output (``pp.reduce_from_model_group``,
    Megatron's *g*) to record each call's (kind, bytes moved by this rank,
    ms), synchronised on both sides; -> undo."""
    from multimodalrouting_tpu_torch.parallel import pp

    real_exchange, real_g = pp.exchange, pp.reduce_from_model_group

    def timed(kind, nbytes, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        hops.append((kind, nbytes, (time.perf_counter() - t0) * 1e3))
        return out

    def exchange(send, dst, recv, src):
        nbytes = sum(x.numel() * x.element_size() for x in (send, recv) if x is not None)
        return timed("hop", nbytes, lambda: real_exchange(send, dst, recv, src))

    def reduce(x):
        return timed("replicate", x.numel() * x.element_size(), lambda: real_g(x))

    pp.exchange, pp.reduce_from_model_group = exchange, reduce

    def undo():
        pp.exchange, pp.reduce_from_model_group = real_exchange, real_g

    return undo


def record_chunk_rows(model) -> list:
    """The chunks each BERT call of `model`'s note encoder runs on, recorded
    as they come (on a model mesh, this rank's slice)."""
    enc = model.encoders.bbert
    rows, real = [], enc.chunk_embeddings

    def spy(ids, attn, generator=None):
        rows.append(int(ids.shape[0]))
        return real(ids, attn, generator)

    enc.chunk_embeddings = spy
    return rows


def mesh_step_run(label: str, cfg, dev, mesh=None, steps: int = 1, zero: bool = False, spec=None) -> tuple:
    """`steps` train steps of the full-width flagship on the MESH_BATCH
    stays (this rank's rows on a data mesh), the first alone: -> (results,
    the model, its parameters after the first step on the host, after the
    last on the card). Launch counts over all steps. `spec` (a tensor or
    route role's ``spec_for_name``) places the state first: this rank's
    slices of the parameters it shards; the results then carry the whole
    parameters' hash and the BERT and sharded parameter bytes."""
    from multimodalrouting_tpu_torch.parallel.mesh import place_state, shard_batch
    from multimodalrouting_tpu_torch.parallel.zero import shard_optimizer_state

    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda", train=True)
    seed_signal(model, "capsule")  # a nonzero head: the first loss depends on the stays
    state = create_train_state(cfg, model)
    def nbytes(keep) -> int:
        return sum(p.numel() * p.element_size() for n, p in model.named_parameters() if keep(n))

    placed = {}
    if spec is not None:
        whole = {"bert_bytes_whole": nbytes(lambda n: ".bert." in n),
                 "sharded_bytes_whole": nbytes(lambda n: spec(n) is not None)}
        shards = place_state(state, mesh, spec)
        placed = {**whole, "bert_bytes": nbytes(lambda n: ".bert." in n),
                  "sharded_bytes": nbytes(lambda n: n in shards.dims), "sharded": len(shards.dims)}
    chunk_rows = record_chunk_rows(model)
    if zero:
        shard_optimizer_state(state, mesh)
    cohort = full_width_cohort(cfg, MESH_BATCH, SEED)
    local = cohort if mesh is None or mesh.n_data == 1 else shard_batch(cohort, mesh, cfg.train.microbatch)
    cap = note_pack_bucket(cfg, local)
    batch = batch_to(local, dev)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    norms, reduces = [], []
    undo = step_spies(norms, reduces)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        first = step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap)
        after_first = {n: p.detach().cpu() for n, p in model.named_parameters()} if mesh is not None else None
        torch.cuda.synchronize()
        first_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rest = [step(state, batch, gen, cfg.train.lr, cfg.train.lr, note_pack=cap) for _ in range(steps - 1)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = read_counts()
    losses = [float(m.loss) for m in (first, *rest)]
    require(all(np.isfinite(losses)) and all(m.grad_finite for m in (first, *rest)), f"{label}: non-finite step")
    params = {n: p.detach() for n, p in model.named_parameters()}
    slots = np.asarray(local.chunk_mask).size  # the chunks BERT runs on unpacked
    out = {
        "loss": losses[0], "grad_norm": norms[0], "losses": losses, "launches": launches, "note_pack": cap,
        "chunk_rows": chunk_rows, "pack_rows": cap if 0 < cap < slots else slots,
        "valid_chunks": int(np.asarray(local.chunk_mask).sum()), "rows": local.batch_size,
        "step_ms": wall / max(steps - 1, 1) * 1e3 if steps > 1 else None,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "first_peak_gb": first_peak_gb,
        "adam_bytes": sum(v.numel() * v.element_size() for d in (state.mu, state.nu) for v in d.values()),
        "reduce_bytes": reduces[-1][0], "reduce_ms": float(np.mean([ms for _, ms in reduces[1:] or reduces])),
        **placed,
    }
    if state.shards is not None:  # every rank of the model group gathers
        out["params_sha"] = params_sha(state.shards.full_dict(params))
        out["replicated_sha"] = params_sha({n: p for n, p in params.items() if n not in state.shards.dims})
    del state, batch
    return out, model, after_first, params


def params_sha(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(params):
        h.update(params[name].float().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_rank(rank: int, world: int, port: str, work: str, device: str = "cuda") -> int:
    """One rank of phase_mesh (`chip_smoke.py --mesh-rank RANK WORLD PORT
    WORK DEVICE`), two ranks on cuda:0 over gloo: (a) 3 fine-tuned data=2
    steps, (b) 2 such steps under ZeRO-1, compared with (a) after its first
    step, (c) a frozen data=1, model=2 step, (f) 2 fine-tuned data=1,
    model=2 steps under tensor parallelism, (g) a frozen data=1, model=2
    step under route parallelism of the flagship and of the per-route MulT
    family, (i) 3 fine-tuned data=1, model=2 steps of the GPipe schedule,
    (j) a fine-tuned data=2 step with train.microbatch=2; each rank's results
    to WORK/rank<r>.json."""
    from multimodalrouting_tpu_torch.parallel import mesh as pmesh
    from multimodalrouting_tpu_torch.parallel.distributed import init_multihost
    from multimodalrouting_tpu_torch.parallel.ep import ep_spec_for_name
    from multimodalrouting_tpu_torch.parallel.pp import pp_spec_for_name
    from multimodalrouting_tpu_torch.parallel.tp import tp_spec_for_name

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tag = f"[mesh rank {rank}]"
    require(init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo", device=device,
                           log_fn=lambda m: log(f"{tag} {m}")), "init_multihost did not join")
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    results = {}
    data = pmesh.make_mesh(2, 1, batch_size=MESH_BATCH)
    pmesh.warmup_collectives(data, dev, log_fn=lambda m: log(f"{tag} {m}"))
    pmesh.set_active_mesh(data)
    ft = {"encoder.finetune_text": True, **MESH_DET, "train.num_data_shards": 2}
    a, model, first, params = mesh_step_run("data=2", flagship_cfg(**ft), dev, data, steps=3)
    a["params_sha"] = params_sha(params)
    results["mesh_data"] = a
    del model, params
    torch.cuda.empty_cache()
    b, model, zero_first, params = mesh_step_run(
        "data=2 ZeRO", flagship_cfg(**ft, **{"train.zero_sharded_opt": True}), dev, data, steps=ZERO_STEPS,
        zero=True)
    # (b) against (a), each after its first step
    b["max_abs_vs_replicated"] = max(float((zero_first[n] - first[n]).abs().max()) for n in first)
    b["params_sha"] = params_sha(params)
    results["mesh_zero"] = b
    del model, params, first, zero_first
    torch.cuda.empty_cache()
    pmesh.set_active_mesh(pmesh.make_mesh(1, 2))
    c, model, _, params = mesh_step_run("data=1,model=2 frozen",
                                        flagship_cfg(**MESH_DET, **{"train.num_model_shards": 2}), dev,
                                        pmesh.get_active_mesh())
    c["params_sha"] = params_sha(params)
    results["mesh_model"] = c
    pmesh.set_active_mesh(None)
    del model, params
    torch.cuda.empty_cache()
    # (f) tensor parallelism: each rank holds half of every BERT layer
    pmesh.set_active_mesh(pmesh.make_mesh(1, 2, role="tensor"))
    tp = {**ft, "train.num_data_shards": 1, "train.num_model_shards": 2, "train.tensor_parallel": True}
    results["mesh_tp"] = mesh_step_run("data=1,model=2 TP fine-tuned", flagship_cfg(**tp), dev,
                                       pmesh.get_active_mesh(), steps=TP_STEPS, spec=tp_spec_for_name)[0]
    pmesh.set_active_mesh(None)
    torch.cuda.empty_cache()
    # (g) route parallelism: each rank holds three of the six cross streams
    pmesh.set_active_mesh(pmesh.make_mesh(1, 2, role="route"))
    ep = {**MESH_DET, "train.num_model_shards": 2, "train.route_parallel": True}
    for key, yaml in (("mesh_ep", "trimodal_mort.yaml"), ("mesh_ep_route_mult", "pheno_atten_mult.yaml")):
        results[key] = mesh_step_run(f"data=1,model=2 EP frozen {yaml}", flagship_cfg(yaml, **ep), dev,
                                     pmesh.get_active_mesh(), spec=ep_spec_for_name)[0]
        torch.cuda.empty_cache()
    pmesh.set_active_mesh(None)
    # (i) the GPipe schedule: each rank holds one stage, 6 of the 12 BERT layers
    pmesh.set_active_mesh(pmesh.make_mesh(1, 2, role="pipeline"))
    pipe = {**ft, "train.num_data_shards": 1, "train.num_model_shards": 2, "train.pipeline_parallel": True}
    hops = []
    undo = hop_spies(hops)
    try:
        results["mesh_pp"] = mesh_step_run("data=1,model=2 pipeline fine-tuned", flagship_cfg(**pipe), dev,
                                           pmesh.get_active_mesh(), steps=3, spec=pp_spec_for_name)[0]
    finally:
        undo()
    results["mesh_pp"]["hops"] = {
        kind: {"calls": sum(1 for k, _, _ in hops if k == kind), "bytes": sum(b for k, b, _ in hops if k == kind),
               "ms": sum(ms for k, _, ms in hops if k == kind)} for kind in ("hop", "replicate")}
    pmesh.set_active_mesh(None)
    torch.cuda.empty_cache()
    # (j) microbatching on the data mesh: each rank's microbatch i is its half of global microbatch i
    pmesh.set_active_mesh(data)
    results["mesh_microbatch"] = mesh_step_run("data=2 microbatch=2 fine-tuned",
                                               flagship_cfg(**ft, **{"train.microbatch": 2}), dev, data)[0]
    pmesh.set_active_mesh(None)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.destroy_process_group()
    return 0


def cli_rank(argv: list) -> int:
    """One rank of phase_mesh's `cli train --mesh` (`chip_smoke.py
    --cli-rank ARGV_JSON`, the JAX package's variables in the environment):
    the process group joined over gloo, as only the card phase may share a
    card between ranks, then the CLI."""
    from multimodalrouting_tpu_torch.parallel.distributed import init_multihost

    argv = json.loads(argv)
    require(init_multihost(backend="gloo", device=argv[argv.index("--device") + 1]), "init_multihost did not join")
    try:
        return port_cli.main(argv)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(args_of, env_of=None, timeout: int = 600) -> list:
    """Two rank processes of this script, their output relayed; -> their
    outputs. Fails if either exits non-zero; kills both on the way out."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(r)], cwd=ROOT,
                              env={**os.environ, **(env_of(r) if env_of else {})}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"[mesh rank {r}] {line}" if not line.startswith("[mesh rank") else line)
        require(p.returncode == 0, f"rank {r} exited {p.returncode}")
    return outs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_nccl(dev) -> None:
    """(e) One rank under NCCL (world 1, cuda:0): init_multihost picks NCCL
    by itself, and each collective helper runs once on a CUDA tensor."""
    import torch.distributed as dist

    from multimodalrouting_tpu_torch.parallel import mesh as pmesh
    from multimodalrouting_tpu_torch.parallel.distributed import init_multihost
    from multimodalrouting_tpu_torch.parallel.zero import ZeroShards

    require(init_multihost(f"127.0.0.1:{free_port()}", 1, 0, log_fn=log), "NCCL world did not initialise")
    try:
        backend = dist.get_backend()
        require(backend == "nccl", f"init_multihost chose {backend} with a card of its own")
        mesh = pmesh.make_mesh(1, 1)
        dev = torch.device("cuda", torch.cuda.current_device())
        pmesh.warmup_collectives(mesh, dev, log_fn=log)
        pmesh.set_active_mesh(mesh)
        x = torch.arange(6.0, device=dev).reshape(3, 2).requires_grad_()
        s = pmesh.global_sum(x)
        s.sum().backward()
        g = pmesh.gather_chunks(x.detach())
        grads = [torch.ones(4, device=dev), torch.full((2,), 3.0, device=dev, dtype=torch.bfloat16)]
        pmesh.average_gradients(grads)
        host = pmesh.host_gather(x.detach(), mesh)
        z = ZeroShards(mesh, {"w": slice(0, 3)})
        w = torch.zeros(3, 2, device=dev)
        w[0:3] = 1.0
        z.gather_param_(w, "w")
        ok = (torch.equal(s, x) and torch.equal(x.grad, torch.ones_like(x)) and torch.equal(g, x)
              and torch.equal(pmesh.global_mean(x.detach()), x.detach()) and float(grads[1][0]) == 3.0
              and np.array_equal(host, x.detach().cpu().numpy()) and z.all_finite(True, dev)
              and float(z.sum(torch.ones(1, device=dev))) == 1.0 and bool((w == 1).all()))
        require(ok, "an NCCL collective helper gave a wrong result")
        log(f"[mesh] (e) NCCL on {torch.cuda.get_device_name(0)}: global_sum (and its backward), global_mean, "
            "gather_chunks, average_gradients (fp32, bf16), host_gather and ZeRO's all_finite / sum / gather "
            "each ran on a CUDA tensor")
    finally:
        pmesh.set_active_mesh(None)
        dist.destroy_process_group()


def phase_mesh(dev, tmp: str) -> dict:
    """The process mesh on one card: (a) two ranks on cuda:0 over gloo take
    3 fine-tuned data=2 steps of the full-width flagship on 16 stays (8 a
    rank), K1/K2/K3 = 12/12/1 per rank per step, parameters bit-identical
    across ranks, step 1's loss and global gradient norm within MESH_TOL of
    the one-process step on the same 16; (b) 2 such steps under ZeRO-1,
    its parameters within ZERO_ATOL of (a)'s after the first, each rank's Adam
    bytes at most 0.55 of (a)'s; (c) a frozen data=1, model=2 step, K1 = 12
    per rank on half the note pack, the loss within MESH_TOL of the
    one-process frozen step; (d) `cli train --mesh data=2` as two processes
    with the JAX package's variables for one epoch, one checkpoint written
    by rank 0, `cli eval` of it in this process (K3 = 1 per forward); (f)
    2 fine-tuned data=1, model=2 steps under tensor parallelism, K1/K2/K3 =
    24/24/2 per rank (K1 and K2 on each rank's 6 heads, d = 384, the whole
    pack), step 1's loss and global gradient norm within MESH_TOL of the
    one-process step, the whole parameters bit-identical across ranks, each
    rank holding half of the BERT layers' bytes (the embeddings stay whole);
    (g) a frozen data=1,
    model=2 step under route parallelism, the flagship (K1 = 12, K3 = 1 per
    rank) and the per-route MulT family (K1 = 12, K3 = 0), each loss within
    MESH_TOL of its one-process step; (h) `cli train --mesh data=1,model=2
    --set train.tensor_parallel=true` for one epoch and `cli eval` of its
    checkpoint in this process (K3 = 1 per forward); (i) 3 fine-tuned
    data=1, model=2 steps of the GPipe schedule (each rank one stage of 6
    BERT layers, the pack in 2 microbatches, the bubble ticks skipped):
    K4a forward / backward / K3 = 12 / 12 / 1 per rank per step, step 1's
    loss and global gradient norm within MESH_TOL of the one-process
    pipeline-layout step, each of the 3 losses within MESH_TOL of its 3
    steps', each rank holding half of the stacked layers' bytes, the replicated parameters bit-identical across ranks, the hops'
    and the output replication's bytes and ms logged; (j) a fine-tuned
    data=2 step with train.microbatch=2 (K1/K2/K3 = 24/24/2 per rank), its
    loss within MESH_TOL of the one-process microbatch=2 step; (k) `cli
    train --mesh data=1,model=2 --set train.pipeline_parallel=true` for one
    epoch and `cli eval` of its checkpoint in this process (K3 = 1 per
    forward); beside the one-process references, one fine-tuned step under
    model.remat (K1 = 24: the forward recomputed), its loss within MESH_TOL
    of the step without it, both peaks logged; (e) NCCL in a world of one.
    Step times are of two ranks sharing one card: not a scaling figure.
    -> {path: launches}."""
    t0 = time.perf_counter()
    # the one-process references, freed before the ranks start: three
    # processes share the card's memory
    ft = {"encoder.finetune_text": True, **MESH_DET}
    one, model, _, _ = mesh_step_run("one process", flagship_cfg(**ft), dev)
    del model
    one_frozen, model, _, _ = mesh_step_run("one process frozen", flagship_cfg(**MESH_DET), dev)
    del model
    one_mult, model, _, _ = mesh_step_run("one process per-route MulT frozen",
                                          flagship_cfg("pheno_atten_mult.yaml", **MESH_DET), dev)
    del model
    one_pp, model, _, _ = mesh_step_run("one process pipeline layout",
                                        flagship_cfg(**ft, **{"train.pipeline_parallel": True}), dev, steps=3)
    del model
    one_mb, model, _, _ = mesh_step_run("one process microbatch=2", flagship_cfg(**ft, **{"train.microbatch": 2}),
                                        dev)
    del model
    one_remat, model, _, _ = mesh_step_run("one process model.remat", flagship_cfg(**ft, **{"model.remat": True}),
                                           dev)
    del model
    torch.cuda.empty_cache()
    log(f"[mesh] one process, 16 stays: fine-tuned loss {one['loss']:.5f} grad_norm {one['grad_norm']:.5f} "
        f"(pack {one['note_pack']}); frozen loss {one_frozen['loss']:.5f} (pack {one_frozen['note_pack']}); "
        f"pipeline layout loss {one_pp['loss']:.5f} grad_norm {one_pp['grad_norm']:.5f}; microbatch=2 loss "
        f"{one_mb['loss']:.5f}")
    # model.remat: each BERT layer recomputed in the backward, so K1 runs twice a layer
    for label, got, want in (("pipeline layout", one_pp, expected(flash_attention=36, flash_attention_bwd=36,
                                                                   capsule_routing=3)),
                             ("microbatch=2", one_mb, expected(packed_attention=24, packed_attention_bwd=24,
                                                               capsule_routing=2)),
                             ("model.remat", one_remat, expected(packed_attention=24, packed_attention_bwd=12,
                                                                capsule_routing=1))):
        require(got["launches"] == want, f"one process {label}: launches {got['launches']}, expected {want}")
    rel = abs(one_remat["loss"] - one["loss"]) / abs(one["loss"])
    require(rel <= MESH_TOL, f"model.remat loss {one_remat['loss']} against {one['loss']} without it: rel {rel:.3e}")
    log(f"[mesh] model.remat, one fine-tuned step: loss {one_remat['loss']:.5f} (rel {rel:.2e} of the step without "
        f"it), K1/K2 {one_remat['launches']['packed_attention']}/{one_remat['launches']['packed_attention_bwd']} "
        f"(the forward recomputed); peak_memory_gb={one_remat['first_peak_gb']:.2f} with remat, "
        f"{one['first_peak_gb']:.2f} without")
    work = os.path.join(tmp, "mesh")
    os.makedirs(work)
    port = str(free_port())
    spawn_ranks(lambda r: ["--mesh-rank", str(r), "2", port, work, dev.type])
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = {}
    per_step = {"packed_attention": 12, "packed_attention_bwd": 12, "capsule_routing": 1}
    for path, steps, counts in (("mesh_data", 3, per_step), ("mesh_zero", ZERO_STEPS, per_step),
                                ("mesh_model", 1, {"packed_attention": 12, "capsule_routing": 1})):
        want = expected(**{k: v * steps for k, v in counts.items()})
        for r, rk in enumerate(ranks):
            got = rk[path]
            require(got["launches"] == want, f"{path} rank {r}: launches {got['launches']}, expected {want}")
            out[f"{path}.rank{r}"] = got["launches"]
        require(ranks[0][path]["params_sha"] == ranks[1][path]["params_sha"],
                f"{path}: the ranks' parameters differ")
    a0 = ranks[0]["mesh_data"]
    rel = {key: abs(a0[key] - one[key]) / abs(one[key]) for key in ("loss", "grad_norm")}
    for key in rel:
        require(rel[key] <= MESH_TOL, f"(a) step 1 {key} {a0[key]} against one process {one[key]}: rel {rel[key]:.3e}")
    log(f"[mesh] (a) data=2 fine-tuned: step 1 loss {a0['loss']:.5f} grad_norm {a0['grad_norm']:.5f} (rel "
        f"{rel['loss']:.2e} / {rel['grad_norm']:.2e} of one process); losses {[round(x, 5) for x in a0['losses']]}; "
        "parameters bit-identical across ranks")
    for r, rk in enumerate(ranks):
        a = rk["mesh_data"]
        log(f"[mesh] (a) rank {r}: {a['rows']} stays, pack {a['note_pack']} ({a['valid_chunks']} valid chunks), "
            f"K1/K2/K3 {a['launches']['packed_attention']}/{a['launches']['packed_attention_bwd']}/"
            f"{a['launches']['capsule_routing']} over 3 steps, step_ms={a['step_ms']:.1f} (two ranks sharing "
            f"one card), peak_memory_gb={a['peak_gb']:.2f}, adam_bytes={a['adam_bytes']}, "
            f"reduce_ms={a['reduce_ms']:.1f} for {a['reduce_bytes']} bytes a step")
        b = rk["mesh_zero"]
        ratio = b["adam_bytes"] / a["adam_bytes"]
        require(b["max_abs_vs_replicated"] <= ZERO_ATOL, f"(b) rank {r}: ZeRO parameters off by "
                f"{b['max_abs_vs_replicated']:.3e} from the replicated ones (limit {ZERO_ATOL})")
        require(ratio <= 0.55, f"(b) rank {r}: Adam bytes {b['adam_bytes']} = {ratio:.3f} of replicated")
        log(f"[mesh] (b) rank {r}: ZeRO-1 max|param - replicated| after one step {b['max_abs_vs_replicated']:.3e} "
            f"(limit {ZERO_ATOL}), adam_bytes={b['adam_bytes']} ({ratio:.3f} of replicated), "
            f"step_ms={b['step_ms']:.1f}, peak_memory_gb={b['peak_gb']:.2f}")
        require(a["chunk_rows"] == [a["pack_rows"]] * 3, f"(a) rank {r}: BERT ran on {a['chunk_rows']} chunks, "
                f"expected its pack of {a['pack_rows']} in each of 3 steps")
    c0 = ranks[0]["mesh_model"]
    rel = abs(c0["loss"] - one_frozen["loss"]) / abs(one_frozen["loss"])
    require(rel <= MESH_TOL, f"(c) loss {c0['loss']} against one process {one_frozen['loss']}: rel {rel:.3e}")
    # each rank's BERT ran on half of the pack that one process ran on
    half = -(-one_frozen["chunk_rows"][0] // 2)
    require(one_frozen["chunk_rows"] == [one_frozen["pack_rows"]], f"(c) one process: BERT ran on "
            f"{one_frozen['chunk_rows']} chunks, expected its pack of {one_frozen['pack_rows']}")
    for r, rk in enumerate(ranks):
        require(rk["mesh_model"]["chunk_rows"] == [half], f"(c) rank {r}: BERT ran on "
                f"{rk['mesh_model']['chunk_rows']} chunks, expected {half} of the pack's {one_frozen['pack_rows']}")
    log(f"[mesh] (c) data=1,model=2 frozen: loss {c0['loss']:.5f} (rel {rel:.2e}), pack {c0['note_pack']} "
        f"chunks, BERT on {ranks[0]['mesh_model']['chunk_rows'][0]} / {ranks[1]['mesh_model']['chunk_rows'][0]} "
        f"of them on ranks 0 / 1 (measured), K1 = {c0['launches']['packed_attention']} per rank")

    # (f) tensor parallelism, (g) route parallelism
    per_step_tp = {"packed_attention": 12, "packed_attention_bwd": 12, "capsule_routing": 1}
    for path, counts in (("mesh_tp", {k: TP_STEPS * v for k, v in per_step_tp.items()}),
                         ("mesh_ep", {"packed_attention": 12, "capsule_routing": 1}),
                         ("mesh_ep_route_mult", {"packed_attention": 12})):
        want = expected(**counts)
        for r, rk in enumerate(ranks):
            got = rk[path]
            require(got["launches"] == want, f"{path} rank {r}: launches {got['launches']}, expected {want}")
            require(got["chunk_rows"] == [got["pack_rows"]] * len(got["losses"]), f"{path} rank {r}: BERT ran on "
                    f"{got['chunk_rows']} chunks, expected the whole pack of {got['pack_rows']} in each step")
            out[f"{path}.rank{r}"] = got["launches"]
        require(ranks[0][path]["params_sha"] == ranks[1][path]["params_sha"],
                f"{path}: the ranks' whole parameters differ")
    f0 = ranks[0]["mesh_tp"]
    rel = {key: abs(f0[key] - one[key]) / abs(one[key]) for key in ("loss", "grad_norm")}
    for key in rel:
        require(rel[key] <= MESH_TOL, f"(f) step 1 {key} {f0[key]} against one process {one[key]}: rel {rel[key]:.3e}")
    for r, rk in enumerate(ranks):
        for path in ("mesh_tp", "mesh_ep", "mesh_ep_route_mult"):  # each rank holds half of every sharded leaf
            g = rk[path]
            require(g["sharded"] > 0 and 2 * g["sharded_bytes"] == g["sharded_bytes_whole"],
                    f"{path} rank {r}: {g['sharded']} sharded parameters of {g['sharded_bytes']} bytes, whole "
                    f"{g['sharded_bytes_whole']}")
        f = rk["mesh_tp"]
        share = f["bert_bytes"] / f["bert_bytes_whole"]
        log(f"[mesh] (f) TP rank {r}: {f['sharded']} parameters sharded, BERT bytes {f['bert_bytes']} "
            f"({share:.3f} of {f['bert_bytes_whole']}), pack {f['note_pack']} chunks on every rank, "
            f"K1/K2/K3 {f['launches']['packed_attention']}/{f['launches']['packed_attention_bwd']}/"
            f"{f['launches']['capsule_routing']} over {TP_STEPS} steps, step_ms={f['step_ms']:.1f} (two ranks "
            f"sharing one card over gloo), peak_memory_gb={f['peak_gb']:.2f}, reduce_ms={f['reduce_ms']:.1f} for "
            f"{f['reduce_bytes']} bytes a step")
    log(f"[mesh] (f) data=1,model=2 TP fine-tuned: step 1 loss {f0['loss']:.5f} grad_norm {f0['grad_norm']:.5f} "
        f"(rel {rel['loss']:.2e} / {rel['grad_norm']:.2e} of one process); losses "
        f"{[round(x, 5) for x in f0['losses']]}; whole parameters bit-identical across ranks")
    for path, ref in (("mesh_ep", one_frozen), ("mesh_ep_route_mult", one_mult)):
        g0 = ranks[0][path]
        rel = abs(g0["loss"] - ref["loss"]) / abs(ref["loss"])
        require(rel <= MESH_TOL, f"(g) {path} loss {g0['loss']} against one process {ref['loss']}: rel {rel:.3e}")
        log(f"[mesh] (g) {path}: loss {g0['loss']:.5f} (rel {rel:.2e} of one process), {g0['sharded']} parameters "
            f"sharded, K1 = {g0['launches']['packed_attention']} and K3 = {g0['launches']['capsule_routing']} per "
            f"rank, peak_memory_gb={g0['peak_gb']:.2f}; whole parameters bit-identical across ranks")

    # (i) the GPipe schedule, (j) microbatching on the data mesh
    per_step_pp = {"flash_attention": 12, "flash_attention_bwd": 12, "capsule_routing": 1}
    for path, counts in (("mesh_pp", {k: 3 * v for k, v in per_step_pp.items()}),
                         ("mesh_microbatch", {"packed_attention": 24, "packed_attention_bwd": 24,
                                              "capsule_routing": 2})):
        want = expected(**counts)
        for r, rk in enumerate(ranks):
            got = rk[path]
            require(got["launches"] == want, f"{path} rank {r}: launches {got['launches']}, expected {want}")
            out[f"{path}.rank{r}"] = got["launches"]
    i0 = ranks[0]["mesh_pp"]
    rel = {key: abs(i0[key] - one_pp[key]) / abs(one_pp[key]) for key in ("loss", "grad_norm")}
    for key in rel:
        require(rel[key] <= MESH_TOL, f"(i) step 1 {key} {i0[key]} against the one-process pipeline layout "
                f"{one_pp[key]}: rel {rel[key]:.3e}")
    # every step, not only the first: the flagship's step 2 at this lr on the repeated batch spikes in both
    steps_rel = [abs(x - y) / abs(y) for x, y in zip(i0["losses"], one_pp["losses"])]
    require(len(steps_rel) == 3 and max(steps_rel) <= MESH_TOL, f"(i) losses {i0['losses']} against the one-process "
            f"pipeline layout's {one_pp['losses']}: rel {steps_rel}")
    require(ranks[0]["mesh_pp"]["params_sha"] == ranks[1]["mesh_pp"]["params_sha"]
            and ranks[0]["mesh_pp"]["replicated_sha"] == ranks[1]["mesh_pp"]["replicated_sha"],
            "(i): the ranks' replicated or whole parameters differ")
    for r, rk in enumerate(ranks):
        g, hops = rk["mesh_pp"], rk["mesh_pp"]["hops"]
        require(g["sharded"] == 16 and 2 * g["sharded_bytes"] == g["sharded_bytes_whole"],
                f"(i) rank {r}: {g['sharded']} stage-sharded leaves of {g['sharded_bytes']} bytes, all the "
                f"pp_layers' {g['sharded_bytes_whole']}")
        launches = g["launches"]
        log(f"[mesh] (i) pipeline rank {r} (stage {r}, BERT layers [{6 * r}, {6 * r + 6})): pack {g['note_pack']} "
            f"chunks in 2 microbatches; K4a fwd/bwd {launches['flash_attention'] // 3}/"
            f"{launches['flash_attention_bwd'] // 3} and K3 {launches['capsule_routing'] // 3} per step "
            f"(3 steps), K1/K2 {launches['packed_attention']}/{launches['packed_attention_bwd']}; pp_layers bytes "
            f"{g['sharded_bytes']} of {g['sharded_bytes_whole']}; step_ms={g['step_ms']:.1f} (two ranks sharing "
            f"one card over gloo), peak_memory_gb={g['peak_gb']:.2f}; per step: {hops['hop']['calls'] / 3:.0f} hops, "
            f"{hops['hop']['bytes'] / 3:.0f} bytes in {hops['hop']['ms'] / 3:.1f} ms, the output's replication "
            f"{hops['replicate']['bytes'] / 3:.0f} bytes in {hops['replicate']['ms'] / 3:.1f} ms; gradient average "
            f"reduce_ms={g['reduce_ms']:.1f} for {g['reduce_bytes']} bytes")
    log(f"[mesh] (i) data=1,model=2 pipeline fine-tuned: step 1 loss {i0['loss']:.5f} grad_norm "
        f"{i0['grad_norm']:.5f} (rel {rel['loss']:.2e} / {rel['grad_norm']:.2e} of the one-process pipeline "
        f"layout); losses {[round(x, 5) for x in i0['losses']]}, one process's over the same 3 steps "
        f"{[round(x, 5) for x in one_pp['losses']]} (rel {max(steps_rel):.2e} at most); whole and replicated "
        "parameters bit-identical across ranks")
    j0 = ranks[0]["mesh_microbatch"]
    rel = abs(j0["loss"] - one_mb["loss"]) / abs(one_mb["loss"])
    require(rel <= MESH_TOL, f"(j) loss {j0['loss']} against one process microbatch=2 {one_mb['loss']}: rel {rel:.3e}")
    log(f"[mesh] (j) data=2 microbatch=2 fine-tuned: loss {j0['loss']:.5f} (rel {rel:.2e} of one process), "
        f"{j0['rows']} stays a rank in 2 microbatches, K1/K2/K3 {j0['launches']['packed_attention']}/"
        f"{j0['launches']['packed_attention_bwd']}/{j0['launches']['capsule_routing']} per rank, "
        f"peak_memory_gb={j0['first_peak_gb']:.2f}")

    # (d) the CLI on a data mesh, then eval in this process
    run_dir = os.path.join(tmp, "mesh_cli")
    yaml = os.path.join(ROOT, "configs", "trimodal_mort.yaml")
    argv = ["train", "--config", yaml, "--mesh", "data=2", "--out", run_dir, "--device", "cuda", "--epochs", "1",
            *set_args(*CLI_ONCE)]
    port = str(free_port())
    t1 = time.perf_counter()
    outs = spawn_ranks(lambda r: ["--cli-rank", json.dumps(argv)],
                       lambda r: {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
                                  "JAX_PROCESS_ID": str(r)})
    secs = time.perf_counter() - t1
    for r, text in enumerate(outs):
        require(f"[distributed] process {r}/2" in text, f"cli rank {r} printed no [distributed] line")
    dirs = sorted(d for d in os.listdir(run_dir) if os.path.isdir(os.path.join(run_dir, d)))
    require(dirs == ["final"], f"cli train --mesh wrote {dirs}, expected one checkpoint")
    summary = json.loads(outs[0].strip().splitlines()[-1])
    log(f"[mesh] (d) cli train --mesh data=2: {secs:.1f}s for both ranks, {summary}")
    lines, launches = run_cli(["eval", "--ckpt", run_dir, "--device", "cuda"])
    want = expected(capsule_routing=-(-CLI_N // CLI_BATCH))
    require(launches == want, f"cli eval of the mesh checkpoint: launches {launches}, expected {want}")
    out["mesh_cli_eval"] = launches
    shutil.rmtree(run_dir)

    # (h) the CLI under tensor parallelism on data=1,model=2, then eval in this process
    run_dir = os.path.join(tmp, "mesh_cli_tp")
    argv = ["train", "--config", yaml, "--mesh", "data=1,model=2", "--set", "train.tensor_parallel=true",
            "--out", run_dir, "--device", "cuda", "--epochs", "1",
            *set_args(*CLI_ONCE, f"data.synthetic_n={TP_CLI_N}")]
    port = str(free_port())
    t1 = time.perf_counter()
    outs = spawn_ranks(lambda r: ["--cli-rank", json.dumps(argv)],
                       lambda r: {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
                                  "JAX_PROCESS_ID": str(r)})
    secs = time.perf_counter() - t1
    for r, text in enumerate(outs):
        require("[mesh] tensor parallelism on data=1,model=2" in text and "[tp] each rank's BERT attention: 6 heads"
                in text, f"cli rank {r} printed no tensor-parallel placement")
    dirs = sorted(d for d in os.listdir(run_dir) if os.path.isdir(os.path.join(run_dir, d)))
    require(dirs == ["final"], f"cli train --mesh TP wrote {dirs}, expected one checkpoint")
    log(f"[mesh] (h) cli train --mesh data=1,model=2 TP: {secs:.1f}s for both ranks, "
        f"{json.loads(outs[0].strip().splitlines()[-1])}")
    lines, launches = run_cli(["eval", "--ckpt", run_dir, "--device", "cuda"])
    want = expected(capsule_routing=-(-TP_CLI_N // CLI_BATCH))
    require(launches == want, f"cli eval of the TP mesh checkpoint: launches {launches}, expected {want}")
    out["mesh_tp_cli_eval"] = launches
    shutil.rmtree(run_dir)

    # (k) the CLI under the GPipe schedule on data=1,model=2, then eval in this process
    run_dir = os.path.join(tmp, "mesh_cli_pp")
    argv = ["train", "--config", yaml, "--mesh", "data=1,model=2", "--set", "train.pipeline_parallel=true",
            "--out", run_dir, "--device", "cuda", "--epochs", "1",
            *set_args(*CLI_ONCE, f"data.synthetic_n={TP_CLI_N}")]
    port = str(free_port())
    t1 = time.perf_counter()
    outs = spawn_ranks(lambda r: ["--cli-rank", json.dumps(argv)],
                       lambda r: {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
                                  "JAX_PROCESS_ID": str(r)})
    secs = time.perf_counter() - t1
    for r, text in enumerate(outs):
        require("[mesh] pipeline parallelism on data=1,model=2" in text
                and f"[pp] stage {r} of 2: BERT layers [{6 * r}, {6 * r + 6}) of 12" in text,
                f"cli rank {r} printed no pipeline placement")
    dirs = sorted(d for d in os.listdir(run_dir) if os.path.isdir(os.path.join(run_dir, d)))
    require(dirs == ["final"], f"cli train --mesh pipeline wrote {dirs}, expected one checkpoint")
    log(f"[mesh] (k) cli train --mesh data=1,model=2 pipeline: {secs:.1f}s for both ranks, "
        f"{json.loads(outs[0].strip().splitlines()[-1])}")
    lines, launches = run_cli(["eval", "--ckpt", run_dir, "--device", "cuda"])
    want = expected(capsule_routing=-(-TP_CLI_N // CLI_BATCH))
    require(launches == want, f"cli eval of the pipeline mesh checkpoint: launches {launches}, expected {want}")
    out["mesh_pp_cli_eval"] = launches
    shutil.rmtree(run_dir)

    phase_nccl(dev)
    log(f"[mesh] phase done in {time.perf_counter() - t0:.1f}s")
    return out


def ptxas_report() -> None:
    """Print each library's ptxas lines (the kernel each group of lines is
    for, its registers, spills and any warning) and fail if an instance of
    the bf16 forward kernel spills."""
    checked = 0
    for name in hopper.SOURCES:
        entry = ""
        for line in hopper.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif not ("registers" in line or "spill" in line or "warning" in line.lower()):
                continue
            log(f"[build] {name}: {line.strip()}")
            if "spill" in line and "attention_fwd_wgmma_kernel" in entry:
                spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
                require(spills == [0, 0], f"{entry} spills: {line.strip()}")
                checked += 1
    require(checked == 4, f"ptxas reported {checked} instances of the bf16 forward kernel, expected 4")


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
    ptxas_report()

    phase_secs: dict = {}

    def timed(name: str, fn, *args, **kw):
        t1 = time.perf_counter()
        out = fn(*args, **kw)
        phase_secs[name] = round(time.perf_counter() - t1, 1)
        log(f"[phase] {name}: {phase_secs[name]}s")
        return out

    kernels = [timed("k1", phase_k1, dev), timed("k2", phase_k2, dev), timed("k3", phase_k3, dev),
               *timed("k4", phase_k4, dev)]
    timed("k3_grad", phase_k3_grad, dev)
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_path["serving"] = timed("serving", phase_serving, dev, tmp)
        by_path["train_finetune"] = timed("train_finetune", phase_train_finetune, dev)
        by_path.update(timed("switches", phase_switches, dev))
        by_path["train_frozen"] = timed("train_frozen", phase_train_frozen, dev)
        by_path.update(timed("bench", phase_bench, dev, tmp))
        by_path.update(timed("scripts", phase_scripts, dev, tmp))
        by_path["serving_pp"] = timed("serving_pp", phase_serving_pp, dev, tmp)
        by_path["train_pp_finetune"] = timed(
            "train_pp_finetune", phase_train_finetune,
            dev, warmup=1, steps=2, label="pipeline-layout fine-tuned", profile=False,
            per_step={"flash_attention": 12, "flash_attention_bwd": 12, "capsule_routing": 1},
            layer_key="pp_layers.i_kernel", **{"train.pipeline_parallel": True})
        for name, phase in (("splash", phase_splash), ("entry_point", phase_entry_point), ("pheno", phase_pheno),
                            ("families", phase_families), ("cli", phase_cli), ("route_mult", phase_route_mult),
                            ("text_cache", phase_text_cache), ("jax_ckpt", phase_jax_ckpt),
                            ("densenet", phase_densenet), ("pretrained", phase_pretrained),
                            ("unimodal", phase_unimodal), ("artifact", phase_artifact), ("int8", phase_int8),
                            ("interpret", phase_interpret), ("data", phase_data), ("mesh", phase_mesh)):
            out = timed(name, phase, dev, tmp)
            if name == "cli":
                by_path["cli"] = out
            elif out is not None:
                by_path.update(out)
    log(f"[phase] seconds by phase: {json.dumps(phase_secs)}; {sum(phase_secs.values()):.1f}s in all")
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
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase_mesh
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank(sys.argv[2]))
    sys.exit(main())
