"""The flagship bench workload's step split into phases, through the PyTorch
port (scripts/bench_phases.py's table):

  bert_fwd     frozen chunked BioClinicalBERT forward (packed capacity)
  behrt_fwd    structured lab encoder forward
  cxr_fwd      ResNet image encoder forward
  model_fwd    full trimodal forward (encoders + MULT + fusion + capsule)
  fusion_fwd*  model_fwd - (bert + behrt + cxr)   [derived]
  train_step   full fwd+bwd+AdamW+EMA step
  bwd_opt*     train_step - model_fwd             [derived]

    python3 scripts/torch_bench_phases.py                        # on the CUDA card
    BENCH_FINETUNE=1 python3 scripts/torch_bench_phases.py       # the fine-tuned-text leg
    python3 scripts/torch_bench_phases.py --device cpu --small   # tiny widths on the CPU

Env BENCH_BATCH (16), BENCH_CHUNKS (8), BENCH_STEPS (10), BENCH_WARMUP (2),
BENCH_FINETUNE. Each phase: the warm-up calls, a readback, then the timed
calls on the host clock closed by a readback (which on the card waits for
the device). The forward phases run under ``torch.inference_mode()``. The
encoders are built alone, as that script builds them, so ``bert_fwd`` runs
BioClinBERTEncoder's own GELU and LN (erf, fp32), and the config's overrides
are that script's, which set neither: ``model_fwd`` and ``train_step`` run
the config's (poly, bf16), not bench.py's fp32 LN. The JSON names both.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_bench as tb  # noqa: E402


def timed_ms(fn: Callable, steps: int, warmup: int, force: Callable) -> float:
    """Mean ms of `fn` over `steps` calls after `warmup` calls, host clock,
    each end forced by a readback."""
    out = None
    for _ in range(warmup):
        out = fn()
    if out is not None:
        force(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn()
    force(out)
    return (time.perf_counter() - t0) / steps * 1e3


def first_value(out) -> float:
    """One element of the first tensor of an output tuple, read back."""
    x = out[0] if isinstance(out, tuple) else out
    return float(x.reshape(-1)[0].float())


def phase_modules(cfg, device) -> Dict[str, torch.nn.Module]:
    """The three encoders alone, each seeded with 0, as scripts/bench_phases.py
    builds them (the image encoder at model.d)."""
    from multimodalrouting_tpu_torch.models.behrt import BEHRTLabEncoder
    from multimodalrouting_tpu_torch.models.clinbert import BioClinBERTEncoder
    from multimodalrouting_tpu_torch.models.cxr import ImageEncoder
    from multimodalrouting_tpu_torch.models.full import compute_dtype

    e, m = cfg.encoder, cfg.model
    dtype = compute_dtype(cfg)
    builders = {
        "bert": lambda: BioClinBERTEncoder(
            d=e.d, vocab_size=e.bert_vocab_size, hidden=e.bert_hidden, layers=e.bert_layers, heads=e.bert_heads,
            intermediate=e.bert_intermediate, max_position=e.bert_max_position, note_agg=e.note_agg,
            chunk_agg=e.note_chunk_agg, dtype=dtype, finetune_text=e.finetune_text,
        ),
        "behrt": lambda: BEHRTLabEncoder(
            n_feats=e.structured_n_feats, d=e.d, seq_len=e.structured_seq_len, n_layers=e.structured_layers,
            n_heads=e.structured_heads, pool=e.structured_pool, dtype=dtype,
        ),
        "cxr": lambda: ImageEncoder(
            d=m.d, vision_backbone=e.vision_backbone, vision_num_classes=e.vision_num_classes,
            norm_kind=e.vision_norm, dtype=dtype,
        ),
    }
    mods = {}
    for name, build in builders.items():
        torch.manual_seed(0)
        mods[name] = build().to(device).eval()
    return mods


def phase_calls(w: tb.Workload, mods: Dict[str, torch.nn.Module]) -> Dict[str, Callable]:
    """The four forwards, each one call without a gradient."""
    b = w.batch

    def forward(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    return {
        "bert_fwd": forward(lambda: mods["bert"](b.notes_dict(), None, w.cap)),
        "behrt_fwd": forward(lambda: mods["behrt"](b.x_struct, b.m_struct)),
        "cxr_fwd": forward(lambda: mods["cxr"](b.image, train=False)),
        "model_fwd": forward(lambda: w.model(b, train=False, note_pack=w.cap).logits),
    }


def run_phases(w: tb.Workload, steps: int, warmup: int, device) -> Dict:
    """The phase table of `w` (ms per call), its derived rows and config."""
    mods = phase_modules(w.cfg, device)
    results = {f"{name}_ms": timed_ms(fn, steps, warmup, first_value) for name, fn in phase_calls(w, mods).items()}
    results["train_step_ms"] = timed_ms(w.step_once, steps, warmup, w.force)
    results["fusion_routing_fwd_ms_derived"] = round(
        results["model_fwd_ms"] - results["bert_fwd_ms"] - results["behrt_fwd_ms"] - results["cxr_fwd_ms"], 2
    )
    results["bwd_optimizer_ms_derived"] = round(results["train_step_ms"] - results["model_fwd_ms"], 2)
    results = {k: (round(v, 2) if isinstance(v, float) else v) for k, v in results.items()}
    e = w.cfg.encoder
    results["config"] = {
        "batch": w.cohort.batch_size, "chunks": w.cohort.note_ids.shape[1], "pack_capacity": w.cap,
        "device": tb.device_name(device), "finetune_text": e.finetune_text,
        "gelu_ln": {"bert_fwd": "erf/fp32 (BioClinBERTEncoder's own)", "model_fwd, train_step": f"{e.bert_gelu}/{e.bert_ln}"},
    }
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="tiny widths for the CPU")
    args = ap.parse_args(argv)
    device = tb.bench_device(args.device)
    tb.log_environment(device)
    k = tb.knobs(steps=10, warmup=2)
    w = tb.build_workload(tb.phase_overrides(k.batch), k, device, tb.SMALL if args.small else None)
    print(json.dumps(run_phases(w, k.steps, k.warmup, device), indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
