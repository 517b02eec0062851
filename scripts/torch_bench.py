"""bench.py's workload through the PyTorch port: ICU stays/sec/chip of the
flagship's full trimodal 10-route fwd+bwd train step.

    python3 scripts/torch_bench.py                        # the frozen leg on the CUDA card
    BENCH_FINETUNE=1 python3 scripts/torch_bench.py       # the fine-tuned-text leg
    python3 scripts/torch_bench.py --device cpu --small   # tiny widths on the CPU

The workload is bench.py's, knob for knob: BENCH_BATCH (16), BENCH_CHUNKS
(8), BENCH_STEPS (20), BENCH_WARMUP (3), BENCH_FINETUNE (0/1), BENCH_GELU
(poly), BENCH_LN (fp32); the same config overrides (dropouts 0); the seed-0
synthetic cohort; chunk packing at ``note_pack_bucket``'s capacity;
lr_head = lr_enc = train.lr. The warm-up steps, then the timed steps on the
host clock, closed by reading back the loss and one element of the first
parameter (on the card that readback waits for the device).

Earlier lines give the card's name and power limit, the two TF32 flags as
the run found them (nothing here sets them, as ``cli train`` sets none),
the note pack, each kernel's launches over the timed steps (K4 counts
K4a's and K4b's forward and backward), peak device memory and the first
and last timed losses. The last line is bench.py's JSON line: the same
keys and metric names, and vs_baseline against bench_baseline.json under
the same keys (the fine-tuned leg has none there, so it is null).

Without a CUDA card the script exits non-zero unless given ``--device
cpu``. scripts/torch_bench_phases.py and scripts/torch_trace_report.py
build their workloads here.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Mapping, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from multimodalrouting_tpu_torch.configs import Config, apply_overrides  # noqa: E402
from multimodalrouting_tpu_torch.data.batches import Batch, batch_to  # noqa: E402
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort  # noqa: E402

METRIC = "ICU stays/sec/chip fwd+bwd (10-route trimodal)"
FINETUNE_SUFFIX = " [fine-tuned text]"
BASELINE_KEYS = {False: "torch_cpu_stays_per_sec", True: "torch_cpu_finetune_stays_per_sec"}
log = functools.partial(print, flush=True)

# --small: tiny widths for a run on the CPU, BERT at 256 tokens x 128 hidden
# with 2 heads so the packed attention's gate holds
SMALL = {
    "encoder.d": 48, "encoder.structured_seq_len": 16, "encoder.structured_n_feats": 16,
    "encoder.structured_layers": 1, "encoder.structured_heads": 4, "encoder.bert_hidden": 128,
    "encoder.bert_layers": 2, "encoder.bert_heads": 2, "encoder.bert_intermediate": 96,
    "encoder.bert_vocab_size": 2048, "encoder.bert_max_position": 256, "encoder.text_max_len": 256,
    "encoder.image_size": 32, "encoder.vision_backbone": "resnet18", "model.d": 48, "model.mult_layers": 1,
    "model.mult_self_layers": 1, "model.mult_heads": 4, "model.pc_dim": 8, "model.mc_caps_dim": 16,
}


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The bench scripts' environment knobs."""

    batch: int = 16
    chunks: int = 8
    steps: int = 20
    warmup: int = 3
    finetune: bool = False


def knobs(environ: Mapping[str, str] = os.environ, steps: int = 20, warmup: int = 3) -> Knobs:
    """BENCH_BATCH, BENCH_CHUNKS, BENCH_STEPS, BENCH_WARMUP and BENCH_FINETUNE
    from `environ`; `steps` and `warmup` are the script's defaults."""
    return Knobs(
        batch=int(environ.get("BENCH_BATCH", "16")),
        chunks=int(environ.get("BENCH_CHUNKS", "8")),
        steps=int(environ.get("BENCH_STEPS", str(steps))),
        warmup=int(environ.get("BENCH_WARMUP", str(warmup))),
        finetune=environ.get("BENCH_FINETUNE", "0") == "1",
    )


def bench_overrides(batch_size: int, finetune: bool, environ: Mapping[str, str] = os.environ) -> Dict[str, Any]:
    """bench.py's config overrides (bench.py:40-61)."""
    return {
        "model.num_classes": 2,
        "model.routes": "10",
        "train.batch_size": batch_size,
        "model.attn_dropout": 0.0,
        "model.relu_dropout": 0.0,
        "model.res_dropout": 0.0,
        "model.embed_dropout": 0.0,
        "encoder.bert_gelu": environ.get("BENCH_GELU", "poly"),
        "encoder.bert_ln": environ.get("BENCH_LN", "fp32"),
        "encoder.finetune_text": finetune,
    }


def phase_overrides(batch_size: int, environ: Mapping[str, str] = os.environ) -> Dict[str, Any]:
    """The overrides of scripts/bench_phases.py:56-70 and
    scripts/trace_report.py:_mk: bench.py's without BENCH_GELU and
    BENCH_LN, so the config's own GELU (poly) and LN (bf16) run."""
    return {
        "model.num_classes": 2,
        "model.routes": "10",
        "train.batch_size": batch_size,
        "model.attn_dropout": 0.0,
        "model.relu_dropout": 0.0,
        "model.res_dropout": 0.0,
        "model.embed_dropout": 0.0,
        "encoder.finetune_text": environ.get("BENCH_FINETUNE", "0") == "1",
    }


def bench_device(name: str) -> torch.device:
    """The scripts' device: the card unless the caller asks for the CPU;
    asking for the card where there is none exits non-zero."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(name)


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None on the CPU)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch counter: K1, K2, K3, and K4 (K4a's and K4b's
    forward and backward together)."""
    from multimodalrouting_tpu_torch.ops.flash import flash_self_attention, splash_self_attention
    from multimodalrouting_tpu_torch.ops.flash_packed import packed_attention, packed_attention_bwd
    from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused

    k4 = sum(f.launches + f.bwd_launches for f in (flash_self_attention, splash_self_attention))
    return {"K1": packed_attention.launches, "K2": packed_attention_bwd.launches,
            "K3": capsule_routing_fused.launches, "K4": k4}


def counts_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def make_cohort(cfg: Config, k: Knobs) -> Batch:
    """bench.py's cohort: `k.batch` synthetic stays at the config's shapes
    with `k.chunks` note chunks, seed 0, the mortality task."""
    e = cfg.encoder
    return make_synthetic_cohort(
        k.batch, t=e.structured_seq_len, f=e.structured_n_feats, s=k.chunks, l=e.text_max_len,
        image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=0, task="mort",
    )


@dataclasses.dataclass
class Workload:
    """The flagship train step on one cohort: the model, its train state and
    step, the cohort on the device and its note pack."""

    cfg: Config
    cohort: Batch
    batch: Batch
    model: torch.nn.Module
    state: Any
    step: Callable
    cap: int
    generator: torch.Generator

    def step_once(self):
        lr = self.cfg.train.lr
        return self.step(self.state, self.batch, self.generator, lr, lr, note_pack=self.cap)

    def force(self, metrics) -> float:
        """Read the loss and one element of the first parameter back to the host."""
        return float(metrics.loss) + float(self.state.params()[0].detach().reshape(-1)[0])


def build_workload(overrides: Mapping[str, Any], k: Knobs, device, extra: Optional[Mapping[str, Any]] = None) -> Workload:
    """The port's Config() under `overrides` (then `extra`), the cohort, a
    capsule model seeded with 0 on `device`, its train state and step."""
    from multimodalrouting_tpu_torch.models.full import build_model
    from multimodalrouting_tpu_torch.train.loop import note_pack_bucket
    from multimodalrouting_tpu_torch.train.state import create_train_state
    from multimodalrouting_tpu_torch.train.steps import make_train_step

    cfg = apply_overrides(Config(), {**overrides, **(extra or {})})
    cohort = make_cohort(cfg, k)
    torch.manual_seed(0)
    model = build_model(cfg, "capsule", device=device, train=True)
    state = create_train_state(cfg, model)
    dev = next(model.parameters()).device
    return Workload(
        cfg=cfg, cohort=cohort, batch=batch_to(cohort, dev), model=model, state=state,
        step=make_train_step(cfg, model, "capsule"), cap=note_pack_bucket(cfg, cohort),
        generator=torch.Generator(device=dev).manual_seed(cfg.train.seed),
    )


def result_line(stays_per_sec: float, finetune: bool, baseline_path: str = os.path.join(ROOT, "bench_baseline.json")):
    """bench.py's last line."""
    baseline = None
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            baseline = json.load(f).get(BASELINE_KEYS[finetune])
    return {
        "metric": METRIC + (FINETUNE_SUFFIX if finetune else ""),
        "value": round(stays_per_sec, 3),
        "unit": "stays/sec/chip",
        "vs_baseline": round(stays_per_sec / baseline, 3) if baseline else None,
    }


def run_bench(k: Knobs, device, extra: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """One leg of bench.py: `k.warmup` steps, then `k.steps` timed ones.
    -> the JSON line (``line``), the launches over the timed steps, the
    first and last timed losses and the workload."""
    w = build_workload(bench_overrides(k.batch, k.finetune), k, device, extra)
    dev = w.batch.x_struct.device
    e = w.cfg.encoder
    valid = int(w.cohort.chunk_mask.sum())
    log(f"[bench] note pack: capacity {w.cap} of {w.cohort.chunk_mask.size} chunk slots, {valid} valid; "
        f"GELU {e.bert_gelu}, LN {e.bert_ln}, finetune_text {e.finetune_text}, batch {k.batch}")
    metrics = None
    for _ in range(k.warmup):
        metrics = w.step_once()
    if metrics is not None:
        w.force(metrics)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    timed = [w.step_once() for _ in range(k.steps)]
    w.force(timed[-1])
    dt = time.perf_counter() - t0
    launches = counts_since(before)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    losses = [float(timed[0].loss), float(timed[-1].loss)]
    stays_per_sec = k.batch * k.steps / dt
    log(f"[bench] launches over {k.steps} timed steps: {json.dumps(launches)}; per step "
        f"{json.dumps({n: c / k.steps for n, c in launches.items()})}; expected per step K1 {e.bert_layers}, "
        f"K2 {e.bert_layers if e.finetune_text else 0}, K3 1, K4 0")
    log(f"[bench] step_ms={dt / k.steps * 1e3:.2f} peak_memory_gb="
        f"{'not measured' if peak_gb is None else f'{peak_gb:.2f}'} "
        f"loss first={losses[0]:.6f} last={losses[1]:.6f}")
    return {"line": result_line(stays_per_sec, k.finetune), "launches": launches, "losses": losses, "workload": w}


def log_environment(device: torch.device) -> None:
    """The card's name and power limit, and the TF32 flags as found."""
    card = card_line(device)
    log(f"[env] torch {torch.__version__} on {device_name(device)}" + (f" ({card})" if card else ""))
    log(f"[env] tf32: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (as found; set by nothing here)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="tiny widths for the CPU")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    log_environment(device)
    out = run_bench(knobs(), device, SMALL if args.small else None)
    log(json.dumps(out["line"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
