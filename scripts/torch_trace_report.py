"""A device trace of a bench workload through the PyTorch port, summarised
by kernel and by category (scripts/trace_report.py's report).

    python3 scripts/torch_trace_report.py cxr           # image encoder forward
    python3 scripts/torch_trace_report.py step          # full train step (BENCH_FINETUNE=1: fine-tuned)
    python3 scripts/torch_trace_report.py step_cached   # train step with the note-embedding cache attached
    python3 scripts/torch_trace_report.py bert          # chunk-BERT forward
    python3 scripts/torch_trace_report.py step --device cpu --small   # tiny widths, CPU ops

Env BENCH_BATCH / BENCH_CHUNKS / BENCH_FINETUNE as in torch_bench.py, with
scripts/trace_report.py's overrides (the config's own GELU and LN: poly,
bf16); TRACE_STEPS (3) calls are traced after 2 untraced ones; TRACE_DIR,
where set, receives the Chrome trace.

``torch.profiler`` records CPU and CUDA activity over the window; the host
clock around it, closed by a synchronisation, is its wall time. The report
gives the kernels by total ms with their calls, the total over every kernel
before the top-N cut, the totals by category (``CATEGORIES``, first match
wins, ``uncategorized`` for the rest) and the device's busy and idle share
of the wall time. A trace that holds no kernel fails; one whose attention
forward or capsule routing launches differ from the wrappers' counters lost
events and is taken again, up to ``TRACE_TRIES`` times, then fails. On the
CPU the rows are the CPU ops by self time, and no share is given.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time
from typing import Callable, Dict, Iterable, List, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_bench as tb  # noqa: E402

# (category, pattern on the kernel's name): the first that matches wins
CATEGORIES = (
    ("attention (K1, K2, K4)", r"attn::"),
    ("capsule routing (K3)", r"capsule_routing"),
    ("normalization", r"layer_norm|batch_norm|group_norm|LayerNorm|BatchNorm|GroupNorm|bn_fw|bn_bw"),
    ("convolution", r"fprop|dgrad|wgrad|conv|winograd|cudnn|nchwToNhwc|nhwcToNchw"),
    ("gemm", r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitK"),
    ("reduction", r"reduce|Reduce|softmax|SoftMax|cumsum|scan"),
    ("copies", r"Memcpy|Memset|copy|Copy|CatArray|index|gather|scatter"),
    ("elementwise", r"elementwise|Functor|foreach|multi_tensor_apply"),
)
# the kernels whose launches the trace is held to: (trace name, counters)
HELD = (("attention_fwd_wgmma_kernel", ("K1", "K4_fwd")), ("capsule_routing_kernel", ("K3",)))
TRACE_TRIES = 3


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "uncategorized"


def summarize(events: Iterable[Tuple[str, float, int]], top: int = 40):
    """(name, ms, calls) events -> (the `top` rows by total ms, ms by
    category, the total over every event)."""
    per_op: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for name, ms, calls in events:
        per_op[name][0] += ms
        per_op[name][1] += calls
    rows = sorted(({"op": n, "ms": ms, "calls": c, "category": category(n)} for n, (ms, c) in per_op.items()),
                  key=lambda r: -r["ms"])
    total_ms = sum(r["ms"] for r in rows)  # over every op, before the top-N cut
    by_cat: Dict[str, float] = collections.defaultdict(float)
    for r in rows:
        by_cat[r["category"]] += r["ms"]
    return rows[:top], dict(sorted(by_cat.items(), key=lambda kv: -kv[1])), total_ms


def forward_launches() -> Dict[str, int]:
    """The launch counters a trace is held to: K1, K3 and the forward of K4a and K4b."""
    from multimodalrouting_tpu_torch.ops.flash import flash_self_attention, splash_self_attention

    counts = tb.launch_counts()
    return {"K1": counts["K1"], "K3": counts["K3"],
            "K4_fwd": flash_self_attention.launches + splash_self_attention.launches}


def kernel_events(prof) -> List[Tuple[str, float, int]]:
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us() / 1e3, 1) for e in prof.events() if e.device_type == DeviceType.CUDA]


def cpu_op_events(prof) -> List[Tuple[str, float, int]]:
    return [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()]


def trace_window(run: Callable, steps: int, device, trace_dir: str = "") -> Dict:
    """`steps` calls of `run` under torch.profiler -> the events, the wall
    ms, and on the card the trace's and the counters' launches (retraced
    until they agree, at most TRACE_TRIES times)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(TRACE_TRIES):
        before = forward_launches()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                run()
            if cuda:
                torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        if not cuda:
            events, traced, counted = cpu_op_events(prof), None, None
            break
        events = kernel_events(prof)
        if not events:
            raise RuntimeError("the trace holds no device kernel: torch.profiler recorded no CUDA activity")
        after = forward_launches()
        counted = {name: sum(after[c] - before[c] for c in counters) for name, counters in HELD}
        traced = {name: sum(1 for n, _, _ in events if name in n) for name, _ in HELD}
        if traced == counted:
            break
        print(f"[trace] launches in the trace {traced}, counted {counted}: events lost, tracing again", flush=True)
    else:
        raise RuntimeError(f"the trace holds {traced} launches where the counters read {counted}, {TRACE_TRIES} times")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
    return {"events": events, "wall_ms": wall_ms, "traced": traced, "counted": counted}


def report(mode: str, window: Dict, steps: int, device, top: int = 25) -> Dict:
    """The JSON report of a trace window."""
    rows, by_cat, total_ms = summarize(window["events"], top)
    out = {"mode": mode, "steps_traced": steps, "device": tb.device_name(device),
           "events": "cuda kernels" if device.type == "cuda" else "cpu ops, self time",
           "total_ms": round(total_ms, 3), "wall_ms": round(window["wall_ms"], 3)}
    if device.type == "cuda":
        busy = total_ms / window["wall_ms"]
        out.update(busy_share=round(busy, 4), idle_share=round(max(0.0, 1 - busy), 4),
                   launches_traced=window["traced"], launches_counted=window["counted"])
    out["by_category_ms"] = {k: round(v, 3) for k, v in by_cat.items()}
    out["top_ops"] = [{"op": r["op"], "ms": round(r["ms"], 3), "calls": r["calls"], "cat": r["category"]}
                      for r in rows]
    return out


def workload(mode: str, device, extra=None) -> Callable:
    """The callable of one traced call of `mode` (trace_report.py's workloads)."""
    k = tb.knobs()
    w = tb.build_workload(tb.phase_overrides(k.batch), k, device, extra)
    if mode == "step":
        return lambda: w.force(w.step_once())
    if mode == "step_cached":
        from multimodalrouting_tpu_torch.data.batches import batch_to
        from multimodalrouting_tpu_torch.train.loop import note_pack_bucket
        from multimodalrouting_tpu_torch.train.text_cache import attach_note_cache

        cohort = attach_note_cache(w.cfg, w.model, w.cohort)
        w.batch, w.cap = batch_to(cohort, w.batch.x_struct.device), note_pack_bucket(w.cfg, cohort)
        return lambda: w.force(w.step_once())
    import torch_bench_phases as phases

    mods = phases.phase_modules(w.cfg, device)
    if mode == "cxr":
        fn = phases.phase_calls(w, mods)["cxr_fwd"]
        return lambda: float(fn()[2].reshape(-1)[0].float())
    if mode == "bert":  # trace_report.py's BERT forward runs without the note pack
        def bert():
            with torch.inference_mode():
                return float(mods["bert"](w.batch.notes_dict())[2].reshape(-1)[0].float())
        return bert
    raise ValueError(f"unknown mode {mode!r}: cxr, step, step_cached or bert")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="step", choices=["cxr", "step", "step_cached", "bert"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="tiny widths for the CPU")
    args = ap.parse_args(argv)
    device = tb.bench_device(args.device)
    tb.log_environment(device)
    steps = int(os.environ.get("TRACE_STEPS", "3"))
    run = workload(args.mode, device, tb.SMALL if args.small else None)
    for _ in range(2):  # warm
        run()
    window = trace_window(run, steps, device, os.environ.get("TRACE_DIR", ""))
    print(json.dumps(report(args.mode, window, steps, device), indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
