"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload pheno.train_finetune --seed 7 --seconds 45 --trace 0

Runs the PyTorch and CUDA port (``multimodalrouting_tpu_torch``) on the CUDA
card: set-up (weights and inputs from ``--seed``, every shape the cell uses
warmed), a window of ``--seconds``, then the check of what the window
produced against the plain reference (``portbench/reference``). With
``--trace 0`` the last line of standard output holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones (a traced window follows the
measured one). The numbers compared, each beside its limit, are the last
lines of standard error and the last key of the result.

Exits non-zero, printing no result, where no CUDA card is found (no CPU
fallback), where the cell asks for more cards than there are, and where
JAX, flax or the JAX package ``multimodalrouting_tpu`` were loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalrouting_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's, flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, *, t_start: float = T_START,
             cell_overrides=None, hooks=None, root: str = REPO) -> dict:
    """One run of a cell -> the result line (without printing it)."""
    import importlib

    from portbench.harness import manifest

    cell = manifest.cell(manifest.benchmark(root), workload, root)
    if cell_overrides:
        cell = cell_overrides(cell)
    runner = importlib.import_module(cell["runner"])
    res = runner.run(cell, seed, seconds, trace, device, t_start, hooks)
    checks = res["checks"]
    correct = res["failed"] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                         for c in checks.values())
    line = {"correct": bool(correct), "attempted": int(res["attempted"]), "failed": int(res["failed"])}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": int(cell["workload"]["chips"]),
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if trace:
        ctx = res["layer_ctx"]
        metrics = {}
        for m in cell["per_layer"]:
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev.update(busy_s=float(ctx["busy_s"]), window_s=float(ctx["window_s"]))
        line.update(metrics=metrics, device=dev)
        from portbench.harness.trace import top

        line["breakdown"] = {"device_ops": top(ctx["kernel_s"]), "idle_gaps": top(ctx["idle_by_host_op"])}
    else:
        line.update(metrics={m["name"]: {"value": float(res["metrics"][m["name"]]), "unit": m["unit"]}
                             for m in cell["end_to_end"]}, device=dev)
    line["checks"] = checks
    return line


def device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import manifest

    chips = int(next(w for w in manifest.benchmark()["workloads"] if w["name"] == args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"[portbench] {args.workload} seed {args.seed}: card {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
