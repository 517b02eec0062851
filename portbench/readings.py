"""The program's readings of a cell's compared numbers over many seeds, in
one process: the lower readings that the limits are set from.

    python3 portbench/readings.py --workload pheno.train_finetune --seeds 1,2,3 --seconds 1

Each seed is one ``run.py`` run (set-up, a window of ``--seconds``, the
comparison) without the process start; one JSON line a seed.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import time  # noqa: E402

import torch  # noqa: E402

from portbench.control import ALL_NUMBERS  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--rate", type=float, default=0.0, help="a serving mix's requests a second (a sweep)")
    ap.add_argument("--int8", action="store_true",
                    help="the program's own int8 note-encoder body switched on: the control of the frozen-BERT cells")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    def every_number(cell):
        cell["limits"] = {**{k: v for k, v in ALL_NUMBERS.items() if k not in cell["limits"]}, **cell["limits"]}
        if args.rate:
            cell["traffic"]["requests_per_s"] = args.rate
        if args.int8:
            cell["config"]["encoder"]["int8_text"] = True
        return cell

    for seed in (int(s) for s in args.seeds.split(",")):
        line = run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0), t_start=time.perf_counter(),
                        cell_overrides=every_number)
        print(json.dumps({"workload": args.workload, "seed": seed, "rate": args.rate, "int8": args.int8,
                          "correct": line["correct"],
                          "attempted": line["attempted"], "metrics": line["metrics"], "checks": line["checks"]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
