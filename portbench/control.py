"""The correctness control: the plain reference in the program's place,
with every product's inputs in float8 e4m3 (the step below the
configurations' bfloat16), compared with the float32 reference by the
cell's own comparison. A sound limit fails it.

    python3 portbench/control.py --workload pheno.train_finetune --seeds 11,12,13

prints one JSON line of the compared numbers a seed. Training cells compare
the first three steps from the cell's weights and batches; the serving cell
scores the cell's first ``checked_requests`` requests.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from portbench.harness import manifest, traffic, weights as weights_mod  # noqa: E402
from portbench.reference import model as ref  # noqa: E402

# every number the comparisons work out, with no limit: for readings
ALL_NUMBERS = {k: float("inf") for k in ("loss_gap", "grad_gap", "change_gap", "later_loss_gap", "grad_gap_worst",
                                           "change_gap_worst",
                                           "head_gap", "alpha_gap", "calibration_gap", "decision_flips",
                                           "top_route_flips")}


def half_batches(batches):
    """A planted fault: each batch's first half only (the mean over the rest)."""
    return [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]


def train_control(cell, seed: int, device, fault: str = "") -> dict:
    from portbench.harness.train_cell import COMPARED_STEPS, batch_fields, compare
    from portbench.reference.train import reference_steps

    cfg_d, mix = cell["config"], cell["traffic"]
    w = weights_mod.make_weights(cfg_d, seed, device)
    pool = traffic.make_pool(mix, cfg_d, mix["batch"] * mix["pool_batches"], seed, device)
    order = traffic.train_order(mix, pool.labels, seed)
    batches = [batch_fields(pool, idx) for idx in order[:COMPARED_STEPS]]
    exact = reference_steps(w, cfg_d, batches, ref.Numerics())
    if fault == "half_batch":
        low = reference_steps(w, cfg_d, half_batches(batches), ref.Numerics())
    else:
        low = reference_steps(w, cfg_d, batches, ref.Numerics("fp8"))
    return compare(cell["limits"], low["losses"], low["grad_norms"], low["change_norms"], exact)


def serve_control(cell, seed: int, device) -> dict:
    from portbench.harness.serve_cell import checkpoint_meta, compare, row_arrays
    from portbench.reference.serve import reference_rows

    cfg_d, mix = cell["config"], cell["traffic"]
    w = weights_mod.make_weights(cfg_d, seed, device)
    temperature, thresholds = checkpoint_meta(cfg_d, seed)
    pool = traffic.make_pool(mix, cfg_d, mix["pool"], seed, device, float_images=True)
    records = traffic.host_records(pool)
    sizes = traffic.request_sizes(mix, seed)
    stays = traffic.request_stays(sizes, len(records), seed)
    recs = [records[s] for i in range(mix["checked_requests"]) for s in stays[i]]
    exact = reference_rows(w, cfg_d, recs, temperature, thresholds, ref.Numerics())
    low = reference_rows(w, cfg_d, recs, temperature, thresholds, ref.Numerics("fp8"))
    yard = reference_rows(w, cfg_d, recs, temperature, thresholds, ref.Numerics("bf16"))
    routes = list(ref.ROUTES)
    rows = [{"probs": p, "pred": d, "alpha": dict(zip(routes, a)), "top_routes": [routes[k] for k in t]}
            for p, d, a, t in zip(low["probs"], low["pred"], low["alpha"], low["top"])]
    got = row_arrays(rows, routes, [low["logits"]])
    return compare(cell["limits"], got, exact, yard, routes, thresholds, temperature, cfg_d["model"]["task"])


def control_checks(cell, seed: int, device, fault: str = "") -> dict:
    """The control's numbers (or, with `fault`, a fault's planted in the
    reference put in the program's place) against the float32 reference."""
    with ref.fp32_products():
        if cell["traffic"]["kind"] == "train":
            return train_control(cell, seed, device, fault)
        return serve_control(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", default="", choices=["", "half_batch"],
                    help="plant this fault in the float32 reference instead of the float8 control")
    ap.add_argument("--all", action="store_true", help="every number worked out, compared or not")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.benchmark(), args.workload)
    if args.all:
        cell["limits"] = {**ALL_NUMBERS, **cell["limits"]}
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed, torch.device("cuda", 0), args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.fault or "fp8", "checks": checks}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
