"""End-to-end learning evidence for every CLI family on one synthetic cohort,
through the PyTorch port's CLI (scripts/demo_families.py's 18 runs, with
the same labels, argv and --set lists):

  1. capsule / mort / 7 routes  (MortModel/main.py linear-fusion path)
  2. capsule / pheno / 10 routes (PhenoModel PCA flagship, 25 labels)
  3. gated_concat 3-stage chain  (Model/ train_step1 -> step2 -> step3,
     params chained with --init-from), and step3 with loss-based gates
  4. fame uni -> bi -> tri curriculum (train_fame.py sMRO staging),
     plus the tri stage rerun with loss-based EMA gates (INSPECT/train_fame.py)
  5. capsule with the per-route MulT fusion family
     (PhenoModel/routing_and_heads_atten.py bi/tri_fusion_mode=mult)
  6. unimodal drivers (01_BEHRT 3-task, the note encoder, OMOP, CT and the
     INSPECT impressions text path)
  7. late_fusion + trimf baselines

    python3 scripts/torch_demo_families.py --epochs 6 --n 256 --out /tmp/families
    python3 scripts/torch_demo_families.py --device cpu --small --only capsule-mort-7

Flagship widths unless --small. Each command runs in-process
(``multimodalrouting_tpu_torch.cli.main``) with ``--device`` appended, on the
CUDA card unless given ``--device cpu``; without a card the script exits
non-zero before the first run. Each run records its val-AUROC trajectory
(history.json, or unimodal_metrics.json) and each kernel's launches over
the command (``launches``: K1, K2, K3, K4; the CLI's synthetic path clips
notes to 128 tokens, below the attention kernels' gate, so only K3 runs,
once per capsule forward). The summary is merged into OUT/summary.json,
a table goes to stdout, and the exit code is the largest rc. --harvest
rebuilds the rows from the run directories without training; --only takes
comma-separated labels (keep a chain's stages together: a later stage reads
the earlier one's OUT directory); --seed N sets ``train.seed`` in every
run, for a second draw of a family whose AUROC falls far from its JAX row
(the JAX script has no such flag; without it the commands are its own).
Keep --out outside anything copied back
from a card run: each run writes a final checkpoint (~1 GB at full width).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench as tb  # noqa: E402

SMALL_SETS = [
    "encoder.d=48", "encoder.structured_seq_len=16", "encoder.structured_n_feats=16",
    "encoder.structured_layers=1", "encoder.structured_heads=4",
    "encoder.bert_hidden=48", "encoder.bert_layers=2", "encoder.bert_heads=4",
    "encoder.bert_intermediate=96", "encoder.bert_vocab_size=2048",
    "encoder.bert_max_position=64", "encoder.notes_max_chunks=2",
    "encoder.text_max_len=32", "encoder.image_size=32",
    "encoder.vision_backbone=resnet18", "encoder.vision_norm=group",
    "model.d=48", "model.mult_layers=1", "model.mult_self_layers=1",
    "model.mult_heads=4", "model.pc_dim=8", "model.mc_caps_dim=16",
    "train.batch_size=16",
]


def train_row(row, path):
    """`row` with the first and best val AUROC and the epochs of the
    history.json at `path`, where it holds an epoch."""
    if os.path.exists(path):
        with open(path) as f:
            hist = json.load(f)
        if hist:
            row["val_auroc_first"] = round(hist[0].get("val_auroc", 0.0), 4)
            row["val_auroc_best"] = round(max(h.get("val_auroc", 0.0) for h in hist), 4)
            row["epochs"] = len(hist)
    return row


def run(cli_main, label, argv, results, history_dir):
    print(f"\n===== {label} =====", flush=True)
    t0 = time.perf_counter()
    rc = cli_main(argv)
    dt = time.perf_counter() - t0
    # train writes history.json next to the checkpoint
    row = {"label": label, "rc": rc, "sec": round(dt, 1)}
    results.append(train_row(row, os.path.join(history_dir, "history.json")))
    return rc


def unimodal_row(row, path, auroc_of):
    """`row` with the AUROC (`auroc_of` the metrics dict) and the val-loss
    history of unimodal_metrics.json at `path`, where it exists."""
    if os.path.exists(path):
        with open(path) as f:
            m = json.load(f)
        auroc = auroc_of(m.get("metrics", {}))
        if auroc is not None:
            row["val_auroc_best"] = round(auroc, 4)
        hist = m.get("history", [])
        if hist:
            row["epochs"] = len(hist)
            row["val_loss_first"] = round(hist[0].get("val_loss", 0.0), 4)
            row["val_loss_last"] = round(hist[-1].get("val_loss", 0.0), 4)
    return row


def best_auroc(metrics):
    aurocs = [v.get("auroc") for v in metrics.values() if v.get("auroc") is not None]
    return max(aurocs) if aurocs else None


def run_unimodal(cli_main, label, modality, task, args, base, out, results):
    """Drive `cli unimodal` and harvest its val-loss history + AUROC."""
    print(f"\n===== {label} =====", flush=True)
    t0 = time.perf_counter()
    argv = ["unimodal", "--modality", modality, "--task", task,
            "--epochs", str(args.epochs), "--out", out]
    for s in base:
        argv += ["--set", s]
    rc = cli_main(argv)
    dt = time.perf_counter() - t0
    row = {"label": label, "rc": rc, "sec": round(dt, 1)}
    results.append(unimodal_row(row, os.path.join(out, "unimodal_metrics.json"), best_auroc))
    return rc


def write_impressions(n, out):
    """A learnable impressions CSV of `n` patients (the pe label leaks into
    the wording, as in real radiology impressions), from default_rng(0)
    -> its path."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(0)
    pos = ["filling defect in the segmental pulmonary artery consistent with embolism",
           "acute pulmonary embolus identified bilateral lower lobes"]
    neg = ["no evidence of pulmonary embolism lungs are clear",
           "unremarkable study no acute cardiopulmonary process"]
    rows = []
    for pid in range(n):
        pe = int(rng.random() < 0.4)
        for _ in range(int(rng.integers(1, 3))):
            rows.append({
                "person_id": pid,
                "impression_text": (pos if pe else neg)[int(rng.integers(2))],
                "pe_positive_nlp": pe,
                "1_month_mortality": int(rng.random() < 0.3),
                "year_of_birth": int(2130 - rng.integers(20, 95)),
            })
    csv = os.path.join(out, "impressions.csv.gz")
    pd.DataFrame(rows).to_csv(csv, index=False, compression="gzip")
    return csv


def run_impressions(cli_main, label, args, base, out, results):
    """Drive the INSPECT text-only 4-task path (cli unimodal
    --impressions-csv) on write_impressions' CSV."""
    print(f"\n===== {label} =====", flush=True)
    os.makedirs(out, exist_ok=True)
    csv = write_impressions(args.n, out)
    t0 = time.perf_counter()
    argv = ["unimodal", "--modality", "note", "--impressions-csv", csv,
            "--epochs", str(args.epochs), "--out", out]
    for s in base:
        argv += ["--set", s]
    rc = cli_main(argv)
    dt = time.perf_counter() - t0
    row = {"label": label, "rc": rc, "sec": round(dt, 1)}
    results.append(unimodal_row(row, os.path.join(out, "unimodal_metrics.json"),
                                lambda m: m.get("pe_positive_nlp", {}).get("auroc")))
    return rc


def harvest(label, d):
    """The row --harvest rebuilds from run directory `d` (rc 0, no
    seconds), or None."""
    hist_path = os.path.join(d, "history.json")
    uni_path = os.path.join(d, "unimodal_metrics.json")
    if os.path.exists(hist_path):
        row = train_row({"label": label, "rc": 0}, hist_path)
        return row if "epochs" in row else None
    if os.path.exists(uni_path):
        return unimodal_row({"label": label, "rc": 0, "epochs": 0}, uni_path, best_auroc)
    return None


LABEL_DIRS = {
    "capsule-mort-7": "cap7", "capsule-pheno-10": "pheno10",
    "gated-step1": "g1", "gated-step2": "g2", "gated-step3": "g3",
    "gated-step3-lossbased": "g3lb", "fame-uni": "fu", "fame-bi": "fb",
    "fame-tri": "ft", "fame-tri-lossbased": "ftlb",
    "capsule-mult-fusion": "cmult", "unimodal-behrt": "ub",
    "unimodal-note": "un", "unimodal-omop": "uo", "unimodal-ct": "uc",
    "unimodal-impressions": "ui",
    "late_fusion": "lf", "trimf": "tm",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", default="runs/families")
    ap.add_argument("--small", action="store_true", help="tiny dims for CPU")
    ap.add_argument("--only", default=None, help="comma-separated run labels")
    ap.add_argument("--patience", type=int, default=3, help="early-stop patience")
    ap.add_argument("--harvest", action="store_true",
                    help="rebuild summary rows from on-disk run artifacts "
                         "(history.json / unimodal_metrics.json) without "
                         "re-training — for recovering from a killed run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=None,
                    help="train.seed of every run, for a second draw (default: the config's)")
    args = ap.parse_args(argv)

    from multimodalrouting_tpu_torch.cli import main as port_cli_main

    device = tb.bench_device(args.device)
    tb.log_environment(device)
    launches = {}

    def cli_main(cli_argv):
        """The port's CLI on --device; its launches kept in `launches`."""
        before = tb.launch_counts()
        rc = port_cli_main([*cli_argv, "--device", args.device])
        launches.update(tb.counts_since(before))
        return rc

    base = [
        "data.synthetic_n=" + str(args.n),
        "train.min_epochs=0",
        f"train.early_stop_patience={args.patience}",
        "train.encoder_warmup_epochs=1",
        "train.ckpt_every=0",
        # learning evidence, not speed: note packing is output-identical
        "encoder.note_pack=false",
        # short demo runs: EMA(0.999) over <100 steps evaluates ~90%-initial
        # weights and underreports learning
        "train.use_ema=false",
    ]
    if args.small:
        base += SMALL_SETS
    if args.seed is not None:
        base.append(f"train.seed={args.seed}")

    def argv_for(out, family, extra_flags=(), extra_sets=()):
        a = ["train", "--family", family, "--epochs", str(args.epochs), "--out", out]
        a += list(extra_flags)
        for s in list(base) + list(extra_sets):
            a += ["--set", s]
        return a

    results = []
    O = args.out  # noqa: E741
    runs = {
        "capsule-mort-7": lambda: run(
            cli_main, "capsule-mort-7",
            argv_for(f"{O}/cap7", "capsule", ["--task", "mort", "--routes", "7"],
                     ["train.route_dropout_p=0.1"]),
            results, f"{O}/cap7"),
        "capsule-pheno-10": lambda: run(
            cli_main, "capsule-pheno-10",
            argv_for(f"{O}/pheno10", "capsule", ["--task", "pheno", "--routes", "10"],
                     ["model.num_classes=25", "train.route_dropout_p=0.1"]),
            results, f"{O}/pheno10"),
        "gated-step1": lambda: run(
            cli_main, "gated-step1",
            argv_for(f"{O}/g1", "gated_concat", ["--task", "mort", "--routes", "7",
                                                 "--stage", "step1"]),
            results, f"{O}/g1"),
        "gated-step2": lambda: run(
            cli_main, "gated-step2",
            argv_for(f"{O}/g2", "gated_concat", ["--task", "mort", "--routes", "7",
                                                 "--stage", "step2",
                                                 "--init-from", f"{O}/g1"]),
            results, f"{O}/g2"),
        "gated-step3": lambda: run(
            cli_main, "gated-step3",
            argv_for(f"{O}/g3", "gated_concat", ["--task", "mort", "--routes", "7",
                                                 "--stage", "step3",
                                                 "--init-from", f"{O}/g2"]),
            results, f"{O}/g3"),
        "gated-step3-lossbased": lambda: run(
            cli_main, "gated-step3-lossbased",
            argv_for(f"{O}/g3lb", "gated_concat", ["--task", "mort", "--routes", "7",
                                                   "--stage", "step3",
                                                   "--init-from", f"{O}/g2"],
                     ["model.gate_mode=loss_based"]),
            results, f"{O}/g3lb"),
        "fame-uni": lambda: run(
            cli_main, "fame-uni",
            argv_for(f"{O}/fu", "fame", ["--task", "mort", "--routes", "7",
                                         "--stage", "uni"]),
            results, f"{O}/fu"),
        "fame-bi": lambda: run(
            cli_main, "fame-bi",
            argv_for(f"{O}/fb", "fame", ["--task", "mort", "--routes", "7",
                                         "--stage", "bi", "--init-from", f"{O}/fu"]),
            results, f"{O}/fb"),
        "fame-tri": lambda: run(
            cli_main, "fame-tri",
            argv_for(f"{O}/ft", "fame", ["--task", "mort", "--routes", "7",
                                         "--stage", "tri", "--init-from", f"{O}/fb"]),
            results, f"{O}/ft"),
        "fame-tri-lossbased": lambda: run(
            cli_main, "fame-tri-lossbased",
            argv_for(f"{O}/ftlb", "fame", ["--task", "mort", "--routes", "7",
                                           "--stage", "tri", "--init-from", f"{O}/fb"],
                     ["model.smro_gate_mode=loss_based"]),
            results, f"{O}/ftlb"),
        "capsule-mult-fusion": lambda: run(
            cli_main, "capsule-mult-fusion",
            argv_for(f"{O}/cmult", "capsule", ["--task", "mort", "--routes", "10"],
                     ["model.bi_fusion_mode=mult", "model.tri_fusion_mode=mult",
                      "train.route_dropout_p=0.1"]),
            results, f"{O}/cmult"),
        "unimodal-behrt": lambda: run_unimodal(
            cli_main, "unimodal-behrt", "behrt", "multitask",
            args, base, f"{O}/ub", results),
        "unimodal-note": lambda: run_unimodal(
            cli_main, "unimodal-note", "note", "mort",
            args, base, f"{O}/un", results),
        "unimodal-omop": lambda: run_unimodal(
            cli_main, "unimodal-omop", "omop", "mort",  # --task ignored: 4-task INSPECT
            args, base, f"{O}/uo", results),
        "unimodal-ct": lambda: run_unimodal(
            cli_main, "unimodal-ct", "ct", "mort",  # --task ignored: 4-task INSPECT
            args, base, f"{O}/uc", results),
        "unimodal-impressions": lambda: run_impressions(
            cli_main, "unimodal-impressions", args, base, f"{O}/ui", results),
        "late_fusion": lambda: run(
            cli_main, "late_fusion",
            argv_for(f"{O}/lf", "late_fusion", ["--task", "mort", "--routes", "7"]),
            results, f"{O}/lf"),
        "trimf": lambda: run(
            cli_main, "trimf",
            argv_for(f"{O}/tm", "trimf", ["--task", "mort", "--routes", "7"]),
            results, f"{O}/tm"),
    }

    only = set(args.only.split(",")) if args.only else None
    if args.harvest:
        for label, d in LABEL_DIRS.items():
            if only and label not in only:
                continue
            row = harvest(label, os.path.join(O, d))
            if row is not None:
                results.append(row)
    else:
        for label, fn in runs.items():
            if only and label not in only:
                continue
            fn()
            results[-1]["launches"] = dict(launches)
            print(f"[families] {label}: launches {json.dumps(launches)}", flush=True)

    os.makedirs(O, exist_ok=True)
    # merge into any existing summary so partial (--only) reruns update rows
    # in place instead of overwriting the full table
    path = os.path.join(O, "summary.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = {r["label"]: r for r in json.load(f)}
    for r in results:
        merged[r["label"]] = r
    ordered = [merged[k] for k in runs if k in merged]
    with open(path, "w") as f:
        json.dump(ordered, f, indent=2)
    print("\n===== family summary =====")
    for r in results:
        best = r.get("val_auroc_best", float("nan"))
        first = r.get("val_auroc_first", float("nan"))
        print(f"{r['label']:24s} rc={r['rc']} auroc {first:.4f} -> {best:.4f} "
              f"({r.get('epochs', 0)} epochs, {r.get('sec', '-')}s)")
    return max((r["rc"] for r in results), default=0)


if __name__ == "__main__":
    raise SystemExit(main())
