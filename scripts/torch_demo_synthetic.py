"""The learning run of scripts/demo_synthetic.py through the PyTorch port's CLI:
train the flagship (`cli train --family capsule --task mort --routes 10`)
on the synthetic cohort with that script's --set list, then `cli eval
--drop-table` on its final checkpoint.

    python3 scripts/torch_demo_synthetic.py --n 1024 --epochs 12 --out /tmp/demo

Runs on the CUDA card (``--device cpu`` and ``--small``, that script's tiny
widths, for a run on the CPU). Prints the CLI's output, then one JSON line:
the card's name and power limit (nvidia-smi), the best validation AUROC,
the test metrics (AUROC, AUPRC, ECE, the fitted temperature), the drop
table, seconds per epoch and K3's launches over train and eval. It also
rebuilds the drop table's rand1 row (one random modality dropped per stay)
from the single-drop rows' probabilities, stay by stay: the two agree
where every stay is scored independently of the others in its batch, and
then rand1 falls below the single drops only by how far each condition
moves the probabilities (their means are printed).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# scripts/demo_synthetic.py's --set list (with --n)
SETS = [
    "train.min_epochs=0",
    "train.early_stop_patience=3",
    "train.encoder_warmup_epochs=1",
    "train.route_dropout_p=0.1",
    "train.ckpt_every=0",
]
SMALL = [
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
CONDITIONS = ("full", "dropL", "dropN", "dropI", "rand1")


def run(main, argv):
    """main(argv) in-process; its output echoed and returned as lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    print(buf.getvalue(), end="", flush=True)
    if rc != 0:
        raise SystemExit(f"cli {argv[0]} exited {rc}")
    return buf.getvalue().splitlines()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", default="runs/torch_demo")
    ap.add_argument("--small", action="store_true", help="tiny dims for CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import numpy as np

    from multimodalrouting_tpu_torch.audit import droptable
    from multimodalrouting_tpu_torch.cli import main as cli_main
    from multimodalrouting_tpu_torch.metrics.classification import auroc
    from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused

    card = None
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sets = [f"data.synthetic_n={args.n}", *SETS, *(SMALL if args.small else [])]
    argv = ["train", "--family", "capsule", "--task", "mort", "--routes", "10", "--epochs", str(args.epochs),
            "--out", args.out, "--device", args.device]
    for s in sets:
        argv += ["--set", s]
    capsule_routing_fused.launches = 0
    summary = json.loads(run(cli_main, argv)[-1])
    k3_train = capsule_routing_fused.launches
    scored = []  # (batch, probabilities) per drop-table condition, in CONDITIONS order
    drop_table_eval = droptable.drop_table_eval

    def recording(predict_fn, batch, **kwargs):
        return drop_table_eval(lambda b: scored.append((b, predict_fn(b))) or scored[-1][1], batch, **kwargs)

    droptable.drop_table_eval = recording
    lines = run(cli_main, ["eval", "--ckpt", args.out, "--family", "capsule", "--drop-table",
                           "--device", args.device])
    k3_eval = capsule_routing_fused.launches - k3_train
    metrics = json.loads("\n".join(lines[lines.index("{"): lines.index("}") + 1]))
    with open(os.path.join(args.out, "history.json")) as f:
        history = json.load(f)
    drop = {}
    for line in lines:
        cells = line.replace("(", " ").replace(")", " ").split()
        if cells and cells[0] in CONDITIONS:
            drop[cells[0]] = [float(c) for c in cells[1:]]
    secs = [row["sec"] for row in history]
    probs = {cond: p for cond, (_, p) in zip(CONDITIONS, scored)}
    mixed = scored[CONDITIONS.index("rand1")][0]
    dropped = [np.asarray(getattr(mixed, f"has_{m}")) == 0 for m in "lni"]
    rebuilt = np.select(dropped, [probs["dropL"], probs["dropN"], probs["dropI"]], probs["full"])
    y = np.asarray(mixed.y)
    print(json.dumps({
        "card": card, "device": args.device, "n": args.n, "epochs_ran": len(history),
        "best_val_auroc": summary["best_val_auroc"], "temperature": summary["temperature"],
        "test": {k: metrics[k] for k in ("auroc", "auprc", "f1", "ece", "temperature")},
        "drop_table_auroc_auprc_f1_with_deltas": drop,
        "sec_first_epoch": secs[0], "sec_steady_epoch": sorted(secs[1:])[len(secs[1:]) // 2] if secs[1:] else None,
        "sec_per_epoch": secs, "val_auroc": [row["val_auroc"] for row in history],
        "k3_launches": {"train": k3_train, "eval": k3_eval},
        "mean_prob_by_condition": {cond: float(np.mean(p)) for cond, p in probs.items()},
        "rand1_rebuilt": {"max_abs_diff": float(np.abs(rebuilt - probs["rand1"]).max()),
                          "auroc": auroc(y, rebuilt), "auroc_as_scored": auroc(y, probs["rand1"])},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
