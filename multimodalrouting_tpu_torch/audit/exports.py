"""Route-audit exports: alpha/R heatmap tables, CSV/NPY artifacts.

The port's copy of multimodalrouting_tpu/audit/exports.py (numpy only;
the same file names and contents).

Parity target: reference MIMIC-IV/MortModel/Paired_Cross_Attention/main.py —
save_array_with_versions (:522-570, raw + normalized variants as CSV+NPY),
generate_split_heatmaps_and_tables (:2455-2594, per-split mean alpha [R] and
mean R [R,K] with p(route|label) and p(label|route) duals). Plot rendering is
optional (matplotlib may be absent); tables/arrays are always written.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np


def save_array_with_versions(
    arr: np.ndarray,
    out_dir: str,
    name: str,
    row_labels: Optional[Sequence[str]] = None,
    col_labels: Optional[Sequence[str]] = None,
) -> Dict[str, str]:
    """Save raw + row-normalized + col-normalized CSV/NPY versions."""
    os.makedirs(out_dir, exist_ok=True)
    arr = np.asarray(arr, dtype=np.float64)
    paths = {}

    def write(tag: str, a: np.ndarray):
        npy = os.path.join(out_dir, f"{name}_{tag}.npy")
        np.save(npy, a)
        csv_path = os.path.join(out_dir, f"{name}_{tag}.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            if col_labels is not None:
                w.writerow([""] + list(col_labels))
            for i, row in enumerate(np.atleast_2d(a)):
                label = [row_labels[i]] if row_labels is not None and i < len(row_labels) else [str(i)]
                w.writerow(label + [f"{v:.6f}" for v in row])
        paths[tag] = npy

    write("raw", arr)
    if arr.ndim == 2:
        rs = arr.sum(axis=1, keepdims=True)
        cs = arr.sum(axis=0, keepdims=True)
        write("rownorm", np.divide(arr, np.clip(rs, 1e-12, None)))
        write("colnorm", np.divide(arr, np.clip(cs, 1e-12, None)))
    return paths


def routing_heatmap_tables(
    alpha: np.ndarray,  # [N, R]
    r_matrix: np.ndarray,  # [N, R, K]
    routes: Sequence[str],
    out_dir: str,
    split: str = "test",
    label_names: Optional[Sequence[str]] = None,
) -> Dict[str, object]:
    """Aggregate route-audit outputs for a split and export artifacts.

    Returns summary dict (also written as JSON): mean alpha per route, mean
    R (p(route|label)), and the dual p(label|route) renormalization.
    """
    alpha = np.asarray(alpha, np.float64)
    r_matrix = np.asarray(r_matrix, np.float64)
    n, r, k = r_matrix.shape
    if label_names is None:
        label_names = [f"label_{j}" for j in range(k)]

    mean_alpha = alpha.mean(axis=0)  # [R]
    mean_r = r_matrix.mean(axis=0)  # [R,K] p(route|label) columns sum ~1
    # dual: renormalize rows -> p(label|route)
    p_label_given_route = mean_r / np.clip(mean_r.sum(axis=1, keepdims=True), 1e-12, None)

    os.makedirs(out_dir, exist_ok=True)
    save_array_with_versions(
        mean_r, out_dir, f"{split}_R_route_given_label", row_labels=routes, col_labels=label_names
    )
    save_array_with_versions(
        p_label_given_route,
        out_dir,
        f"{split}_R_label_given_route",
        row_labels=routes,
        col_labels=label_names,
    )
    save_array_with_versions(mean_alpha[None, :], out_dir, f"{split}_alpha", col_labels=routes)

    summary = {
        "split": split,
        "routes": list(routes),
        "mean_alpha": mean_alpha.tolist(),
        "mean_R_route_given_label": mean_r.tolist(),
        "p_label_given_route": p_label_given_route.tolist(),
        "collapse_alarm": bool(mean_alpha.max() > 0.95),  # reference main.py:3195
    }
    with open(os.path.join(out_dir, f"{split}_route_audit.json"), "w") as f:
        json.dump(summary, f, indent=2)

    try:  # optional heatmap PNGs
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(max(6, k * 0.5), max(4, r * 0.4)))
        im = ax.imshow(mean_r, aspect="auto", cmap="viridis")
        ax.set_yticks(range(r), routes)
        ax.set_xticks(range(k), label_names, rotation=90)
        for ii in range(r):
            for jj in range(k):
                ax.text(jj, ii, f"{mean_r[ii, jj]:.2f}", ha="center", va="center", fontsize=6)
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{split}_R_heatmap.png"), dpi=150)
        plt.close(fig)
    except Exception:
        pass

    return summary


def save_reliability_diagram(
    y_true: np.ndarray,
    y_prob: np.ndarray,
    out_dir: str,
    split: str = "val",
    n_bins: int = 10,
) -> Dict[str, str]:
    """Reliability-diagram export (reference main.py:2366 plot_reliability).

    Always writes ``{split}_reliability.csv`` (bin confidence / accuracy /
    count); additionally renders the classic diagram (accuracy bars vs the
    y=x diagonal, bin counts as a secondary axis) to
    ``{split}_reliability.png`` when matplotlib is available.
    """
    from multimodalrouting_tpu_torch.metrics.calibration import (
        expected_calibration_error,
        reliability_table,
    )

    os.makedirs(out_dir, exist_ok=True)
    tab = reliability_table(y_true, y_prob, n_bins=n_bins)
    conf, acc, count = tab["bin_confidence"], tab["bin_accuracy"], tab["bin_count"]
    edges = tab["edges"]
    paths: Dict[str, str] = {}

    csv_path = os.path.join(out_dir, f"{split}_reliability.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["bin_lo", "bin_hi", "confidence", "accuracy", "count"])
        for i in range(n_bins):
            w.writerow([f"{edges[i]:.2f}", f"{edges[i + 1]:.2f}",
                        f"{conf[i]:.6f}", f"{acc[i]:.6f}", int(count[i])])
    paths["csv"] = csv_path

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        centers = (edges[:-1] + edges[1:]) / 2.0
        width = edges[1] - edges[0]
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.bar(centers, acc, width=width * 0.9, color="#4c72b0",
               edgecolor="white", label="empirical accuracy")
        ax.plot([0, 1], [0, 1], "k--", linewidth=1, label="perfect calibration")
        ece = expected_calibration_error(y_true, y_prob, n_bins=n_bins)
        ax.set_xlabel("predicted probability")
        ax.set_ylabel("observed frequency")
        ax.set_title(f"{split} reliability (ECE={ece:.4f})")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.legend(loc="upper left", fontsize=8)
        ax2 = ax.twinx()
        ax2.plot(centers, count, color="#c44e52", marker=".", linewidth=1, alpha=0.6)
        ax2.set_ylabel("bin count", color="#c44e52", fontsize=8)
        fig.tight_layout()
        png_path = os.path.join(out_dir, f"{split}_reliability.png")
        fig.savefig(png_path, dpi=150)
        plt.close(fig)
        paths["png"] = png_path
    except Exception:
        pass

    return paths
