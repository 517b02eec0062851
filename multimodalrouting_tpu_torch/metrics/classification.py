"""Classification metrics (pure NumPy, no sklearn dependency).

The port's copy of multimodalrouting_tpu/metrics/classification.py (numpy only).

Covers the reference's metric surface (reference: MIMIC-IV/MortModel/
Paired_Cross_Attention/main.py:2180-2311 epoch_metrics — AUROC, AUPRC, F1,
precision/recall, confusion, macro/micro/per-label, example-F1, Hamming;
MCC from MortModel/Baseline/main:319).

AUROC uses the rank statistic with tie correction (equivalent to the
trapezoidal ROC integral); AUPRC is average precision.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _rankdata(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(x) + 1)
    # average ties
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    return ranks


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    pos = y_true > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _rankdata(y_score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def auprc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision (step-wise integral of the PR curve).

    Tied scores form ONE threshold group, exactly as sklearn's
    average_precision_score (the reference's oracle) computes it.
    """
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    n_pos = float((y_true > 0.5).sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    ys = y_score[order]
    yt = y_true[order] > 0.5
    tp = np.cumsum(yt)
    # thresholds at the END of each tie group (last index of equal scores)
    idx = np.r_[np.where(np.diff(ys))[0], len(ys) - 1]
    precision = tp[idx] / (idx + 1.0)
    recall = tp[idx] / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def confusion(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, int]:
    y_true = np.asarray(y_true).ravel() > 0.5
    y_pred = np.asarray(y_pred).ravel() > 0.5
    return {
        "tp": int(np.sum(y_true & y_pred)),
        "fp": int(np.sum(~y_true & y_pred)),
        "fn": int(np.sum(y_true & ~y_pred)),
        "tn": int(np.sum(~y_true & ~y_pred)),
    }


def f1_score(y_true: np.ndarray, y_pred: np.ndarray, beta: float = 1.0) -> float:
    c = confusion(y_true, y_pred)
    b2 = beta * beta
    denom = (1 + b2) * c["tp"] + b2 * c["fn"] + c["fp"]
    return float((1 + b2) * c["tp"] / denom) if denom else 0.0


def mcc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    c = confusion(y_true, y_pred)
    num = c["tp"] * c["tn"] - c["fp"] * c["fn"]
    den = np.sqrt(
        float(c["tp"] + c["fp"])
        * float(c["tp"] + c["fn"])
        * float(c["tn"] + c["fp"])
        * float(c["tn"] + c["fn"])
    )
    return float(num / den) if den > 0 else 0.0


def binary_metrics(
    y_true: np.ndarray, y_score: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    y_pred = np.asarray(y_score).ravel() >= threshold
    c = confusion(y_true, y_pred)
    precision = c["tp"] / (c["tp"] + c["fp"]) if (c["tp"] + c["fp"]) else 0.0
    recall = c["tp"] / (c["tp"] + c["fn"]) if (c["tp"] + c["fn"]) else 0.0
    return {
        "auroc": auroc(y_true, y_score),
        "auprc": auprc(y_true, y_score),
        "f1": f1_score(y_true, y_pred),
        "precision": float(precision),
        "recall": float(recall),
        "mcc": mcc(y_true, y_pred),
        "accuracy": float((c["tp"] + c["tn"]) / max(sum(c.values()), 1)),
        **{k: float(v) for k, v in c.items()},
    }


def multilabel_metrics(
    y_true: np.ndarray,
    y_score: np.ndarray,
    thresholds: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Macro/micro/per-label AUROC/AUPRC/F1, example-F1, Hamming loss."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n, k = y_true.shape
    if thresholds is None:
        thresholds = np.full(k, 0.5)
    y_pred = y_score >= thresholds[None, :]

    per_auroc = np.array([auroc(y_true[:, j], y_score[:, j]) for j in range(k)])
    per_auprc = np.array([auprc(y_true[:, j], y_score[:, j]) for j in range(k)])
    per_f1 = np.array([f1_score(y_true[:, j], y_pred[:, j]) for j in range(k)])

    # micro
    micro_f1 = f1_score(y_true.ravel(), y_pred.ravel())
    micro_auroc = auroc(y_true.ravel(), y_score.ravel())

    # example-based F1
    tp = (y_pred & (y_true > 0.5)).sum(axis=1)
    denom = y_pred.sum(axis=1) + (y_true > 0.5).sum(axis=1)
    example_f1 = float(np.mean(np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 1.0)))

    return {
        "auroc_macro": float(np.nanmean(per_auroc)),
        "auprc_macro": float(np.nanmean(per_auprc)),
        "f1_macro": float(np.nanmean(per_f1)),
        "auroc_micro": micro_auroc,
        "f1_micro": micro_f1,
        "example_f1": example_f1,
        "hamming_loss": float(np.mean(y_pred != (y_true > 0.5))),
        "per_label_auroc": per_auroc.tolist(),
        "per_label_auprc": per_auprc.tolist(),
        "per_label_f1": per_f1.tolist(),
    }


def epoch_metrics(
    y_true: np.ndarray,
    y_score: np.ndarray,
    thresholds: Optional[np.ndarray] = None,
    threshold: float = 0.5,
) -> Dict[str, object]:
    y_true = np.asarray(y_true)
    if y_true.ndim == 2 and y_true.shape[1] > 1:
        return multilabel_metrics(y_true, y_score, thresholds)
    return binary_metrics(y_true.ravel(), np.asarray(y_score).ravel(), threshold)
