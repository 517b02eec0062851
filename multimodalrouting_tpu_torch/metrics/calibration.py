"""Calibration: ECE, reliability table, temperature scaling, threshold search.

The port's copy of multimodalrouting_tpu/metrics/calibration.py (numpy only).

Parity targets: reference MIMIC-IV/MortModel/Paired_Cross_Attention/main.py —
expected_calibration_error (:2329, equal-width bins), reliability plot data
(:2366), fit_temperature_scalar_bce_from_val (:2093, Adam on log T against
VAL BCE), find_best_thresholds (:2378, per-label F1 grid; Fbeta=2 variant in
PhenoModel PCA :2173).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from multimodalrouting_tpu_torch.metrics.classification import f1_score


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def expected_calibration_error(
    y_true: np.ndarray, y_prob: np.ndarray, n_bins: int = 10
) -> float:
    y_true = np.asarray(y_true, np.float64).ravel()
    y_prob = np.asarray(y_prob, np.float64).ravel()
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    n = len(y_true)
    for i in range(n_bins):
        lo, hi = edges[i], edges[i + 1]
        sel = (y_prob >= lo) & (y_prob < hi if i < n_bins - 1 else y_prob <= hi)
        if not sel.any():
            continue
        conf = y_prob[sel].mean()
        acc = y_true[sel].mean()
        ece += (sel.sum() / n) * abs(acc - conf)
    return float(ece)


def reliability_table(
    y_true: np.ndarray, y_prob: np.ndarray, n_bins: int = 10
) -> Dict[str, np.ndarray]:
    y_true = np.asarray(y_true, np.float64).ravel()
    y_prob = np.asarray(y_prob, np.float64).ravel()
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(y_prob, edges) - 1, 0, n_bins - 1)
    conf = np.zeros(n_bins)
    acc = np.zeros(n_bins)
    count = np.zeros(n_bins)
    for i in range(n_bins):
        sel = idx == i
        count[i] = sel.sum()
        if count[i]:
            conf[i] = y_prob[sel].mean()
            acc[i] = y_true[sel].mean()
    return {"bin_confidence": conf, "bin_accuracy": acc, "bin_count": count, "edges": edges}


def fit_temperature(
    logits: np.ndarray,
    y_true: np.ndarray,
    *,
    steps: int = 200,
    lr: float = 0.05,
    t_min: float = 0.05,
    t_max: float = 20.0,
) -> float:
    """Fit scalar temperature minimizing BCE on validation logits by Adam on
    log T (matches the reference's optimizer choice). T is clamped to
    [t_min, t_max] — unbounded fits on small confident validation sets
    collapse to T -> 0 (probability saturation), which is calibration
    nonsense."""
    logits = np.asarray(logits, np.float64).ravel()
    y = np.asarray(y_true, np.float64).ravel()
    log_t = 0.0
    m = v = 0.0
    b1, b2, eps = 0.9, 0.999, 1e-8
    lo, hi = np.log(t_min), np.log(t_max)
    for step in range(1, steps + 1):
        t = np.exp(log_t)
        z = logits / t
        p = _sigmoid(z)
        # d(BCE)/d(logT) = mean((p - y) * z) * (-1)  [since dz/dlogT = -z]
        grad = float(np.mean((p - y) * (-z)))
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        mhat = m / (1 - b1**step)
        vhat = v / (1 - b2**step)
        log_t = float(np.clip(log_t - lr * mhat / (np.sqrt(vhat) + eps), lo, hi))
    return float(np.exp(log_t))


def find_best_thresholds(
    y_true: np.ndarray,
    y_prob: np.ndarray,
    *,
    beta: float = 1.0,
    grid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-label threshold grid search maximizing F-beta.

    Returns (thresholds [K], best_scores [K]).
    """
    y_true = np.asarray(y_true, np.float64)
    y_prob = np.asarray(y_prob, np.float64)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
        y_prob = y_prob[:, None]
    if grid is None:
        grid = np.linspace(0.05, 0.95, 19)
    k = y_true.shape[1]
    ths = np.full(k, 0.5)
    best = np.zeros(k)
    for j in range(k):
        for th in grid:
            s = f1_score(y_true[:, j], y_prob[:, j] >= th, beta=beta)
            if s > best[j]:
                best[j], ths[j] = s, th
    return ths, best
