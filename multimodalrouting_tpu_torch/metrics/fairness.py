"""Fairness metrics: EDDI, equalized-odds gap, predictive parity gap.

The port's copy of multimodalrouting_tpu/metrics/fairness.py (numpy only).

Parity targets: reference MIMIC-IV/Model/evaluation_metrics.py:69-99 (EDDI,
sign-agnostic over sensitive keys) and Unimodal 01_BEHRT.py:20-108 (EO gap /
predictive parity suites).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def eddi(y_true: np.ndarray, y_prob: np.ndarray, groups: np.ndarray) -> float:
    """Error Distribution Disparity Index: mean absolute deviation of group
    error rates from the overall error rate, normalized by max(err, 1-err)."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_prob = np.asarray(y_prob, np.float64).ravel()
    groups = np.asarray(groups).ravel()
    err = np.abs(y_prob - y_true)
    overall = err.mean()
    denom = max(overall, 1.0 - overall, 1e-8)
    gaps = []
    for g in np.unique(groups):
        sel = groups == g
        if sel.any():
            gaps.append(abs(err[sel].mean() - overall) / denom)
    return float(np.mean(gaps)) if gaps else 0.0


def equalized_odds_gap(
    y_true: np.ndarray, y_pred: np.ndarray, groups: np.ndarray
) -> Dict[str, float]:
    """Max pairwise TPR and FPR gaps across groups."""
    y_true = np.asarray(y_true).ravel() > 0.5
    y_pred = np.asarray(y_pred).ravel() > 0.5
    groups = np.asarray(groups).ravel()
    tprs, fprs = [], []
    for g in np.unique(groups):
        sel = groups == g
        pos = sel & y_true
        neg = sel & ~y_true
        if pos.any():
            tprs.append(y_pred[pos].mean())
        if neg.any():
            fprs.append(y_pred[neg].mean())
    return {
        "tpr_gap": float(max(tprs) - min(tprs)) if len(tprs) > 1 else 0.0,
        "fpr_gap": float(max(fprs) - min(fprs)) if len(fprs) > 1 else 0.0,
    }


def predictive_parity_gap(
    y_true: np.ndarray, y_pred: np.ndarray, groups: np.ndarray
) -> float:
    """Max pairwise PPV gap across groups."""
    y_true = np.asarray(y_true).ravel() > 0.5
    y_pred = np.asarray(y_pred).ravel() > 0.5
    groups = np.asarray(groups).ravel()
    ppvs = []
    for g in np.unique(groups):
        sel = (groups == g) & y_pred
        if sel.any():
            ppvs.append(y_true[sel].mean())
    return float(max(ppvs) - min(ppvs)) if len(ppvs) > 1 else 0.0


# ---------------------------------------------------------------------------
# Reference-exact unimodal fairness suite (01_BEHRT.py:20-108)
# ---------------------------------------------------------------------------


def _tpr_fpr(y_true: np.ndarray, y_pred: np.ndarray):
    tp = np.sum((y_true == 1) & (y_pred == 1))
    tn = np.sum((y_true == 0) & (y_pred == 0))
    fp = np.sum((y_true == 0) & (y_pred == 1))
    fn = np.sum((y_true == 1) & (y_pred == 0))
    tpr = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    fpr = fp / (fp + tn) if (fp + tn) > 0 else 0.0
    return float(tpr), float(fpr)


def equalized_odds_suite(
    groups: np.ndarray, y_true: np.ndarray, y_pred: np.ndarray
) -> Dict[str, float]:
    """{EOTPR, EOFPR, EO}: pairwise |TPR_i - TPR_j| (resp. FPR) summed and
    divided by n_groups**2 (reference 01_BEHRT.py:29-44 — note the n**2
    normalization, not n*(n-1)/2), EO = their mean."""
    groups = np.asarray(groups).ravel()
    y_true = (np.asarray(y_true).ravel() > 0.5).astype(int)
    y_pred = (np.asarray(y_pred).ravel() > 0.5).astype(int)
    uniq = list(np.unique(groups))
    tprs, fprs = {}, {}
    for g in uniq:
        m = groups == g
        tprs[g], fprs[g] = _tpr_fpr(y_true[m], y_pred[m])
    n = len(uniq)
    if n == 0:
        return {"EOTPR": 0.0, "EOFPR": 0.0, "EO": 0.0}
    tsum = fsum = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            tsum += abs(tprs[uniq[i]] - tprs[uniq[j]])
            fsum += abs(fprs[uniq[i]] - fprs[uniq[j]])
    eotpr, eofpr = tsum / n**2, fsum / n**2
    return {"EOTPR": float(eotpr), "EOFPR": float(eofpr), "EO": float((eotpr + eofpr) / 2.0)}


def eddi_subgroups(
    groups: np.ndarray, y_true: np.ndarray, y_prob: np.ndarray, threshold: float = 0.5
):
    """(overall_eddi, {group: signed deviation}) with reference semantics
    (01_BEHRT.py:93-107): per-group (err_g - err_overall)/max(err, 1-err),
    overall = sqrt(sum of squares)/n_groups."""
    groups = np.asarray(groups).ravel()
    y_true = (np.asarray(y_true).ravel() > 0.5).astype(int)
    y_pred = (np.asarray(y_prob).ravel() > threshold).astype(int)
    overall_err = float(np.mean(y_pred != y_true))
    denom = max(overall_err, 1.0 - overall_err) if overall_err not in (0.0, 1.0) else 1.0
    sub: Dict[object, float] = {}
    for g in np.unique(groups):
        m = groups == g
        if not m.any():
            sub[g] = float("nan")
        else:
            sub[g] = float((np.mean(y_pred[m] != y_true[m]) - overall_err) / denom)
    vals = np.array(list(sub.values()), np.float64)
    overall = float(np.sqrt(np.nansum(vals**2)) / max(len(vals), 1))
    return overall, sub


def combined_eddi(*vals: float) -> float:
    """Geometric combination across attributes (01_BEHRT.py geom_mean_eddi)."""
    a = np.asarray(vals, np.float64)
    return float(np.sqrt(np.sum(a**2)) / max(len(a), 1))


def group_fairness_metrics(
    groups: np.ndarray, y_true: np.ndarray, y_pred: np.ndarray
) -> Dict[str, object]:
    """Per-group TPR/FPR/precision + EO suite + equal-opportunity diff
    (reference calculate_multiclass_fairness_metrics, 01_BEHRT.py:57-84)."""
    groups = np.asarray(groups).ravel()
    y_true = (np.asarray(y_true).ravel() > 0.5).astype(int)
    y_pred = (np.asarray(y_pred).ravel() > 0.5).astype(int)
    g_tpr, g_fpr, g_prec = {}, {}, {}
    for g in np.unique(groups):
        m = groups == g
        g_tpr[g], g_fpr[g] = _tpr_fpr(y_true[m], y_pred[m])
        tp = np.sum((y_true[m] == 1) & (y_pred[m] == 1))
        tot = np.sum(y_pred[m] == 1)
        g_prec[g] = float(tp / tot) if tot > 0 else 0.0
    eo = equalized_odds_suite(groups, y_true, y_pred)
    eop = (max(g_tpr.values()) - min(g_tpr.values())) if g_tpr else 0.0
    return {
        "group_tpr": {str(k): v for k, v in g_tpr.items()},
        "group_fpr": {str(k): v for k, v in g_fpr.items()},
        "group_precision": {str(k): v for k, v in g_prec.items()},
        "equalized_odds": eo,
        "equal_opportunity_diff": float(eop),
    }


def fairness_report(
    sens: Dict[str, np.ndarray],
    y_true: np.ndarray,
    y_prob: np.ndarray,
    threshold: float = 0.5,
) -> Dict[str, object]:
    """Full per-attribute fairness report, one task (the JSON analogue of the
    printed suite in 01_BEHRT.py:249-279): EO suite, EDDI overall+subgroups,
    detailed group metrics, predictive-parity gap; plus combined EDDI."""
    y_prob = np.asarray(y_prob).ravel()
    y_pred = (y_prob > threshold).astype(int)
    per_attr: Dict[str, object] = {}
    eddis = []
    for name, groups in sens.items():
        overall, sub = eddi_subgroups(groups, y_true, y_prob, threshold)
        eddis.append(overall)
        per_attr[name] = {
            "eo": equalized_odds_suite(groups, y_true, y_pred),
            "eddi_overall": overall,
            "eddi_subgroups": {str(k): v for k, v in sub.items()},
            "detail": group_fairness_metrics(groups, y_true, y_pred),
            "predictive_parity_gap": predictive_parity_gap(y_true, y_pred, groups),
        }
    return {"attributes": per_attr, "combined_eddi": combined_eddi(*eddis) if eddis else 0.0}
