"""Missing-modality drop-table evaluation.

The port's copy of multimodalrouting_tpu/audit/droptable.py (numpy only),
over the port's ``Batch`` and ``epoch_metrics``.

Parity target: reference MIMIC-IV/PhenoModel/Partial/Cross_Attention/
main.py:50-106 — evaluate under conditions full / dropL / dropN / dropI /
rand1 (one random modality dropped per sample) and report metric deltas
against the full condition.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.metrics.classification import epoch_metrics

CONDITIONS = ("full", "dropL", "dropN", "dropI", "rand1")


def _apply_condition(batch: Batch, condition: str, rng: np.random.Generator) -> Batch:
    has_l = np.asarray(batch.has_l).copy()
    has_n = np.asarray(batch.has_n).copy()
    has_i = np.asarray(batch.has_i).copy()
    b = len(has_l)
    if condition == "full":
        pass
    elif condition == "dropL":
        has_l[:] = 0.0
    elif condition == "dropN":
        has_n[:] = 0.0
    elif condition == "dropI":
        has_i[:] = 0.0
    elif condition == "rand1":
        which = rng.integers(0, 3, size=b)
        # keep the original dtype: np.where with a python float promotes to
        # float64, which would hand the model float64 presence flags
        has_l = np.where(which == 0, 0.0, has_l).astype(has_l.dtype)
        has_n = np.where(which == 1, 0.0, has_n).astype(has_n.dtype)
        has_i = np.where(which == 2, 0.0, has_i).astype(has_i.dtype)
    else:
        raise ValueError(f"Unknown condition {condition!r}")
    return batch._replace(has_l=has_l, has_n=has_n, has_i=has_i)


def drop_table_eval(
    predict_fn: Callable[[Batch], np.ndarray],
    batch: Batch,
    *,
    seed: int = 0,
    conditions=CONDITIONS,
    thresholds: Optional[np.ndarray] = None,
) -> Dict[str, Dict[str, object]]:
    """Run predict_fn under each condition; return metrics + deltas vs full.

    predict_fn: Batch -> probabilities [B] or [B,K].
    """
    rng = np.random.default_rng(seed)
    y = np.asarray(batch.y)
    table: Dict[str, Dict[str, object]] = {}
    full_metrics = None
    for cond in conditions:
        probs = np.asarray(predict_fn(_apply_condition(batch, cond, rng)))
        if y.ndim == 1 and thresholds is not None:
            # binary task: epoch_metrics takes a scalar decision threshold
            m = epoch_metrics(y, probs, threshold=float(np.ravel(thresholds)[0]))
        else:
            m = epoch_metrics(y, probs, thresholds=thresholds)
        if cond == "full":
            full_metrics = m
        table[cond] = m
    if full_metrics is not None:
        for cond in conditions:
            if cond == "full":
                continue
            deltas = {}
            for k, v in table[cond].items():
                base = full_metrics.get(k)
                if isinstance(v, float) and isinstance(base, float):
                    deltas[f"delta_{k}"] = v - base
            table[cond].update(deltas)
    return table


def format_drop_table(table: Dict[str, Dict[str, object]], keys=("auroc", "auprc", "f1")) -> str:
    """Human-readable drop table (print_drop_table parity)."""
    keys = [k for k in keys if any(k in m for m in table.values())]
    if not keys:  # multilabel
        keys = ["auroc_macro", "auprc_macro", "f1_macro"]
    lines = ["condition  " + "  ".join(f"{k:>12}" for k in keys)]
    for cond, m in table.items():
        row = f"{cond:<10}"
        for k in keys:
            v = m.get(k, float("nan"))
            d = m.get(f"delta_{k}")
            cell = f"{v:.4f}" + (f" ({d:+.3f})" if isinstance(d, float) else "")
            row += f"  {cell:>12}"
        lines.append(row)
    return "\n".join(lines)
