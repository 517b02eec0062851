"""One-shot diagnostic probes (reference main.py:341-383 quantization_check /
mask_stats / route_cosine_report; :1603 pretty_print_small_batch): a copy of
multimodalrouting_tpu/audit/probes.py, which is numpy only.

Host-side reports over fetched arrays — run once per training run or from
the CLI eval path to sanity-check inputs and route geometry.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def route_cosine_report(route_embs: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Pairwise cosine similarity between batch-mean route embeddings.

    High off-diagonal cosines (> 0.95) indicate route collapse — the routes
    have stopped encoding distinct information.
    """
    names = list(route_embs)
    means = np.stack([np.asarray(route_embs[r]).mean(axis=0) for r in names])
    norms = np.linalg.norm(means, axis=1, keepdims=True)
    unit = means / np.clip(norms, 1e-12, None)
    cos = unit @ unit.T
    off = cos[~np.eye(len(names), dtype=bool)]
    return {
        "routes": names,
        "cosine": cos.tolist(),
        "max_offdiag": float(off.max()) if off.size else 0.0,
        "mean_offdiag": float(off.mean()) if off.size else 0.0,
        "collapse_suspect": bool(off.size and off.max() > 0.95),
    }


def mask_stats(**masks: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Coverage statistics for validity masks (chunk_mask, m_struct, ...)."""
    out = {}
    for name, m in masks.items():
        m = np.asarray(m, np.float64)
        per_sample = m.reshape(m.shape[0], -1).mean(axis=1)
        out[name] = {
            "mean_coverage": float(per_sample.mean()),
            "min_coverage": float(per_sample.min()),
            "frac_empty": float((per_sample == 0).mean()),
        }
    return out


def quantization_check(x: np.ndarray, name: str = "x", max_unique: int = 16) -> Dict[str, object]:
    """Detect suspiciously quantized/constant inputs (dead features)."""
    x = np.asarray(x)
    flat = x.reshape(-1)
    sample = flat[:: max(1, len(flat) // 100_000)]
    uniq = np.unique(sample)
    return {
        "name": name,
        "n_unique_sampled": int(len(uniq)),
        "suspicious": bool(len(uniq) <= max_unique),
        "std": float(flat.std()),
        "frac_zero": float((flat == 0).mean()),
    }


def pretty_print_small_batch(batch, k: int = 2) -> str:
    """Shapes + tiny samples of each Batch field (one-shot debug print)."""
    lines = []
    for field, value in zip(batch._fields, batch):
        if value is None:
            lines.append(f"{field}: None")
            continue
        v = np.asarray(value)
        sample = np.ravel(v)[:k]
        lines.append(f"{field}: shape={v.shape} dtype={v.dtype} sample={sample.tolist()}")
    text = "\n".join(lines)
    print(text)
    return text
