"""The plain reference of a scored request, in float32.

A request's records (every field at the served shapes) stacked into one
batch, the eval-mode forward of ``model.py`` (BatchNorm on its running
statistics), then what a row carries: the mortality probability from the
death logit (logits[:, 1] - logits[:, 0]) or each phenotype's sigmoid,
calibrated by the checkpoint's temperature in logit space, the decision
against the checkpoint's threshold, each route's alpha (the clamped
prior) and the three routes of highest alpha; and the head's logits, which
the program's forward is held to.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from . import model as ref

FIELDS = ("x_struct", "m_struct", "note_ids", "note_attn", "chunk_mask", "image")


def stack_records(records: Sequence[Mapping[str, np.ndarray]], device) -> Dict[str, torch.Tensor]:
    batch = {k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in records])).to(device) for k in FIELDS}
    for flag, key in (("has_l", "x_struct"), ("has_n", "note_ids"), ("has_i", "image")):
        batch[flag] = torch.tensor([1.0 if r.get(key) is not None else 0.0 for r in records], device=device)
    batch["has_n"] = batch["has_n"] * (batch["chunk_mask"].sum(dim=1) > 0).float()
    return batch


def served_probs(task: str, logits: np.ndarray, temperature: float) -> np.ndarray:
    """A row's probability from the head's logits: the death logit (or each
    label's) over the temperature, through the sigmoid."""
    logit = logits[:, 1] - logits[:, 0] if task == "mort" else logits
    return 1.0 / (1.0 + np.exp(-logit / temperature))


def reference_rows(P: Mapping[str, torch.Tensor], cfg: Mapping, records, temperature: float, thresholds,
                   nx: ref.Numerics, chunk_block: int = 64) -> Dict[str, np.ndarray]:
    """probs [N] or [N, K], pred, alpha [N, R], the top-3 route indices and
    the head's logits [N, K]."""
    batch = stack_records(records, next(iter(P.values())).device)
    with torch.no_grad():
        out = ref.forward(nx, P, cfg, batch, train=False, chunk_block=chunk_block)
    logits = out["logits"].double().cpu().numpy()
    probs = served_probs(cfg["model"]["task"], logits, temperature)
    th = np.asarray(thresholds, np.float64)
    pred = (probs >= (th if probs.ndim == 2 else th[0])).astype(np.int32)
    alpha = out["alpha"].double().cpu().numpy()
    return {"probs": probs, "pred": pred, "alpha": alpha, "top": np.argsort(-alpha, axis=1, kind="stable")[:, :3],
            "logits": logits}
