"""Synthetic MIMIC-style mini-cohort generator (the port's copy of
multimodalrouting_tpu/data/synthetic.py: numpy only, bit-identical cohorts
for the same seed).

Implements BASELINE.json.configs[0]'s "synthetic MIMIC-IV mini-cohort": a
deterministic, label-correlated trimodal dataset with the exact static shapes
of the real pipeline ([B,T,F] labs, [B,S,L] pretokenized note chunks,
[B,H,W,3] images, presence flags, mortality + 25-phenotype labels). Signal is
injected into each modality so unimodal AND interaction routes carry
information — tests can verify learning and route attribution.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from multimodalrouting_tpu_torch.data.batches import Batch, take_batch


def make_synthetic_cohort(
    n: int = 256,
    *,
    t: int = 48,
    f: int = 76,
    s: int = 4,
    l: int = 64,
    image_size: int = 64,
    vocab_size: int = 28996,
    num_pheno: int = 25,
    pos_rate: float = 0.25,
    missing_rate: float = 0.0,
    seed: int = 0,
    task: str = "mort",
) -> Batch:
    """Build one static-shape Batch of n synthetic stays.

    The latent risk score z drives: a lab-trend component (L), the frequency
    of a "risk token" in note chunks (N), and a bright blob intensity in the
    image (I). Their product perturbs the label → trimodal interaction signal.
    """
    rng = np.random.default_rng(seed)

    z = rng.normal(size=(n, 3))  # per-modality latent risk factors

    # --- L: lab time series with a risk-dependent trend on 8 channels ---
    x_struct = rng.normal(size=(n, t, f)).astype(np.float32) * 0.5
    trend = np.linspace(0, 1, t, dtype=np.float32)[None, :, None]
    x_struct[:, :, :8] += z[:, 0][:, None, None].astype(np.float32) * trend
    lengths = rng.integers(max(4, t // 2), t + 1, size=n)
    m_struct = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    x_struct *= m_struct[:, :, None]

    # --- N: pretokenized chunks; risk token 999 appears with rate sigmoid(zN) ---
    tok_lo = min(1000, vocab_size // 2)
    risk_token = tok_lo - 1
    note_ids = rng.integers(tok_lo, vocab_size, size=(n, s, l), dtype=np.int64)
    note_ids[:, :, 0] = min(101, tok_lo - 2)  # [CLS]
    p_risk = 1.0 / (1.0 + np.exp(-z[:, 1]))
    risk_tok = rng.random(size=(n, s, l)) < p_risk[:, None, None] * 0.3
    risk_tok[:, :, 0] = False
    note_ids = np.where(risk_tok, risk_token, note_ids)
    chunk_counts = rng.integers(1, s + 1, size=n)
    chunk_mask = (np.arange(s)[None, :] < chunk_counts[:, None]).astype(np.float32)
    tok_lengths = rng.integers(l // 2, l + 1, size=(n, s))
    note_attn = (np.arange(l)[None, None, :] < tok_lengths[:, :, None]).astype(np.int32)
    note_attn *= chunk_mask[:, :, None].astype(np.int32)
    note_ids = (note_ids * note_attn).astype(np.int32)

    # --- I: image with a risk-scaled bright square ---
    image = rng.normal(size=(n, image_size, image_size, 3)).astype(np.float32) * 0.3
    blob = np.clip(z[:, 2], -2, 2).astype(np.float32)
    c0 = image_size // 4
    image[:, c0 : c0 * 3, c0 : c0 * 3, :] += blob[:, None, None, None] * 0.5

    # --- labels: unimodal + interaction terms ---
    inter = z[:, 0] * z[:, 1] + 0.5 * z[:, 0] * z[:, 2] + 0.5 * z[:, 1] * z[:, 2]
    score = z.sum(axis=1) + 0.75 * inter
    thresh = np.quantile(score, 1.0 - pos_rate)
    y_mort = (score > thresh).astype(np.float32)

    if task == "pheno":
        # the feature->label map is a property of the TASK, not the split:
        # draw w from a fixed seed so train/val/test cohorts (which use
        # different `seed`s) share one label-generating function — a
        # per-split w makes validation unlearnable by construction
        w = np.random.default_rng(25).normal(size=(4, num_pheno))
        feats = np.concatenate([z, inter[:, None]], axis=1)
        logits = feats @ w + rng.normal(size=(n, num_pheno)) * 0.5
        y = (logits > np.quantile(logits, 0.75, axis=0, keepdims=True)).astype(np.float32)
    elif task == "multitask":
        y = np.stack([y_mort, (z[:, 1] > 0.5).astype(np.float32), (z[:, 2] > 0.5).astype(np.float32)], 1)
    else:
        y = y_mort

    # --- modality presence (partial-cohort support) ---
    def presence():
        if missing_rate <= 0:
            return np.ones(n, dtype=np.float32)
        return (rng.random(n) >= missing_rate).astype(np.float32)

    has_l = np.ones(n, dtype=np.float32)  # structured always present (MedFuse parity)
    has_n, has_i = presence(), presence()

    sens = rng.integers(0, 2, size=n).astype(np.int32)
    chexpert = (rng.random(size=(n, 14)) < 0.2).astype(np.float32)

    return Batch(
        x_struct=x_struct,
        m_struct=m_struct,
        note_ids=note_ids,
        note_attn=note_attn,
        chunk_mask=chunk_mask,
        image=image,
        has_l=has_l,
        has_n=has_n,
        has_i=has_i,
        y=y,
        sens=sens,
        chexpert=chexpert,
    )


def iter_minibatches(batch: Batch, batch_size: int, *, seed: Optional[int] = None, drop_last: bool = True):
    """Yield shuffled static-size minibatches from a cohort Batch."""
    n = batch.batch_size
    idx = np.arange(n)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - batch_size + 1 if drop_last else n
    for start in range(0, max(stop, 0), batch_size):
        sel = idx[start : start + batch_size]
        if drop_last and len(sel) < batch_size:
            break
        yield take_batch(batch, sel)
