"""Multilabel-stratified splits by iterative stratification (counterpart of
multimodalrouting_tpu/data/stratified.py, numpy only, a copy: the same
indices for the same seed).

The reference's wide-BEHRT multitask trainer splits with iterstrat's
``MultilabelStratifiedShuffleSplit`` over the 3-label (mortality/PE/PH)
matrix: 20% test, then 5/80 of the remainder as val (Sechidis, Tsoumakas &
Vlahavas, ECML 2011):

  1. desired per-fold sizes c_j = r_j * N and per-fold-per-label desired
     positive counts c_{l,j} = r_j * count(label l);
  2. repeatedly pick the label with the FEWEST remaining unassigned positive
     examples;
  3. assign each unassigned example of that label to the fold with the
     largest remaining desire for that label, breaking ties by largest
     remaining fold capacity, then by a seeded random draw;
  4. label-free leftovers fill folds by remaining capacity.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def iterative_stratification(
    y: np.ndarray, ratios: Sequence[float], seed: int = 42
) -> np.ndarray:
    """Assign each row of a binary label matrix to a fold.

    Args:
      y: [N, L] (or [N]) binary multilabel matrix.
      ratios: fold proportions, summing to ~1 (e.g. (0.8, 0.2)).
      seed: tie-break / ordering seed.

    Returns:
      fold index per sample, int array [N] with values in [0, len(ratios)).
    """
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    y = (y > 0.5).astype(np.int64)
    n, n_labels = y.shape
    ratios = np.asarray(list(ratios), dtype=np.float64)
    if not np.isclose(ratios.sum(), 1.0, atol=1e-6):
        raise ValueError(f"fold ratios must sum to 1, got {ratios.tolist()}")
    n_folds = len(ratios)
    rng = np.random.default_rng(seed)

    desired_fold = ratios * n  # c_j
    desired_label = ratios[:, None] * y.sum(axis=0)[None, :]  # c_{j,l}

    fold = np.full(n, -1, dtype=np.int64)
    unassigned = np.ones(n, dtype=bool)

    while True:
        remaining_counts = y[unassigned].sum(axis=0)  # positives left per label
        live = np.where(remaining_counts > 0)[0]
        if live.size == 0:
            break
        # rarest live label; seeded shuffle breaks equal-count ties stably
        order = rng.permutation(live)
        label = order[np.argmin(remaining_counts[order])]

        idxs = np.where(unassigned & (y[:, label] == 1))[0]
        for i in rng.permutation(idxs):
            # fold with the largest remaining desire for this label
            want = desired_label[:, label]
            best = np.where(want == want.max())[0]
            if best.size > 1:  # then largest remaining capacity
                cap = desired_fold[best]
                best = best[cap == cap.max()]
            j = int(best[0] if best.size == 1 else rng.choice(best))
            fold[i] = j
            unassigned[i] = False
            desired_fold[j] -= 1.0
            desired_label[j, y[i] == 1] -= 1.0

    # label-free leftovers: fill by remaining capacity
    for i in rng.permutation(np.where(unassigned)[0]):
        cap = desired_fold
        best = np.where(cap == cap.max())[0]
        j = int(best[0] if best.size == 1 else rng.choice(best))
        fold[i] = j
        desired_fold[j] -= 1.0

    return fold


def multilabel_stratified_shuffle_split(
    y: np.ndarray, test_size: float, random_state: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """One (train_idx, test_idx) draw, MultilabelStratifiedShuffleSplit-style."""
    if not (0.0 < test_size < 1.0):
        raise ValueError(f"test_size must be in (0,1), got {test_size}")
    fold = iterative_stratification(y, (1.0 - test_size, test_size), seed=random_state)
    return np.where(fold == 0)[0], np.where(fold == 1)[0]


def stratified_three_way(
    y: np.ndarray,
    test_size: float = 0.20,
    val_of_rest: float = 0.05 / 0.80,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's exact two-stage protocol (BEHRT.py:228-232):
    20% test off the top, then 5/80 of the remainder as val -> 75/5/20."""
    trv_idx, test_idx = multilabel_stratified_shuffle_split(
        y, test_size=test_size, random_state=seed
    )
    y = np.asarray(y)
    tr_rel, va_rel = multilabel_stratified_shuffle_split(
        y[trv_idx], test_size=val_of_rest, random_state=seed
    )
    return trv_idx[tr_rel], trv_idx[va_rel], test_idx

