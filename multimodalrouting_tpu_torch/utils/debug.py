"""Numerics debug checks behind a flag (counterpart of
multimodalrouting_tpu/utils/debug.py).

``checked_finite`` is the identity with ``MMR_DEBUG_CHECKS`` other than
``1``: no device work and no host sync. With the flag on it checks that
every element is finite, which syncs with the host, and prints
``[MMR_DEBUG] non-finite values in NAME`` where one is not.
"""
from __future__ import annotations

import os

import torch


def debug_checks_enabled() -> bool:
    return os.environ.get("MMR_DEBUG_CHECKS", "0") == "1"


def checked_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x`, after printing a warning when debug checks are on and any of
    its elements is not finite."""
    if not debug_checks_enabled():
        return x
    if not torch.isfinite(x).all().item():
        print(f"[MMR_DEBUG] non-finite values in {name}")
    return x
