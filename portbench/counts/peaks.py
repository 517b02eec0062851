"""Published peaks of one NVIDIA H100 SXM and the roofline bound.

Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``PEAK_FLOPS`` and
``bound`` (chip_smoke.py:287-288 and :439-441): the data sheet's dense rates,
so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def bound(bytes_moved: float, flops: float, kind: str) -> Tuple[float, str]:
    """The least time in ms the chip could take for `bytes_moved` bytes and
    `flops` operations at peak `kind`, and which of the two bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
