"""Bytes and operations of one call of the packed attention kernels.

Frozen copy of the formulas of ``chip_smoke.py``'s K1 (:635-636) and K2
(:746-749) phases, with the operations counted over the keys each chunk
really holds ("count what these inputs need, not the most they could"):
chip_smoke.py counts every T x T product because its inputs fill every key.

K1 (forward, bf16 q, k, v [N, T, H*dh], fp32 key mask [N, T]): reads q, k,
v and the mask once and writes the output once; two products per head,
each T_q x T_valid x dh.

K2 (backward: di, dq, dk/dv): reads q, k, v, K1's output o, do, the mask
and K1's fp32 lse [N, H, T] once; writes dq, dk, dv once; five products
per head.
"""
from __future__ import annotations

from typing import Sequence


def k1_bytes(n: int, t: int, d: int) -> float:
    return 4 * n * t * d * 2 + n * t * 4


def k1_flops(valid_keys: Sequence[int], t: int, d: int) -> float:
    """Two T x T_valid x dh products for each of the H heads (H * dh = d)
    of every chunk; `valid_keys` holds each chunk's valid key count."""
    return 4.0 * t * d * float(sum(valid_keys))


def k2_bytes(n: int, t: int, d: int, heads: int) -> float:
    return 8 * n * t * d * 2 + n * t * 4 + n * heads * t * 4


def k2_flops(valid_keys: Sequence[int], t: int, d: int) -> float:
    return 10.0 * t * d * float(sum(valid_keys))
