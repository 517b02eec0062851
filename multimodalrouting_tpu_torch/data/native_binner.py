"""ctypes binding for the native C++ event binner (native/binner.cpp).

Counterpart of ``multimodalrouting_tpu/data/native_binner.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

The ETL's hot loop: per-(stay, bin, variable) winner selection over the raw
chartevents/labevents stream (lowest itemid priority wins, ties broken by
latest charttime — reference build_cohort.py:471-543) plus the bin-axis
forward fill, in one C++ pass instead of the pandas sort+groupby. The
Python path in data/cohort.py stays as the portable fallback and the parity
oracle (tests/test_native_binner.py).

Compiles lazily (g++ -O3 -shared) into build/native/libbinner.so
(``native_build.py``; the JAX package's native/libbinner.so is never
loaded), and degrades to None when no toolchain is available.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from multimodalrouting_tpu_torch.data.native_build import build_native

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build_so() -> Optional[str]:
    return build_native("binner")


_LIB = None


def load_native_binner():
    """Returns the loaded library or None (no toolchain)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _build_so()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.bin_events.restype = ctypes.c_int64
    lib.bin_events.argtypes = [
        _I64P, _I64P, _I64P, _I64P, _I64P, _F64P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _F32P, _U8P, _I64P, _I64P,
    ]
    lib.forward_fill.restype = None
    lib.forward_fill.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    _LIB = lib
    return lib


def bin_events_native(
    rows: np.ndarray,
    bins: np.ndarray,
    vcols: np.ndarray,
    priorities: np.ndarray,
    t_ns: np.ndarray,
    values: np.ndarray,
    s: int,
    n_bins: int,
    v: int,
    *,
    fill: bool = True,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One-pass winner selection + optional forward fill.

    Returns (x [S,B,V] float32 with NaN for never-observed cells before fill,
    m [S,B,V] int8 observed mask) or None when the native library is
    unavailable.
    """
    lib = load_native_binner()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    bins = np.ascontiguousarray(bins, np.int64)
    vcols = np.ascontiguousarray(vcols, np.int64)
    priorities = np.ascontiguousarray(priorities, np.int64)
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    n = len(rows)
    x = np.empty((s, n_bins, v), np.float32)
    m = np.empty((s, n_bins, v), np.uint8)
    scratch_pr = np.empty(s * n_bins * v, np.int64)
    scratch_t = np.empty(s * n_bins * v, np.int64)
    lib.bin_events(
        rows, bins, vcols, priorities, t_ns, values,
        n, s, n_bins, v, x.reshape(-1), m.reshape(-1), scratch_pr, scratch_t,
    )
    if fill:
        lib.forward_fill(x.reshape(-1), s, n_bins, v)
    return x, m.astype(np.int8)
