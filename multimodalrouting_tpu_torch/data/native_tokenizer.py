"""ctypes binding for the native C++ WordPiece tokenizer.

Counterpart of ``multimodalrouting_tpu/data/native_tokenizer.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Compiles native/wordpiece.cpp lazily (g++ -O3 -shared) into
build/native/libwordpiece.so (``native_build.py``; the JAX package's
native/libwordpiece.so is never loaded). Falls back cleanly when a toolchain is unavailable —
callers should use `load_native_tokenizer()` and handle None.

This is the fast host-side path for ETL-time note tokenization
(data/tokenization.py): WordPiece over the Bio_ClinicalBERT vocab at C++
speed instead of Python, on the single-core hosts this pipeline targets.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

from multimodalrouting_tpu_torch.data.native_build import build_native


def _build_so() -> Optional[str]:
    return build_native("wordpiece")


class NativeWordPiece:
    """Greedy longest-match WordPiece backed by the C++ library."""

    def __init__(self, vocab_path: str, lowercase: bool = True):
        so = _build_so()
        if so is None:
            raise RuntimeError("native tokenizer unavailable (no toolchain)")
        self._lib = ctypes.CDLL(so)
        self._lib.wp_create.restype = ctypes.c_void_p
        self._lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self._lib.wp_encode.restype = ctypes.c_int
        self._lib.wp_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        self._lib.wp_vocab_size.restype = ctypes.c_int
        self._lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        self._lib.wp_free.argtypes = [ctypes.c_void_p]
        self._h = self._lib.wp_create(vocab_path.encode(), int(lowercase))
        if not self._h:
            raise RuntimeError(f"failed to load vocab {vocab_path}")

    @property
    def vocab_size(self) -> int:
        return int(self._lib.wp_vocab_size(self._h))

    def encode(self, text: str, max_len: int = 1_000_000) -> List[int]:
        buf = (ctypes.c_int * max_len)()
        n = self._lib.wp_encode(self._h, text.encode("utf-8", "ignore"), buf, max_len)
        if n < 0:
            raise RuntimeError("wp_encode failed")
        return list(buf[:n])

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.wp_free(self._h)
        except Exception:
            pass


def load_native_tokenizer(vocab_path: str, lowercase: bool = True) -> Optional[NativeWordPiece]:
    try:
        return NativeWordPiece(vocab_path, lowercase=lowercase)
    except Exception:
        return None
