"""Note tokenization + 512-token chunking (pretokenized canonical path).

Counterpart of ``multimodalrouting_tpu/data/tokenization.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py),
and ``load_tokenizer`` logs the tokenizer it chose.

Parity targets: reference bio_bert_chunks (MIMIC-IV/cohort/build_cohort.py:42)
and _chunk_long_ids sliding windows with stride
(MIMIC-IV/MortModel/Paired_Cross_Attention/main.py:652-666). Tokenization is
host-side and pre-materialized at ETL time — the reference already supports a
pretokenized parquet schema (_detect_notes_schema, main.py:965-999) and this
framework adopts it as the ONLY runtime path, so the device program sees static
[B, S, L] int grids.

Uses the HF WordPiece tokenizer when the model's vocab is available locally;
otherwise falls back to a deterministic hash tokenizer (same chunk geometry,
stable ids) so the pipeline works in closed environments.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

CLS_ID = 101
SEP_ID = 102
PAD_ID = 0


@dataclass
class ChunkingConfig:
    max_len: int = 512
    stride: int = 64
    max_chunks: int = 8
    vocab_size: int = 28996


class HashTokenizer:
    """Deterministic word-level fallback tokenizer (stable across runs)."""

    def __init__(self, vocab_size: int = 28996):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in re.findall(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]", text.lower()):
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids.append(1000 + h % (self.vocab_size - 1000))
        return ids


def load_tokenizer(
    model_name: str = "emilyalsentzer/Bio_ClinicalBERT",
    vocab_path: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
):
    """Preferred order: native C++ WordPiece (given a vocab.txt) -> cached HF
    tokenizer -> deterministic hash fallback. Logs the one chosen, so that a
    fall to the hash tokenizer shows in a run."""
    if vocab_path:
        from multimodalrouting_tpu_torch.data.native_tokenizer import load_native_tokenizer

        native = load_native_tokenizer(vocab_path)
        if native is not None:
            log_fn(f"[tokenizer] native WordPiece over {vocab_path} ({native.vocab_size} entries)")
            return native
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        log_fn(f"[tokenizer] HF {model_name} (local files)")
        return tok
    except Exception:
        log_fn(f"[tokenizer] hash fallback: no native vocab ({vocab_path!r}) and no local HF {model_name}")
        return HashTokenizer()


def chunk_token_ids(
    ids: List[int], cfg: ChunkingConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window chunking: [S, L] ids + attention, CLS/SEP framed.

    Window body = max_len - 2 tokens, overlapping by `stride`
    (reference main.py:652-666 semantics: step = body - stride).
    """
    body = cfg.max_len - 2
    step = max(body - cfg.stride, 1)
    windows = []
    if not ids:
        windows = [[]]
    else:
        for start in range(0, len(ids), step):
            windows.append(ids[start : start + body])
            if start + body >= len(ids):
                break
    windows = windows[: cfg.max_chunks]

    s = len(windows)
    out_ids = np.full((s, cfg.max_len), PAD_ID, dtype=np.int32)
    out_attn = np.zeros((s, cfg.max_len), dtype=np.int32)
    for i, w in enumerate(windows):
        row = [CLS_ID] + list(w) + [SEP_ID]
        out_ids[i, : len(row)] = row
        out_attn[i, : len(row)] = 1
    return out_ids, out_attn


def tokenize_stay_notes(
    text: str,
    tokenizer=None,
    cfg: Optional[ChunkingConfig] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """text -> (ids [S_max, L], attn [S_max, L], chunk_mask [S_max])."""
    cfg = cfg or ChunkingConfig()
    tokenizer = tokenizer or HashTokenizer(cfg.vocab_size)
    try:
        ids = tokenizer.encode(text, add_special_tokens=False)  # HF signature
    except TypeError:
        ids = tokenizer.encode(text)  # native / hash tokenizers
    chunk_ids, chunk_attn = chunk_token_ids(ids, cfg)
    s = chunk_ids.shape[0]
    pad = cfg.max_chunks - s
    if pad > 0:
        chunk_ids = np.pad(chunk_ids, ((0, pad), (0, 0)))
        chunk_attn = np.pad(chunk_attn, ((0, pad), (0, 0)))
    chunk_mask = np.zeros(cfg.max_chunks, dtype=np.float32)
    has_any = bool(text.strip()) if isinstance(text, str) else False
    chunk_mask[:s] = 1.0 if has_any else 0.0
    return chunk_ids, chunk_attn, chunk_mask
