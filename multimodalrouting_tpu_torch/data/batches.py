"""Static-shape batch contract (counterpart of
multimodalrouting_tpu/data/batches.py): the same fields, holding numpy arrays
on the host or tensors on a device."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch


class Batch(NamedTuple):
    x_struct: Any  # [B, T, F] binned lab time series
    m_struct: Any  # [B, T] 1 = valid bin
    note_ids: Any  # [B, S, L] pretokenized chunk token ids (int32)
    note_attn: Any  # [B, S, L] token attention mask
    chunk_mask: Any  # [B, S] 1 = real chunk
    image: Any  # [B, H, W, 3]
    has_l: Any  # [B] modality presence flags
    has_n: Any  # [B]
    has_i: Any  # [B]
    y: Any  # [B] (mort) or [B, K] (pheno multi-label)
    sens: Optional[Any] = None  # [B] sensitive group id
    chexpert: Optional[Any] = None  # [B, 14] CheXpert aux labels
    note_chunk_embs: Optional[Any] = None  # [B, S, bert_hidden] precomputed chunk embeddings

    @property
    def batch_size(self) -> int:
        return self.x_struct.shape[0]

    def notes_dict(self) -> Dict[str, Any]:
        d = {"input_ids": self.note_ids, "attention_mask": self.note_attn, "chunk_mask": self.chunk_mask}
        if self.note_chunk_embs is not None:
            d["chunk_embs"] = self.note_chunk_embs
        return d


def batch_to(batch: Batch, device) -> Batch:
    """Every present field as a tensor on `device`."""

    def put(v):
        if v is None:
            return None
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        return t.to(device)

    return Batch(*(put(v) for v in batch))


def take_batch(batch: Batch, idx) -> Batch:
    """Row-gather every present field."""
    return Batch(*(None if v is None else v[idx] for v in batch))


def slice_batch(batch: Batch, start: int, size: int) -> Batch:
    return take_batch(batch, slice(start, start + size))


def concat_batches(batches) -> Batch:
    """Concatenate host batches along the batch axis, as numpy; optional
    fields must be present in every input or in none."""
    fields = []
    for vals in zip(*batches):
        present = [v is not None for v in vals]
        if not any(present):
            fields.append(None)
        elif all(present):
            fields.append(np.concatenate([np.asarray(v) for v in vals], axis=0))
        else:
            raise ValueError("cannot concat batches with mixed None/array fields")
    return Batch(*fields)
