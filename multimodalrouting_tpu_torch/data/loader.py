"""Runtime dataset: exported parquet model inputs -> static-shape Batches.

Counterpart of ``multimodalrouting_tpu/data/loader.py``: ``load_split`` is a
copy whose Batches equal the JAX package's bit for bit
(tests/test_torch_data*.py); ``prefetch_to_device`` is rewritten for CUDA
(pinned host memory, a side stream).

The Dataset/collate layer (SURVEY.md §1 L1) rebuilt for static shapes: everything is
pre-materialized to static shapes at export time (data/exporter.py), so
"collate" is pure array slicing — no per-batch tokenization, no ragged lists,
no worker processes needed for the tensor path (image decode remains a
host-side map). Mirrors the reference ICUStayDataset's schema detection and
tri-modal intersection filter (reference: MIMIC-IV/MortModel/
Paired_Cross_Attention/main.py:1158-1364).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import numpy as np
import pandas as pd

from multimodalrouting_tpu_torch.data.batches import Batch


@dataclass
class CohortArrays:
    """Whole split as host arrays (the synthetic generator emits the same)."""

    batch: Batch
    stay_ids: np.ndarray


def load_split(
    export_dir: str,
    split: str,
    *,
    task: str = "mort",
    image_size: int = 224,
    image_loader: Optional[Callable[[object], np.ndarray]] = None,
    require_all_modalities: bool = False,
    image_dtype: type = np.float32,
) -> CohortArrays:
    with open(os.path.join(export_dir, "splits.json")) as f:
        splits = json.load(f)
    stay_ids = [int(s) for s in splits[split]]

    struct = pd.read_parquet(os.path.join(export_dir, "structured_48h.parquet"))
    notes = pd.read_parquet(os.path.join(export_dir, "notes_48h.parquet")).set_index("stay_id")
    images = pd.read_parquet(os.path.join(export_dir, "images_48h.parquet")).set_index("stay_id")
    labels = pd.read_parquet(os.path.join(export_dir, "labels.parquet")).set_index("stay_id")

    var_cols = [c for c in struct.columns if c not in ("stay_id", "bin")]
    t = int(struct["bin"].max()) + 1
    struct_by_stay = {
        sid: g.sort_values("bin")[var_cols].to_numpy(np.float32)
        for sid, g in struct.groupby("stay_id")
    }

    if require_all_modalities:
        stay_ids = [
            s
            for s in stay_ids
            if s in notes.index and s in images.index and int(images.loc[s, "has_image"]) > 0
        ]

    n = len(stay_ids)
    f = len(var_cols)
    s_max = int(notes["shape_s"].iloc[0]) if len(notes) else 1
    l_max = int(notes["shape_l"].iloc[0]) if len(notes) else 512

    x_struct = np.zeros((n, t, f), np.float32)
    m_struct = np.ones((n, t), np.float32)
    note_ids = np.zeros((n, s_max, l_max), np.int32)
    note_attn = np.zeros((n, s_max, l_max), np.int32)
    chunk_mask = np.zeros((n, s_max), np.float32)
    # uint8 when the image_loader emits raw pixels for on-device
    # normalization (encoder.image_uint8_transfer): 4x less host RAM and
    # host->device bytes; absent stays remain zeros either way and
    # models/cxr.py normalize_pixels multiplies by has_i so they reach the
    # encoder as exact fp32 zeros, same as this buffer's float path
    image = np.zeros((n, image_size, image_size, 3), image_dtype)
    has_n = np.zeros(n, np.float32)
    has_i = np.zeros(n, np.float32)

    pheno_cols = [c for c in labels.columns if c.startswith("CCS_")]
    if task == "pheno" and pheno_cols:
        y = np.zeros((n, len(pheno_cols)), np.float32)
    else:
        y = np.zeros(n, np.float32)

    for idx, sid in enumerate(stay_ids):
        if sid in struct_by_stay:
            arr = struct_by_stay[sid]
            x_struct[idx, : arr.shape[0]] = arr[:t]
        if sid in notes.index:
            row = notes.loc[sid]
            note_ids[idx] = np.asarray(row["input_ids"], np.int32).reshape(s_max, l_max)
            note_attn[idx] = np.asarray(row["attention_mask"], np.int32).reshape(s_max, l_max)
            chunk_mask[idx] = np.asarray(row["chunk_mask"], np.float32)
            has_n[idx] = float(chunk_mask[idx].sum() > 0)
        if sid in images.index and int(images.loc[sid, "has_image"]) > 0:
            # has_i is asserted ONLY when pixels were actually decoded — the
            # parquet flag alone must not claim presence over an all-zero
            # image (round-2 defect: route masks saw has_i=1 with no pixels)
            if image_loader is not None:
                arr = image_loader(images.loc[sid])
                if arr is not None:
                    image[idx] = arr
                    has_i[idx] = 1.0
        if sid in labels.index:
            if task == "pheno" and pheno_cols:
                y[idx] = labels.loc[sid, pheno_cols].to_numpy(np.float32)
            elif task == "readmit" and "readmit_30d" in labels.columns:
                y[idx] = float(labels.loc[sid, "readmit_30d"])
            else:
                y[idx] = float(labels.loc[sid, "mortality"])

    batch = Batch(
        x_struct=x_struct,
        m_struct=m_struct,
        note_ids=note_ids,
        note_attn=note_attn,
        chunk_mask=chunk_mask,
        image=image,
        has_l=np.ones(n, np.float32),
        has_n=has_n,
        has_i=has_i,
        y=y,
        sens=None,
        chexpert=None,
    )
    return CohortArrays(batch=batch, stay_ids=np.asarray(stay_ids))


def prefetch_to_device(
    batches: Iterator[Batch], size: int = 2, device="cuda", sharding=None
) -> Iterator[Batch]:
    """Host->device prefetch pipeline (double-buffering the input stream).

    On a CUDA device each batch is copied from pinned host memory on a side
    stream, up to `size` batches ahead of the consumer, and yielded once the
    consumer's stream waits on the copy's event; the values equal
    ``batch_to(b, device)``'s bit for bit. On another device it is
    ``batch_to`` in the same order. The JAX package's mesh sharding
    (`sharding`) is not ported."""
    import collections

    import torch

    from multimodalrouting_tpu_torch.data.batches import batch_to

    if sharding is not None:
        raise NotImplementedError("sharded prefetch is not ported yet (ROADMAP.md §1 item 12)")
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield batch_to(b, device)
        return

    stream = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def put(b: Batch):
        def pinned(v):
            if v is None:
                return None
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            return t.pin_memory()

        host = [pinned(v) for v in b]
        with torch.cuda.stream(stream):
            dev = Batch(*(None if t is None else t.to(device, non_blocking=True) for t in host))
            done = torch.cuda.Event()
            done.record(stream)
        # the pinned buffers stay referenced until the copy is waited on
        return dev, done, host

    def take():
        dev, done, _host = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in dev:
            if t is not None:
                t.record_stream(current)  # allocated on the side stream, used on this one
        return dev

    for b in batches:
        queue.append(put(b))
        if len(queue) > size:
            yield take()
    while queue:
        yield take()
