"""Memory-bounded streaming loader for real-scale cohorts.

Counterpart of ``multimodalrouting_tpu/data/streaming.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

`load_split` (data/loader.py) materializes a whole split as dense host
arrays — fine at demo scale, impossible for cohorts that don't fit host RAM.
`iter_split_batches` yields the SAME static-shape Batches by streaming the
four exported parquet files (structured/notes/images/labels) through
pyarrow record-batch readers and assembling per-batch arrays from a bounded
join buffer. The exporter writes all four files in the same master stay
order (data/exporter.py), so the join buffer stays O(record-batch) in
practice; out-of-order files still work (the buffer grows only until each
stay's four parts meet).

This is the SURVEY §7 host-pipeline plan's first rung (chunked reads +
per-batch assembly); sharded array-record files can slot behind the same
iterator later. Reference counterpart: the torch DataLoader worker pipeline
(MortModel/Paired_Cross_Attention/main.py:1158-1364) — which also never
holds a full split in memory.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from multimodalrouting_tpu_torch.data.batches import Batch


@dataclass
class StreamStats:
    """Observability for the bounded join: high-water marks."""

    max_buffered_stays: int = 0
    stays_seen: int = 0
    batches_emitted: int = 0


def _row_streams(export_dir: str, columns_by_file: Dict[str, Optional[List[str]]],
                 rows_per_read: int):
    """Per-file iterators of (stay_id, row-dict), streamed via pyarrow."""
    import pyarrow.parquet as pq

    def stream(fname, columns):
        pf = pq.ParquetFile(os.path.join(export_dir, fname))
        cols = columns
        if cols is not None:
            have = set(pf.schema_arrow.names)
            cols = [c for c in cols if c in have]
        for rb in pf.iter_batches(batch_size=rows_per_read, columns=cols):
            data = rb.to_pydict()
            n = len(data["stay_id"])
            for i in range(n):
                yield int(data["stay_id"][i]), {k: v[i] for k, v in data.items()}

    return {name: stream(name, cols) for name, cols in columns_by_file.items()}


def iter_split_batches(
    export_dir: str,
    split: str,
    *,
    batch_size: int,
    task: str = "mort",
    image_size: int = 224,
    image_loader: Optional[Callable[[object], np.ndarray]] = None,
    image_dtype: type = np.float32,
    rows_per_read: int = 1024,
    shuffle_buffer: int = 0,
    seed: int = 0,
    drop_remainder: bool = False,
    resample_weight: Optional[Callable[[Dict], float]] = None,
    stats: Optional[StreamStats] = None,
) -> Iterator[Tuple[Batch, np.ndarray]]:
    """Yield (Batch, stay_ids) for `split` without materializing the split.

    Batches match load_split's per-stay semantics exactly (same fill rules,
    same has_i-only-on-decoded-pixels contract). shuffle_buffer > 0 applies
    a bounded reservoir shuffle (tf.data-style); 0 preserves file order.
    """
    import pandas as pd

    with open(os.path.join(export_dir, "splits.json")) as f:
        wanted = {int(s) for s in json.load(f)[split]}

    streams = _row_streams(
        export_dir,
        {
            "structured_48h.parquet": None,
            "notes_48h.parquet": None,
            "images_48h.parquet": None,
            "labels.parquet": None,
        },
        rows_per_read,
    )

    # --- structured stream: fold contiguous (stay, bin) rows into [T,F] ---
    def struct_stays():
        cur_sid, rows = None, []
        for sid, row in streams["structured_48h.parquet"]:
            if cur_sid is not None and sid != cur_sid:
                yield cur_sid, rows
                rows = []
            cur_sid = sid
            rows.append(row)
        if cur_sid is not None:
            yield cur_sid, rows

    def fold_struct(rows):
        var_cols = [c for c in rows[0] if c not in ("stay_id", "bin")]
        t = max(int(r["bin"]) for r in rows) + 1
        arr = np.zeros((t, len(var_cols)), np.float32)
        for r in rows:
            arr[int(r["bin"])] = [float(r[c]) for c in var_cols]
        return var_cols, arr

    # --- bounded join across the four part-streams ---
    parts: Dict[int, Dict[str, object]] = {}
    NEEDED = ("struct", "note", "image", "label")

    def feed():
        """Round-robin the four streams; yield stays whose parts all met."""
        iters = {
            "struct": struct_stays(),
            "note": streams["notes_48h.parquet"],
            "image": streams["images_48h.parquet"],
            "label": streams["labels.parquet"],
        }
        live = dict(iters)
        while live:
            for key in list(live):
                try:
                    sid, payload = next(live[key])
                except StopIteration:
                    del live[key]
                    continue
                slot = parts.setdefault(sid, {})
                slot[key] = payload
                if stats is not None:
                    stats.max_buffered_stays = max(stats.max_buffered_stays, len(parts))
                if all(k in slot for k in NEEDED):
                    done = parts.pop(sid)
                    if sid in wanted:
                        yield sid, done
        # trailing stays missing some part are dropped (mirrors load_split's
        # zero-fill of absent modalities only when the stay row exists at all)
        parts.clear()

    stay_iter: Iterator = feed()
    if resample_weight is not None:
        # streaming analogue of WeightedRandomSampler-with-replacement:
        # emit each stay k times with E[k] = its weight normalized to mean 1
        # (floor + Bernoulli fraction), so the epoch's expected sample counts
        # match the reference sampler's (main.py:2695-2715); the shuffle
        # buffer below disperses the duplicates
        def resampled(src):
            rng_r = np.random.default_rng((seed * 2654435761 + 17) % (2**32))
            for sid, slot in src:
                r = float(resample_weight(slot["label"]))
                k = int(np.floor(r)) + int(rng_r.random() < (r - np.floor(r)))
                for _ in range(k):
                    yield sid, slot

        stay_iter = resampled(stay_iter)
    if shuffle_buffer > 0:
        def shuffled(src):
            rng = np.random.default_rng(seed)
            buf: List = []
            for item in src:
                buf.append(item)
                if len(buf) >= shuffle_buffer:
                    j = int(rng.integers(0, len(buf)))
                    buf[j], buf[-1] = buf[-1], buf[j]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        stay_iter = shuffled(stay_iter)

    # --- per-batch assembly (load_split fill semantics) ---
    pending: List[Tuple[int, Dict[str, object]]] = []

    def assemble(chunk) -> Tuple[Batch, np.ndarray]:
        n = len(chunk)
        var_cols, first_arr = fold_struct(chunk[0][1]["struct"])
        t = first_arr.shape[0]
        f = len(var_cols)
        note0 = chunk[0][1]["note"]
        s_max = int(note0.get("shape_s", 1))
        l_max = int(note0.get("shape_l", 512))

        x_struct = np.zeros((n, t, f), np.float32)
        m_struct = np.ones((n, t), np.float32)
        note_ids = np.zeros((n, s_max, l_max), np.int32)
        note_attn = np.zeros((n, s_max, l_max), np.int32)
        chunk_mask = np.zeros((n, s_max), np.float32)
        image = np.zeros((n, image_size, image_size, 3), image_dtype)
        has_n = np.zeros(n, np.float32)
        has_i = np.zeros(n, np.float32)
        label0 = chunk[0][1]["label"]
        pheno_cols = [c for c in label0 if c.startswith("CCS_")]
        y = (
            np.zeros((n, len(pheno_cols)), np.float32)
            if task == "pheno" and pheno_cols
            else np.zeros(n, np.float32)
        )

        for idx, (sid, slot) in enumerate(chunk):
            _, arr = fold_struct(slot["struct"])
            x_struct[idx, : arr.shape[0]] = arr[:t]
            note = slot["note"]
            if note.get("input_ids") is not None:
                note_ids[idx] = np.asarray(note["input_ids"], np.int32).reshape(s_max, l_max)
                note_attn[idx] = np.asarray(note["attention_mask"], np.int32).reshape(s_max, l_max)
                chunk_mask[idx] = np.asarray(note["chunk_mask"], np.float32)
                has_n[idx] = float(chunk_mask[idx].sum() > 0)
            img_row = slot["image"]
            if int(img_row.get("has_image") or 0) > 0 and image_loader is not None:
                arr_i = image_loader(pd.Series(img_row))
                if arr_i is not None:
                    image[idx] = arr_i
                    has_i[idx] = 1.0
            label = slot["label"]
            if task == "pheno" and pheno_cols:
                y[idx] = [float(label[c]) for c in pheno_cols]
            elif task == "readmit" and "readmit_30d" in label:
                y[idx] = float(label["readmit_30d"])
            else:
                y[idx] = float(label["mortality"])

        batch = Batch(
            x_struct=x_struct, m_struct=m_struct,
            note_ids=note_ids, note_attn=note_attn, chunk_mask=chunk_mask,
            image=image,
            has_l=np.ones(n, np.float32), has_n=has_n, has_i=has_i,
            y=y, sens=None, chexpert=None,
        )
        return batch, np.asarray([sid for sid, _ in chunk])

    for item in stay_iter:
        if stats is not None:
            stats.stays_seen += 1
        pending.append(item)
        if len(pending) == batch_size:
            if stats is not None:
                stats.batches_emitted += 1
            yield assemble(pending)
            pending = []
    if pending and not drop_remainder:
        if stats is not None:
            stats.batches_emitted += 1
        yield assemble(pending)


class StreamingSplit:
    """train_model-compatible handle over `iter_split_batches`.

    Stands in for the dense `Batch` that `train_model` normally indexes:
    exposes `.batch_size` (total stays in the split) and
    `.epoch_iter(epoch, batch_size)` yielding load_split-identical Batches
    (reservoir-shuffled with an epoch-varied seed). The train loop detects
    it by duck-typing on `epoch_iter` and pulls batches instead of slicing —
    the streaming replacement for the reference's torch DataLoader worker
    pipeline (MortModel/Paired_Cross_Attention/main.py:1158-1364) on cohorts
    that don't fit host RAM.

    Streaming is sequential-access. Chunk bucketing needs random access and
    is rejected by the loop; the weighted positive sampler has a streaming
    analogue — `enable_sampler('sqrt')` resamples the stream record-by-record
    with expected counts equal to the reference's
    WeightedRandomSampler-with-replacement (emission count = floor+Bernoulli
    of the mean-normalized weight), so epochs match in distribution and
    expected length rather than as an exact multiset.
    """

    def __init__(
        self,
        export_dir: str,
        split: str,
        *,
        task: str = "mort",
        image_size: int = 224,
        image_loader: Optional[Callable[[object], np.ndarray]] = None,
        image_dtype: type = np.float32,
        rows_per_read: int = 1024,
        shuffle_buffer: int = 4096,
        seed: int = 0,
    ) -> None:
        import pyarrow.parquet as pq

        self.export_dir = export_dir
        self.split = split
        self.task = task
        self.image_size = image_size
        self.image_loader = image_loader
        self.image_dtype = image_dtype
        self.rows_per_read = rows_per_read
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.stats = StreamStats()
        with open(os.path.join(export_dir, "splits.json")) as f:
            wanted = {int(s) for s in json.load(f)[split]}
        sids = pq.read_table(
            os.path.join(export_dir, "labels.parquet"), columns=["stay_id"]
        )["stay_id"].to_numpy()
        self._n = int(np.isin(sids, np.fromiter(wanted, np.int64, len(wanted))).sum())
        self._example: Optional[Batch] = None
        self._resample_fn: Optional[Callable[[Dict], float]] = None

    @property
    def batch_size(self) -> int:
        return self._n

    def enable_sampler(self, mode: str) -> None:
        """Streaming weighted positive sampling (train.sampler_mode
        sqrt/hybrid): reference w_pos = clip(sqrt(neg/pos), 1, 5)
        (main.py:2695-2715), applied as stochastic stream resampling with
        the same expected per-record counts (see iter_split_batches)."""
        if mode in ("", "none", "pos_weight"):
            self._resample_fn = None
            return
        import pyarrow.parquet as pq

        with open(os.path.join(self.export_dir, "splits.json")) as f:
            wanted = {int(s) for s in json.load(f)[self.split]}
        table = pq.read_table(os.path.join(self.export_dir, "labels.parquet"))
        cols = table.column_names
        if self.task == "readmit" and "readmit_30d" in cols:
            label_col = "readmit_30d"
        elif self.task == "pheno":
            # parity with weighted_sample_order: binarize on the first label
            pheno_cols = [c for c in cols if c.startswith("CCS_")]
            label_col = pheno_cols[0] if pheno_cols else "mortality"
        else:
            label_col = "mortality"
        sids = table["stay_id"].to_numpy()
        vals = table[label_col].to_numpy()
        mask = np.isin(sids, np.fromiter(wanted, np.int64, len(wanted)))
        y_bin = vals[mask].astype(np.float64) > 0.5
        n = max(len(y_bin), 1)
        pos = max(int(y_bin.sum()), 1)
        neg = max(n - pos, 1)
        w_pos = float(np.clip(np.sqrt(neg / pos), 1.0, 5.0))
        mean_w = (neg + pos * w_pos) / n
        r_pos, r_neg = w_pos / mean_w, 1.0 / mean_w

        def weight(label_row: Dict) -> float:
            return r_pos if float(label_row.get(label_col) or 0.0) > 0.5 else r_neg

        self._resample_fn = weight

    def epoch_iter(self, epoch: int, batch_size: int) -> Iterator[Batch]:
        for batch, _sids in iter_split_batches(
            self.export_dir,
            self.split,
            batch_size=batch_size,
            task=self.task,
            image_size=self.image_size,
            image_loader=self.image_loader,
            image_dtype=self.image_dtype,
            rows_per_read=self.rows_per_read,
            shuffle_buffer=self.shuffle_buffer,
            seed=self.seed + epoch,
            drop_remainder=True,
            resample_weight=self._resample_fn,
            stats=self.stats,
        ):
            yield batch

    def example_batch(self, batch_size: int) -> Batch:
        """First batch (unshuffled), for model init shape inference."""
        if self._example is None or self._example.batch_size != batch_size:
            it = iter_split_batches(
                self.export_dir, self.split, batch_size=batch_size,
                task=self.task, image_size=self.image_size,
                image_loader=self.image_loader,
                image_dtype=self.image_dtype,
                rows_per_read=self.rows_per_read,
                shuffle_buffer=0, drop_remainder=True,
            )
            self._example = next(it)[0]
        return self._example
