"""MedFuse-parity preprocessing: Discretizer, Normalizer, pairing modes.

Counterpart of ``multimodalrouting_tpu/data/medfuse.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Parity targets (reference MedFuse_Preprocessing/):
  * Discretizer — ehr_utils/preprocessing.py:11-177: time-binning of
    irregular EHR rows with per-channel one-hot expansion for categorical
    channels, impute strategies zero/normal_value/previous/next, and an
    appended per-channel observation-mask block. Bin rule
    bin = int(t/timestep - eps); later values overwrite earlier in-bin ones.
  * Normalizer — ehr_utils/preprocessing.py:180-231: streaming mean/std
    (Bessel-corrected) with JSON persistence (the reference pickles).
  * Pairing — datasets/fusion.py:39-99 (MIMIC_CXR_EHR): paired_ehr_cxr /
    paired_ehr / radiology / partial_ehr / partial_ehr_cxr with data_ratio
    resampling of unpaired stays (ratio forced to 1.0 on test, 0.0 on val).

The discretizer is vectorized over rows; the per-stay output feeds the
76-feature structured channel grid of the flagship (F = continuous + one-hot
+ mask columns).
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EPS = 1e-6

#: default 17-channel config (continuous channels; categorical GCS channels
#: carry MedFuse-style possible values)
DEFAULT_CHANNELS: Dict[str, dict] = {
    "id_to_channel": [
        "Capillary refill rate", "Diastolic blood pressure",
        "Fraction inspired oxygen", "Glascow coma scale eye opening",
        "Glascow coma scale motor response", "Glascow coma scale total",
        "Glascow coma scale verbal response", "Glucose", "Heart Rate",
        "Height", "Mean blood pressure", "Oxygen saturation",
        "Respiratory rate", "Systolic blood pressure", "Temperature",
        "Weight", "pH",
    ],
    "is_categorical_channel": {
        "Capillary refill rate": True,
        "Glascow coma scale eye opening": True,
        "Glascow coma scale motor response": True,
        "Glascow coma scale total": True,
        "Glascow coma scale verbal response": True,
    },
    "possible_values": {
        "Capillary refill rate": ["0.0", "1.0"],
        "Glascow coma scale eye opening": ["1", "2", "3", "4"],
        "Glascow coma scale motor response": ["1", "2", "3", "4", "5", "6"],
        "Glascow coma scale total": [str(v) for v in range(3, 16)],
        "Glascow coma scale verbal response": ["1", "2", "3", "4", "5"],
    },
    "normal_values": {
        "Capillary refill rate": "0.0",
        "Diastolic blood pressure": "59.0",
        "Fraction inspired oxygen": "0.21",
        "Glascow coma scale eye opening": "4",
        "Glascow coma scale motor response": "6",
        "Glascow coma scale total": "15",
        "Glascow coma scale verbal response": "5",
        "Glucose": "128.0",
        "Heart Rate": "86",
        "Height": "170.0",
        "Mean blood pressure": "77.0",
        "Oxygen saturation": "98.0",
        "Respiratory rate": "19",
        "Systolic blood pressure": "118.0",
        "Temperature": "36.6",
        "Weight": "81.0",
        "pH": "7.4",
    },
}


class Discretizer:
    def __init__(
        self,
        timestep: float = 0.8,
        store_masks: bool = True,
        impute_strategy: str = "zero",
        start_time: str = "zero",
        config: Optional[dict] = None,
        config_path: Optional[str] = None,
    ):
        if config is None:
            if config_path:
                with open(config_path) as f:
                    config = json.load(f)
            else:
                config = DEFAULT_CHANNELS
        self._id_to_channel: List[str] = config["id_to_channel"]
        self._channel_to_id = {c: i for i, c in enumerate(self._id_to_channel)}
        self._is_categorical = {
            c: bool(config.get("is_categorical_channel", {}).get(c, False))
            for c in self._id_to_channel
        }
        self._possible_values = config.get("possible_values", {})
        self._normal_values = config.get("normal_values", {})
        self._timestep = timestep
        self._store_masks = store_masks
        self._impute = impute_strategy
        self._start_time = start_time
        if impute_strategy not in ("zero", "normal_value", "previous", "next"):
            raise ValueError(f"invalid impute strategy {impute_strategy!r}")
        if start_time not in ("zero", "relative"):
            raise ValueError(f"invalid start_time {start_time!r}")

        # column layout
        self._begin_pos: List[int] = []
        cur = 0
        for c in self._id_to_channel:
            self._begin_pos.append(cur)
            cur += len(self._possible_values[c]) if self._is_categorical[c] else 1
        self._cont_width = cur

    @property
    def output_header(self) -> List[str]:
        header = []
        for c in self._id_to_channel:
            if self._is_categorical[c]:
                header += [f"{c}->{v}" for v in self._possible_values[c]]
            else:
                header.append(c)
        if self._store_masks:
            header += [f"mask->{c}" for c in self._id_to_channel]
        return header

    def _write(self, data: np.ndarray, bin_id: int, channel: str, value: str):
        cid = self._channel_to_id[channel]
        pos = self._begin_pos[cid]
        if self._is_categorical[channel]:
            one_hot = np.zeros(len(self._possible_values[channel]))
            one_hot[self._possible_values[channel].index(str(value))] = 1.0
            data[bin_id, pos : pos + len(one_hot)] = one_hot
        else:
            data[bin_id, pos] = float(value)

    def transform(
        self, rows: Sequence[Sequence[str]], header: Optional[Sequence[str]] = None,
        end: Optional[float] = None,
    ) -> Tuple[np.ndarray, List[str]]:
        """rows: [[hours, ch1, ch2, ...], ...] sorted by hours; '' = missing."""
        if header is None:
            header = ["Hours"] + self._id_to_channel
        assert header[0] == "Hours"
        ts = [float(r[0]) for r in rows]
        first = ts[0] if (self._start_time == "relative" and ts) else 0.0
        max_hours = (end if end is not None else (max(ts) if ts else 0.0)) - first
        n_bins = int(max_hours / self._timestep + 1.0 - EPS)
        n_ch = len(self._id_to_channel)

        data = np.zeros((n_bins, self._cont_width))
        mask = np.zeros((n_bins, n_ch), dtype=int)
        original: List[List[str]] = [["" for _ in range(n_ch)] for _ in range(n_bins)]

        for row in rows:
            t = float(row[0]) - first
            if t > max_hours + EPS:
                continue
            bin_id = int(t / self._timestep - EPS)
            for j in range(1, len(row)):
                if row[j] == "":
                    continue
                channel = header[j]
                cid = self._channel_to_id[channel]
                mask[bin_id][cid] = 1
                self._write(data, bin_id, channel, row[j])
                original[bin_id][cid] = row[j]

        if self._impute in ("normal_value", "previous"):
            prev: List[List[str]] = [[] for _ in range(n_ch)]
            for b in range(n_bins):
                for channel in self._id_to_channel:
                    cid = self._channel_to_id[channel]
                    if mask[b][cid] == 1:
                        prev[cid].append(original[b][cid])
                        continue
                    if self._impute == "normal_value" or not prev[cid]:
                        value = self._normal_values[channel]
                    else:
                        value = prev[cid][-1]
                    self._write(data, b, channel, value)
        elif self._impute == "next":
            nxt: List[List[str]] = [[] for _ in range(n_ch)]
            for b in range(n_bins - 1, -1, -1):
                for channel in self._id_to_channel:
                    cid = self._channel_to_id[channel]
                    if mask[b][cid] == 1:
                        nxt[cid].append(original[b][cid])
                        continue
                    value = nxt[cid][-1] if nxt[cid] else self._normal_values[channel]
                    self._write(data, b, channel, value)

        if self._store_masks:
            data = np.hstack([data, mask.astype(np.float32)])
        return data.astype(np.float32), self.output_header


class Normalizer:
    """Streaming mean/std normalizer with JSON persistence."""

    def __init__(self, fields: Optional[Sequence[int]] = None):
        self._fields = list(fields) if fields is not None else None
        self._sum = None
        self._sum_sq = None
        self._count = 0
        self.means = None
        self.stds = None

    def feed(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        self._count += x.shape[0]
        if self._sum is None:
            self._sum = x.sum(axis=0)
            self._sum_sq = (x**2).sum(axis=0)
        else:
            self._sum += x.sum(axis=0)
            self._sum_sq += (x**2).sum(axis=0)

    def finalize(self):
        eps = 1e-7
        n = self._count
        self.means = self._sum / n
        var = (self._sum_sq - 2.0 * self._sum * self.means + n * self.means**2) / (n - 1)
        self.stds = np.sqrt(np.maximum(var, 0.0))
        self.stds[self.stds < eps] = eps
        return self

    def save(self, path: str):
        if self.means is None:
            self.finalize()
        with open(path, "w") as f:
            json.dump({"means": self.means.tolist(), "stds": self.stds.tolist()}, f)

    def load(self, path: str):
        with open(path) as f:
            d = json.load(f)
        self.means = np.asarray(d["means"])
        self.stds = np.asarray(d["stds"])
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        out = np.array(x, dtype=np.float64)
        cols = self._fields if self._fields is not None else range(x.shape[1])
        for c in cols:
            out[:, c] = (x[:, c] - self.means[c]) / self.stds[c]
        return out.astype(np.float32)


@dataclass
class PairingConfig:
    data_pairs: str = "paired_ehr_cxr"
    data_ratio: float = 1.0
    split: str = "train"
    seed: int = 0


def build_pairing_index(
    ehr_stays: Sequence[str],
    paired_stays: Sequence[str],
    paired_dicoms: Sequence[str],
    cfg: PairingConfig,
) -> List[Tuple[Optional[str], Optional[str]]]:
    """Materialize the (stay, dicom) sample list for a pairing mode.

    Mirrors MIMIC_CXR_EHR.__len__/__getitem__: val forces ratio 0.0, test
    forces 1.0; partial_ehr_cxr appends ratio * |unpaired| EHR-only samples
    drawn at random.
    """
    ratio = cfg.data_ratio
    if cfg.split == "test":
        ratio = 1.0
    elif cfg.split == "val":
        ratio = 0.0

    paired = list(zip(paired_stays, paired_dicoms))
    unpaired = sorted(set(ehr_stays) - set(paired_stays))
    mode = cfg.data_pairs
    if mode == "paired_ehr_cxr":
        return [(s, d) for s, d in paired]
    if mode == "paired_ehr":
        return [(s, None) for s, _ in paired]
    if mode == "radiology":
        return [(None, d) for _, d in paired]
    if mode == "partial_ehr":
        return [(s, None) for s in ehr_stays]
    if mode == "partial_ehr_cxr":
        rng = random.Random(cfg.seed)
        out: List[Tuple[Optional[str], Optional[str]]] = [(s, d) for s, d in paired]
        n_extra = int(ratio * len(unpaired))
        for _ in range(n_extra):
            out.append((unpaired[rng.randint(0, len(unpaired) - 1)], None))
        return out
    raise ValueError(f"Unknown data_pairs mode {mode!r}")


# ---------------------------------------------------------------------------
# MedFuse dataset directory chain (EHRdataset + fusion_main semantics)
# ---------------------------------------------------------------------------
#
# The reference drives the Discretizer/Normalizer above from a MedFuse-format
# benchmark directory:
#   {ehr_data_dir}/{task}/train/<name>_timeseries.csv   per-stay irregular rows
#   {ehr_data_dir}/{task}/{split}_listfile.csv          name,period,stay_id,y...
# via datasets/ehr_dataset.py:12-110 (EHRdataset) and fusion_main.py:27-71.
# These functions re-create that chain as an offline exporter: the per-stay
# CSVs are discretized/normalized ONCE and written to the same parquet model
# inputs the runtime loader consumes (static shapes, no per-batch CSV parsing
# or worker processes on the training path).


@dataclass
class MedFuseListfile:
    """Parsed {split}_listfile.csv (reference ehr_dataset.py:20-45).

    `classes` = header columns [3:]; `data_map[name]` carries labels (float
    list), stay_id (col 2) and the period-length bound `time` (col 1).
    """

    names: List[str]
    classes: List[str]
    data_map: Dict[str, dict]


def load_listfile(path: str) -> MedFuseListfile:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    header = lines[0].strip().split(",")
    classes = header[3:]
    data_map: Dict[str, dict] = {}
    for ln in lines[1:]:
        mas = ln.split(",")
        data_map[mas[0]] = {
            "labels": [float(v) for v in mas[3:]],
            "stay_id": float(mas[2]),
            "time": float(mas[1]),
        }
    return MedFuseListfile(names=list(data_map.keys()), classes=classes,
                           data_map=data_map)


def read_timeseries_csv(
    path: str, time_bound: Optional[float] = None
) -> Tuple[List[List[str]], List[str]]:
    """Per-stay timeseries CSV -> (rows, header); '' cells = missing.

    Parity: EHRdataset._read_timeseries (ehr_dataset.py:47-60) — header must
    start with "Hours"; rows AFTER the first t > time_bound+1e-6 are dropped
    (the reference `break`s, so a later in-bound row after an out-of-bound one
    is also dropped — kept faithfully).
    """
    rows: List[List[str]] = []
    with open(path) as f:
        header = f.readline().strip().split(",")
        assert header[0] == "Hours", f"{path}: first column must be Hours"
        for line in f:
            mas = line.strip().split(",")
            if time_bound is not None and float(mas[0]) > time_bound + 1e-6:
                break
            rows.append(mas)
    return rows, header


def load_medfuse_stay(
    dataset_dir: str,
    name: str,
    meta: dict,
    discretizer: "Discretizer",
    normalizer: Optional["Normalizer"] = None,
    period_length: float = 48.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One stay -> (data [T,F] float32, labels) — EHRdataset.__getitem__
    (ehr_dataset.py:93-104): end = listfile time if > 0 else period_length;
    discretize to that bound; normalize continuous fields."""
    import os

    rows, header = read_timeseries_csv(os.path.join(dataset_dir, name))
    ts = meta["time"] if meta["time"] > 0.0 else period_length
    data, _ = discretizer.transform(rows, header=header, end=ts)
    if normalizer is not None:
        data = normalizer.transform(data)
    return data.astype(np.float32), np.asarray(meta["labels"], np.float32)


def continuous_fields(output_header: Sequence[str]) -> List[int]:
    """Indices of non-one-hot columns (fusion_main.py:46-47: cont_channels =
    header entries without '->'); these are the normalized fields."""
    return [i for i, c in enumerate(output_header) if "->" not in c]


def fit_normalizer(
    dataset_dir: str,
    listfile: MedFuseListfile,
    discretizer: "Discretizer",
    period_length: float = 48.0,
) -> "Normalizer":
    """Fit mean/std over the train split's discretized rows.

    The reference ships pre-pickled normalizer states (fusion_main.py:49-54
    loads `normalizers/ph_ts{...}.normalizer`); fitting over the train split
    is the from-scratch path that produces the same statistics the MedFuse
    pipeline computed offline."""
    import os

    norm = Normalizer(fields=continuous_fields(discretizer.output_header))
    for name in listfile.names:
        meta = listfile.data_map[name]
        rows, header = read_timeseries_csv(os.path.join(dataset_dir, name))
        ts = meta["time"] if meta["time"] > 0.0 else period_length
        data, _ = discretizer.transform(rows, header=header, end=ts)
        norm.feed(data)
    return norm.finalize()


def pair_cxr_metadata(
    cxr_metadata,
    icu_stays,
    task: str = "phenotyping",
):
    """AP-view last-in-window CXR per stay (fusion.py loadmetadata:105-141).

    cxr_metadata: DataFrame with subject_id, dicom_id, StudyDate, StudyTime,
    ViewPosition (mimic-cxr-2.0.0-metadata.csv schema). icu_stays: DataFrame
    with subject_id, stay_id, intime, outtime (all_stays.csv schema). Window
    end = intime + 48h for in-hospital-mortality, else outtime; AP views
    only; latest StudyDateTime per stay wins.
    """
    import pandas as pd

    cols = ["subject_id", "stay_id", "intime", "outtime"]
    merged = cxr_metadata.merge(icu_stays[cols], how="inner", on="subject_id")
    study_time = merged["StudyTime"].apply(lambda x: f"{int(float(x)):06}")
    merged["StudyDateTime"] = pd.to_datetime(
        merged["StudyDate"].astype(str) + " " + study_time.astype(str),
        format="%Y%m%d %H%M%S",
    )
    intime = pd.to_datetime(merged["intime"])
    outtime = pd.to_datetime(merged["outtime"])
    end_time = outtime
    if task == "in-hospital-mortality":
        end_time = intime + pd.DateOffset(hours=48)
    in_window = merged.loc[(merged["StudyDateTime"] >= intime) & (merged["StudyDateTime"] <= end_time)]
    ap = in_window[in_window["ViewPosition"] == "AP"]
    if not len(ap):
        return ap
    return (
        ap.sort_values("StudyDateTime").groupby("stay_id").tail(1).reset_index(drop=True)
    )


def medfuse_export(
    ehr_data_dir: str,
    task: str,
    out_dir: str,
    *,
    timestep: float = 1.0,
    impute_strategy: str = "previous",
    start_time: str = "zero",
    config_path: Optional[str] = None,
    normalizer_state: Optional[str] = None,
    period_length: float = 48.0,
    cxr_data_dir: Optional[str] = None,
    icu_stays_csv: Optional[str] = None,
    data_pairs: str = "partial_ehr_cxr",
    data_ratio: float = 1.0,
    seed: int = 0,
) -> dict:
    """MedFuse benchmark directory -> parquet model inputs (fusion_main.py
    chain, ehr_dataset.py get_datasets split layout), offline.

    Reads {ehr_data_dir}/{task}/{split}_listfile.csv (val stays live in the
    train/ directory, ehr_dataset.py:109-112), discretizes + normalizes every
    stay once, pairs AP CXRs by StudyDateTime window when cxr_data_dir (with
    resized/**/*.jpg + mimic-cxr-2.0.0-metadata.csv) and icu_stays_csv
    (all_stays.csv) are given, and writes the loader-consumable export:
    structured_48h.parquet / images_48h.parquet / notes_48h.parquet (MedFuse
    has no notes; empty) / labels.parquet / splits.json. The normalizer is
    loaded from `normalizer_state` (JSON) or fit on the train split and saved
    to medfuse_normalizer.json.

    `data_pairs`/`data_ratio` materialize the MIMIC_CXR_EHR sample lists
    (fusion.py:39-99) into splits.json — partial_ehr_cxr appends
    ratio*|unpaired| EHR-only draws (val forces 0.0, test 1.0). The
    `radiology` mode (image-only, no stays) has no stay-centric equivalent
    here; train the CXR encoder's CheXpert head instead (models/cxr.py).
    """
    import glob
    import os

    import pandas as pd

    if data_pairs == "radiology":
        raise ValueError("radiology mode is image-only; it has no stay-centric export")

    os.makedirs(out_dir, exist_ok=True)
    disc = Discretizer(
        timestep=timestep, store_masks=True, impute_strategy=impute_strategy,
        start_time=start_time, config_path=config_path,
    )

    listfiles = {
        s: load_listfile(os.path.join(ehr_data_dir, task, f"{s}_listfile.csv"))
        for s in ("train", "val", "test")
    }
    split_dirs = {  # val stays are stored under train/ (ehr_dataset.py:110)
        "train": os.path.join(ehr_data_dir, task, "train"),
        "val": os.path.join(ehr_data_dir, task, "train"),
        "test": os.path.join(ehr_data_dir, task, "test"),
    }

    norm = Normalizer(fields=continuous_fields(disc.output_header))
    if normalizer_state:
        norm.load(normalizer_state)
    else:
        norm = fit_normalizer(split_dirs["train"], listfiles["train"], disc,
                              period_length=period_length)
    norm.save(os.path.join(out_dir, "medfuse_normalizer.json"))

    # ---- CXR pairing (optional) ----
    paired_by_stay: Dict[int, str] = {}  # stay_id -> image path
    if cxr_data_dir and icu_stays_csv:
        meta_csv = os.path.join(cxr_data_dir, "mimic-cxr-2.0.0-metadata.csv")
        cxr_meta = pd.read_csv(meta_csv)
        stays = pd.read_csv(icu_stays_csv)
        pairs = pair_cxr_metadata(cxr_meta, stays, task=task)
        dicom_to_path = {
            os.path.basename(p).split(".")[0]: p
            for p in glob.glob(os.path.join(cxr_data_dir, "resized", "**", "*.jpg"),
                               recursive=True)
        }
        for _, r in pairs.iterrows():
            p = dicom_to_path.get(str(r["dicom_id"]))
            if p is not None:
                paired_by_stay[int(r["stay_id"])] = p

    n_bins_cap = int(period_length / timestep + 1.0 - EPS)
    header = disc.output_header
    var_cols = [c.replace(",", "_") for c in header]

    struct_rows: List[dict] = []
    label_rows: List[dict] = []
    image_rows: List[dict] = []
    splits: Dict[str, List[int]] = {}
    classes = listfiles["train"].classes

    for split, lf in listfiles.items():
        ddir = split_dirs[split]
        stay_of_name: Dict[str, int] = {}
        seen: set = set()
        for name in lf.names:
            meta = lf.data_map[name]
            sid = int(meta["stay_id"])
            stay_of_name[name] = sid
            if sid in seen:
                continue
            seen.add(sid)
            data, y = load_medfuse_stay(ddir, name, meta, disc, norm,
                                        period_length=period_length)
            for b in range(min(data.shape[0], n_bins_cap)):
                struct_rows.append({"stay_id": sid, "bin": b,
                                    **dict(zip(var_cols, data[b].tolist()))})
            row = {"stay_id": sid}
            if len(classes) > 1:  # phenotyping: 25 CCS columns + mort placeholder
                for c, v in zip(classes, y.tolist()):
                    row[f"CCS_{c.replace(' ', '_').replace(',', '')}"] = float(v)
                row["mortality"] = 0.0
            else:
                row["mortality"] = float(y[0])
            label_rows.append(row)
            img_path = paired_by_stay.get(sid)
            image_rows.append({
                "stay_id": sid,
                "has_image": int(img_path is not None),
                "image_path": img_path or "",
            })

        # materialize the pairing-mode sample list for this split
        pcfg = PairingConfig(data_pairs=data_pairs, data_ratio=data_ratio,
                             split=split, seed=seed)
        ehr_names = list(lf.names)
        paired_names = [nm for nm in ehr_names if stay_of_name[nm] in paired_by_stay]
        paired_dicoms = [paired_by_stay[stay_of_name[nm]] for nm in paired_names]
        index = build_pairing_index(ehr_names, paired_names, paired_dicoms, pcfg)
        splits[split] = [stay_of_name[nm] for nm, _ in index if nm is not None]

    pd.DataFrame(struct_rows).to_parquet(
        os.path.join(out_dir, "structured_48h.parquet"), index=False)
    pd.DataFrame(label_rows).drop_duplicates("stay_id").to_parquet(
        os.path.join(out_dir, "labels.parquet"), index=False)
    pd.DataFrame(image_rows).drop_duplicates("stay_id").to_parquet(
        os.path.join(out_dir, "images_48h.parquet"), index=False)
    # MedFuse cohorts carry no clinical notes: empty pretokenized table
    pd.DataFrame({
        "stay_id": pd.Series([], dtype=np.int64),
        "input_ids": pd.Series([], dtype=object),
        "attention_mask": pd.Series([], dtype=object),
        "chunk_mask": pd.Series([], dtype=object),
        "shape_s": pd.Series([], dtype=np.int64),
        "shape_l": pd.Series([], dtype=np.int64),
    }).to_parquet(os.path.join(out_dir, "notes_48h.parquet"), index=False)
    with open(os.path.join(out_dir, "splits.json"), "w") as f:
        json.dump({k: [int(s) for s in v] for k, v in splits.items()}, f)

    return {
        "out": out_dir,
        "features": len(var_cols),
        "bins": n_bins_cap,
        "classes": classes,
        "paired_stays": len(paired_by_stay),
        "splits": {k: len(v) for k, v in splits.items()},
    }
