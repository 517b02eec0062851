"""MIMIC-IV cohort ETL (offline, host-side).

Counterpart of ``multimodalrouting_tpu/data/cohort.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Re-implements the reference cohort builder's semantics (reference:
MIMIC-IV/cohort/build_cohort.py, 1,052 LoC) with a vectorized pipeline:
  * core table loading (build_cohort.py:129 load_core),
  * labels: in-hospital mortality + CCS multi-hot phenotypes from ICD9/10
    maps + COPD ICD9 roots (make_labels:303, _ccs_multilabel:258,
    add_copd_label_icd9:99),
  * cohort filters: adults, first ICU stay, >=48h; IHM label excludes deaths
    before 48h (:658-685),
  * patient-level 70/10/20 split (patient_level_split:325) or predefined
    MedFuse listfiles (apply_predefined_splits:356),
  * CXR pairing: StudyDate/Time parsing, in-stay / in-48h windows, last CXR
    per stay (load_cxr_metadata:158, link_cxr_to_stays:206),
  * chunked streaming of chartevents/labevents (2M-row chunks,
    fetch_chartevents_subset:384),
  * per-stay 24x17 (or 48h/2h) binning with itemid priority, latest-in-bin
    tiebreak, unit normalization (build_stay_matrix:471, normalize_value:426)
    and forward fill (:536-543) — HERE fully vectorized with pandas groupby
    instead of the reference's O(stays x events) Python loops,
  * train-only z-score stats -> normalization.json (:852-868),
  * notes: 0-48h concat + cleaning + chunk boundaries (:931-993).

Outputs: per-stay NPZ + cohort_master.csv.gz + normalization.json, consumed
by data/exporter.py.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import pandas as pd

WINDOW_HOURS = 48
BIN_HOURS = 2
N_BINS = WINDOW_HOURS // BIN_HOURS

# ---------------------------------------------------------------------------
# unit normalization (normalize_value parity)
# ---------------------------------------------------------------------------

UNIT_ALIASES = {
    "mmhg": {"mmhg", "mm hg"},
    "kpa": {"kpa"},
    "c": {"c", "celsius", "°c"},
    "f": {"f", "fahrenheit", "°f"},
    "mg/dl": {"mg/dl"},
    "mmol/l": {"mmol/l"},
    "umol/l": {"µmol/l", "umol/l", "μmol/l"},
}


def canon_unit(s: Optional[str]) -> str:
    if not s or (isinstance(s, float) and np.isnan(s)):
        return ""
    s = str(s).strip().lower()
    for canon, alts in UNIT_ALIASES.items():
        if s in alts:
            return canon
    return s


#: (variable, from_unit, to_unit) -> (scale, offset): x_to = scale*x + offset
UNIT_CONVERSIONS: Dict[Tuple[str, str, str], Tuple[float, float]] = {
    ("Temperature", "f", "c"): (5.0 / 9.0, -32.0 * 5.0 / 9.0),
    ("MeanBP", "kpa", "mmhg"): (7.50062, 0.0),
    ("SysBP", "kpa", "mmhg"): (7.50062, 0.0),
    ("DiasBP", "kpa", "mmhg"): (7.50062, 0.0),
    ("Glucose", "mg/dl", "mmol/l"): (0.0555, 0.0),
    ("Creatinine", "umol/l", "mg/dl"): (0.011312, 0.0),
    ("Creatinine", "mg/dl", "umol/l"): (88.4, 0.0),
    ("BUN", "mg/dl", "mmol/l"): (0.357, 0.0),
}


def normalize_value(variable: str, val: float, unit: str, to_unit: str) -> float:
    if pd.isna(val):
        return np.nan
    scale, offset = UNIT_CONVERSIONS.get(
        (variable, canon_unit(unit), canon_unit(to_unit)), (1.0, 0.0)
    )
    return float(val) * scale + offset


# ---------------------------------------------------------------------------
# core tables + labels
# ---------------------------------------------------------------------------


def _read(path: str, **kw) -> pd.DataFrame:
    comp = "gzip" if path.endswith(".gz") else None
    return pd.read_csv(path, compression=comp, **kw)


def load_core(data_dir: str):
    j = lambda *p: os.path.join(data_dir, *p)  # noqa: E731

    def find(name):
        for cand in (j(f"{name}.csv.gz"), j(f"{name}.csv")):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"{name}.csv[.gz] not in {data_dir}")

    admissions = _read(find("admissions"), parse_dates=["admittime", "dischtime", "deathtime"])
    patients = _read(find("patients"))
    icustays = _read(find("icustays"), parse_dates=["intime", "outtime"])
    diagnoses = _read(find("diagnoses_icd"))
    return admissions, patients, icustays, diagnoses


def compute_age_at_icu(icustays: pd.DataFrame, patients: pd.DataFrame) -> pd.Series:
    x = icustays.merge(
        patients[["subject_id", "anchor_age", "anchor_year"]], on="subject_id", how="left"
    )
    age = x["anchor_age"].fillna(0) + (x["intime"].dt.year - x["anchor_year"])
    return pd.Series(age.values, index=icustays.index).clip(lower=0)


def _clean_icd(codes: pd.Series) -> pd.Series:
    return codes.astype("string").str.upper().str.replace(".", "", regex=False).str.strip()


def ccs_multilabel(
    diagnoses: pd.DataFrame,
    map9: pd.DataFrame,
    map10: pd.DataFrame,
    keep_ids: Optional[Set[str]] = None,
) -> pd.DataFrame:
    """Wide per-hadm multi-hot CCS phenotype frame (columns CCS_<id>_<name>)."""
    dx = diagnoses.copy()
    dx["code"] = _clean_icd(dx["icd_code"])
    dx["icd_version"] = dx["icd_version"].astype(int)
    merged = pd.concat(
        [
            dx[dx["icd_version"] == 9].merge(map9, on="code", how="left"),
            dx[dx["icd_version"] == 10].merge(map10, on="code", how="left"),
        ],
        ignore_index=True,
    ).dropna(subset=["ccs_id"])
    if merged.empty:
        return pd.DataFrame(columns=["hadm_id"])
    merged["ccs_id"] = merged["ccs_id"].astype(str).str.strip()
    if keep_ids:
        merged = merged[merged["ccs_id"].isin(keep_ids)]
        if merged.empty:
            return pd.DataFrame(columns=["hadm_id"])
    name = merged["ccs_name"].astype(str).str.replace(r"[^A-Za-z0-9]+", "_", regex=True).str.strip("_")
    merged["ccs_col"] = "CCS_" + merged["ccs_id"] + "_" + name
    merged["val"] = 1
    return (
        merged[["hadm_id", "ccs_col", "val"]]
        .drop_duplicates()
        .pivot(index="hadm_id", columns="ccs_col", values="val")
        .fillna(0)
        .astype("int8")
        .reset_index()
    )


def copd_label_icd9(diagnoses: pd.DataFrame, roots: Sequence[str] = ("491", "492", "494", "496")) -> pd.DataFrame:
    dx = diagnoses[diagnoses["icd_version"].astype(int) == 9].copy()
    if dx.empty:
        return pd.DataFrame(
            {"hadm_id": diagnoses["hadm_id"].unique(), "COPD_bronchiectasis": 0}
        )
    code = _clean_icd(dx["icd_code"])
    pat = re.compile("^(?:%s)" % "|".join(re.escape(r) for r in roots))
    hit = code.str.match(pat, na=False)
    return (
        hit.groupby(dx["hadm_id"]).any().astype("int8").rename("COPD_bronchiectasis").reset_index()
    )


def readmit_30d_label(admissions: pd.DataFrame, days: int = 30) -> pd.DataFrame:
    """30-day hospital readmission label per hadm_id.

    Semantics of the reference's `readmit_30d` column consumed by
    02_BEHRT.py:50 (the reference derives it upstream of the script): 1 if
    the same subject has a LATER hospital admission whose admittime falls
    within `days` days of this admission's discharge. In-hospital deaths are
    labeled 0 (a dead patient cannot be readmitted).
    """
    adm = admissions.copy()
    for c in ("admittime", "dischtime"):
        adm[c] = pd.to_datetime(adm[c])
    adm = adm.sort_values(["subject_id", "admittime"]).reset_index(drop=True)
    next_admit = adm.groupby("subject_id")["admittime"].shift(-1)
    delta_days = (next_admit - adm["dischtime"]).dt.total_seconds() / 86400.0
    lab = ((delta_days >= 0) & (delta_days <= days)).astype("int8")
    if "hospital_expire_flag" in adm.columns:
        lab = lab.where(adm["hospital_expire_flag"].fillna(0).astype(int) == 0, 0)
    return pd.DataFrame({"hadm_id": adm["hadm_id"].values, "readmit_30d": lab.values})


def make_labels(
    icustays, admissions, patients, diagnoses,
    ccs_map9=None, ccs_map10=None, ccs_keep_ids=None,
) -> pd.DataFrame:
    df = icustays.copy()
    df["age"] = compute_age_at_icu(df, patients)
    df = df.merge(admissions[["hadm_id", "hospital_expire_flag"]], on="hadm_id", how="left")
    df = df.rename(columns={"hospital_expire_flag": "mortality"})
    df["mortality"] = df["mortality"].fillna(0).astype("int8")
    if {"subject_id", "admittime", "dischtime"} <= set(admissions.columns):
        readmit = readmit_30d_label(admissions)
        df = df.merge(readmit, on="hadm_id", how="left")
        df["readmit_30d"] = df["readmit_30d"].fillna(0).astype("int8")
    if ccs_map9 is not None and ccs_map10 is not None:
        wide = ccs_multilabel(diagnoses, ccs_map9, ccs_map10, ccs_keep_ids)
        df = df.merge(wide, on="hadm_id", how="left")
        for c in [c for c in df.columns if c.startswith("CCS_")]:
            df[c] = df[c].fillna(0).astype("int8")
    copd = copd_label_icd9(diagnoses)
    df = df.merge(copd, on="hadm_id", how="left")
    df["COPD_bronchiectasis"] = df["COPD_bronchiectasis"].fillna(0).astype("int8")
    return df


# ---------------------------------------------------------------------------
# filters + splits
# ---------------------------------------------------------------------------


def apply_cohort_filters(
    df: pd.DataFrame,
    admissions: pd.DataFrame,
    *,
    min_age: float = 18.0,
    min_stay_hours: float = WINDOW_HOURS,
) -> pd.DataFrame:
    """adults, first ICU stay per patient, stay >= 48h; IHM excludes deaths
    before the 48h observation window (relabel drop, :672-685)."""
    df = df[df["age"] >= min_age].copy()
    df = df.sort_values(["subject_id", "intime"]).groupby("subject_id", as_index=False).first()
    hours = (df["outtime"] - df["intime"]).dt.total_seconds() / 3600.0
    df = df[hours >= min_stay_hours].copy()

    adm = admissions[["hadm_id", "deathtime"]]
    df = df.merge(adm, on="hadm_id", how="left")
    death_within = (
        df["deathtime"].notna()
        & ((df["deathtime"] - df["intime"]).dt.total_seconds() / 3600.0 < min_stay_hours)
    )
    return df[~death_within].drop(columns=["deathtime"]).reset_index(drop=True)


def patient_level_split(
    subject_ids: pd.Series, seed: int = 2022, train_frac: float = 0.7, val_frac: float = 0.1
) -> Tuple[Set[int], Set[int], Set[int]]:
    sids = subject_ids.drop_duplicates().sample(frac=1.0, random_state=seed).tolist()
    n = len(sids)
    n_train = int(round(train_frac * n))
    n_val = int(round(val_frac * n))
    return set(sids[:n_train]), set(sids[n_train : n_train + n_val]), set(sids[n_train + n_val :])


def apply_predefined_splits(df: pd.DataFrame, listfile_dir: str) -> pd.DataFrame:
    """MedFuse-parity exact splits from train/val/test listfiles containing
    'stay' ids (apply_predefined_splits:356)."""
    out = df.copy()
    out["split"] = "train"
    for split in ("train", "val", "test"):
        path = os.path.join(listfile_dir, f"{split}_listfile.csv")
        if not os.path.exists(path):
            continue
        ids = set(pd.read_csv(path)["stay_id"].astype(int))
        out.loc[out["stay_id"].astype(int).isin(ids), "split"] = split
    return out


# ---------------------------------------------------------------------------
# CXR linking
# ---------------------------------------------------------------------------


def load_cxr_metadata(path: str) -> pd.DataFrame:
    """Parse mimic-cxr metadata: StudyDate (YYYYMMDD) + StudyTime (HHMMSS.frac)
    -> studydatetime."""
    meta = _read(path)
    date = meta["StudyDate"].astype("Int64").astype(str).str.zfill(8)
    time = (
        meta["StudyTime"].fillna(0).astype(float).astype(int).astype(str).str.zfill(6).str[:6]
    )
    meta["studydatetime"] = pd.to_datetime(
        date + time, format="%Y%m%d%H%M%S", errors="coerce"
    )
    return meta


def link_cxr_to_stays(
    stays: pd.DataFrame, cxr_meta: pd.DataFrame, *, window_hours: Optional[float] = WINDOW_HOURS
) -> pd.DataFrame:
    """Last CXR whose study time falls inside the stay (or first window_hours).

    Returns stays with dicom_id/study_id/studydatetime columns (NaN if none).
    """
    m = cxr_meta.merge(stays[["subject_id", "stay_id", "intime", "outtime"]], on="subject_id")
    end = (
        m["intime"] + pd.Timedelta(hours=window_hours)
        if window_hours is not None
        else m["outtime"]
    )
    in_window = (m["studydatetime"] >= m["intime"]) & (m["studydatetime"] <= np.minimum(end, m["outtime"]))
    m = m[in_window]
    last = (
        m.sort_values("studydatetime").groupby("stay_id", as_index=False).last()[
            ["stay_id", "dicom_id", "study_id", "studydatetime"]
        ]
    )
    return stays.merge(last, on="stay_id", how="left")


# ---------------------------------------------------------------------------
# event streaming + vectorized stay matrices
# ---------------------------------------------------------------------------


def stream_events(
    path: str,
    itemids: Sequence[int],
    key_col: str,
    key_ids: Sequence[int],
    *,
    chunksize: int = 2_000_000,
) -> pd.DataFrame:
    usecols = [key_col, "charttime", "itemid", "valuenum", "valueuom"]
    keep_items, keep_keys = set(itemids), set(key_ids)
    chunks = []
    for chunk in pd.read_csv(
        path,
        compression="gzip" if path.endswith(".gz") else None,
        usecols=usecols,
        parse_dates=["charttime"],
        chunksize=chunksize,
    ):
        c = chunk[chunk["itemid"].isin(keep_items) & chunk[key_col].isin(keep_keys)]
        if not c.empty:
            chunks.append(c)
    if not chunks:
        return pd.DataFrame(columns=usecols)
    return pd.concat(chunks, ignore_index=True).dropna(subset=["charttime", "valuenum"])


def build_stay_matrices(
    stays: pd.DataFrame,
    varmap: pd.DataFrame,
    ce: pd.DataFrame,
    le: pd.DataFrame,
    *,
    n_bins: int = N_BINS,
    bin_hours: int = BIN_HOURS,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Vectorized replacement for the reference's per-stay loop.

    Selection rule per (stay, bin, variable): among candidate events, lowest
    itemid priority wins; ties broken by latest charttime (build_stay_matrix
    :530-534). Forward-fill along bins afterwards. Returns
    (X [S, n_bins, V], M [S, n_bins, V] observed mask, variables).

    use_native=True routes the winner selection through the C++ one-pass
    binner (native/binner.cpp) when a toolchain is available; the pandas
    path below is the portable fallback and the parity oracle.
    """
    variables = list(dict.fromkeys(varmap["variable"]))
    var_idx = {v: i for i, v in enumerate(variables)}
    v = len(variables)
    s = len(stays)
    stay_pos = {int(r): i for i, r in enumerate(stays["stay_id"].astype(int))}
    hadm_pos: Dict[int, List[int]] = {}
    for i, h in enumerate(stays["hadm_id"].astype(int)):
        hadm_pos.setdefault(int(h), []).append(i)
    intimes = pd.to_datetime(stays["intime"]).reset_index(drop=True)

    x = np.full((s, n_bins, v), np.nan, dtype="float32")
    m = np.zeros((s, n_bins, v), dtype="int8")

    vm = varmap.copy()
    vm["unit"] = vm.get("unit", "").fillna("") if "unit" in vm else ""
    vm["to_unit"] = vm.get("to_unit", "").fillna("") if "to_unit" in vm else ""

    def process(events: pd.DataFrame, key_col: str):
        if events.empty:
            return
        ev = events.merge(vm, on="itemid", how="inner")
        if ev.empty:
            return
        # map event key -> stay row position(s)
        if key_col == "stay_id":
            ev["row"] = ev[key_col].astype(int).map(stay_pos)
            ev = ev.dropna(subset=["row"])
            ev["row"] = ev["row"].astype(int)
        else:  # hadm: may map to a single first-stay row
            ev = ev[ev[key_col].astype(int).isin(hadm_pos)]
            ev["row"] = ev[key_col].astype(int).map(lambda h: hadm_pos[h][0])
        if ev.empty:
            return
        ev = ev.reset_index(drop=True)
        ev["intime"] = intimes.values[ev["row"].values]
        delta_h = (ev["charttime"] - ev["intime"]).dt.total_seconds() / 3600.0
        ev["bin"] = np.floor(delta_h / bin_hours).astype(int)
        ev = ev[(ev["bin"] >= 0) & (ev["bin"] < n_bins)]
        if ev.empty:
            return
        # unit normalization (vectorized over conversion table)
        uom = ev["valueuom"].map(canon_unit) if "valueuom" in ev else ""
        scale = np.ones(len(ev))
        offset = np.zeros(len(ev))
        for (var, fu, tu), (sc, of) in UNIT_CONVERSIONS.items():
            sel = (
                (ev["variable"] == var).values
                & (np.asarray(uom) == fu)
                & (ev["to_unit"].map(canon_unit) == tu).values
            )
            scale[sel], offset[sel] = sc, of
        ev["value_norm"] = ev["valuenum"].values * scale + offset
        ev["vcol"] = ev["variable"].map(var_idx)
        pr = ev["priority"] if "priority" in ev else 0
        ev["pr"] = pr

        if use_native:
            # native one-pass winner selection (native/binner.cpp); falls
            # through to the pandas path when no toolchain is available
            from multimodalrouting_tpu_torch.data.native_binner import bin_events_native

            # NaN priorities: the pandas path sorts NaN last under
            # ascending=False, so a NaN-priority event wins its cell; mirror
            # that deterministically with the minimal int64 sentinel (lowest
            # priority wins in binner.cpp) instead of an undefined float->int
            # cast of NaN
            pr_f = np.asarray(ev["pr"].values, np.float64)
            pr_i64 = np.where(
                np.isnan(pr_f), np.iinfo(np.int64).min, pr_f
            ).astype(np.int64)
            res = bin_events_native(
                ev["row"].values.astype(np.int64),
                ev["bin"].values.astype(np.int64),
                ev["vcol"].values.astype(np.int64),
                pr_i64,
                ev["charttime"].values.astype("datetime64[ns]").astype(np.int64),
                ev["value_norm"].values.astype(np.float64),
                s, n_bins, v, fill=False,
            )
            if res is not None:
                xc, mc = res
                sel = mc.astype(bool)
                x[sel] = xc[sel]
                m[sel] = 1
                return

        # pandas path: sort so the winner is LAST per group
        ev = ev.sort_values(["row", "bin", "vcol", "pr", "charttime"],
                            ascending=[True, True, True, False, True])
        win = ev.groupby(["row", "bin", "vcol"], as_index=False).last()
        r, b_, c_ = win["row"].values, win["bin"].values, win["vcol"].values
        x[r, b_, c_] = win["value_norm"].values.astype("float32")
        m[r, b_, c_] = 1

    process(ce, "stay_id")
    process(le, "hadm_id")

    # forward fill along bins
    for j in range(v):
        col = x[:, :, j]
        mask = ~np.isnan(col)
        idx = np.where(mask, np.arange(n_bins)[None, :], 0)
        np.maximum.accumulate(idx, axis=1, out=idx)
        filled = col[np.arange(s)[:, None], idx]
        filled[~mask[np.arange(s)[:, None], idx]] = np.nan
        x[:, :, j] = filled
    return x, m, variables


def train_zscore_stats(x: np.ndarray, m: np.ndarray, train_rows: np.ndarray):
    """Train-only per-variable mean/std over observed entries (:852-868)."""
    xt = x[train_rows]
    mt = m[train_rows].astype(bool)
    v = x.shape[2]
    means = np.zeros(v)
    stds = np.ones(v)
    for j in range(v):
        vals = xt[:, :, j][mt[:, :, j]]
        if len(vals):
            means[j] = float(np.nanmean(vals))
            sd = float(np.nanstd(vals))
            stds[j] = sd if sd > 1e-6 else 1.0
    return means, stds


def apply_zscore(x: np.ndarray, means: np.ndarray, stds: np.ndarray) -> np.ndarray:
    out = (x - means[None, None, :]) / stds[None, None, :]
    return np.nan_to_num(out, nan=0.0).astype("float32")


# ---------------------------------------------------------------------------
# notes
# ---------------------------------------------------------------------------

_NOTE_CLEAN_RE = re.compile(r"\[\*\*[^\]]*\*\*\]|_{2,}|\s+")


def clean_note_text(text: str) -> str:
    """De-identification artifact removal + whitespace collapse (:931-993)."""
    if not isinstance(text, str):
        return ""
    return _NOTE_CLEAN_RE.sub(" ", text).strip()


def collect_stay_notes(
    stays: pd.DataFrame,
    notes: pd.DataFrame,
    *,
    window_hours: float = WINDOW_HOURS,
    max_notes_concat: int = 8,
) -> pd.Series:
    """Concat cleaned 0-48h notes per stay (latest max_notes_concat)."""
    n = notes.merge(stays[["hadm_id", "stay_id", "intime"]], on="hadm_id")
    n["charttime"] = pd.to_datetime(n["charttime"])
    keep = (n["charttime"] >= n["intime"]) & (
        n["charttime"] <= n["intime"] + pd.Timedelta(hours=window_hours)
    )
    n = n[keep].sort_values("charttime")
    gathered = n.groupby("stay_id")["text"].apply(
        lambda s: " ".join(clean_note_text(t) for t in s.tail(max_notes_concat))
    )
    return stays["stay_id"].map(gathered).fillna("")


# ---------------------------------------------------------------------------
# top-level builder
# ---------------------------------------------------------------------------


@dataclass
class CohortConfig:
    data_dir: str
    out_dir: str
    varmap_path: str
    cxr_meta_path: Optional[str] = None
    notes_path: Optional[str] = None
    listfile_dir: Optional[str] = None
    seed: int = 2022
    min_age: float = 18.0
    window_hours: int = WINDOW_HOURS
    bin_hours: int = BIN_HOURS
    ccs_map9_path: Optional[str] = None
    ccs_map10_path: Optional[str] = None
    ccs_keep_ids: Tuple[str, ...] = field(default_factory=tuple)


def build_cohort(cfg: CohortConfig) -> pd.DataFrame:
    """End-to-end ETL -> NPZ per stay + cohort_master.csv.gz + stats."""
    os.makedirs(cfg.out_dir, exist_ok=True)
    admissions, patients, icustays, diagnoses = load_core(cfg.data_dir)
    map9 = _read(cfg.ccs_map9_path) if cfg.ccs_map9_path else None
    map10 = _read(cfg.ccs_map10_path) if cfg.ccs_map10_path else None
    labels = make_labels(
        icustays, admissions, patients, diagnoses, map9, map10, set(cfg.ccs_keep_ids) or None
    )
    stays = apply_cohort_filters(
        labels, admissions, min_age=cfg.min_age, min_stay_hours=cfg.window_hours
    )

    if cfg.listfile_dir:
        stays = apply_predefined_splits(stays, cfg.listfile_dir)
    else:
        tr, va, te = patient_level_split(stays["subject_id"], seed=cfg.seed)
        stays["split"] = np.select(
            [stays["subject_id"].isin(tr), stays["subject_id"].isin(va)],
            ["train", "val"],
            default="test",
        )

    if cfg.cxr_meta_path:
        cxr = load_cxr_metadata(cfg.cxr_meta_path)
        stays = link_cxr_to_stays(stays, cxr, window_hours=cfg.window_hours)

    varmap = _read(cfg.varmap_path)
    n_bins = cfg.window_hours // cfg.bin_hours
    itemids = list(varmap["itemid"].astype(int).unique())
    ce_path = os.path.join(cfg.data_dir, "chartevents.csv.gz")
    le_path = os.path.join(cfg.data_dir, "labevents.csv.gz")
    if not os.path.exists(ce_path):
        ce_path = ce_path[:-3]
    if not os.path.exists(le_path):
        le_path = le_path[:-3]
    ce = (
        stream_events(ce_path, itemids, "stay_id", stays["stay_id"].astype(int))
        if os.path.exists(ce_path)
        else pd.DataFrame(columns=["stay_id", "charttime", "itemid", "valuenum", "valueuom"])
    )
    le = (
        stream_events(le_path, itemids, "hadm_id", stays["hadm_id"].astype(int))
        if os.path.exists(le_path)
        else pd.DataFrame(columns=["hadm_id", "charttime", "itemid", "valuenum", "valueuom"])
    )

    x, m, variables = build_stay_matrices(
        stays, varmap, ce, le, n_bins=n_bins, bin_hours=cfg.bin_hours
    )
    train_rows = (stays["split"] == "train").values
    means, stds = train_zscore_stats(x, m, train_rows)
    xz = apply_zscore(x, means, stds)

    with open(os.path.join(cfg.out_dir, "normalization.json"), "w") as f:
        json.dump(
            {"variables": variables, "means": means.tolist(), "stds": stds.tolist()}, f, indent=2
        )

    note_text = None
    if cfg.notes_path and os.path.exists(cfg.notes_path):
        notes = _read(cfg.notes_path)
        note_text = collect_stay_notes(stays, notes, window_hours=cfg.window_hours)

    npz_dir = os.path.join(cfg.out_dir, "stays")
    os.makedirs(npz_dir, exist_ok=True)
    for i, stay_id in enumerate(stays["stay_id"].astype(int)):
        np.savez_compressed(
            os.path.join(npz_dir, f"{stay_id}.npz"),
            x=xz[i],
            mask=m[i].any(axis=1).astype("int8"),
            mask_full=m[i],
        )

    master = stays.copy()
    if note_text is not None:
        master["note_text"] = note_text.values
    master.to_csv(os.path.join(cfg.out_dir, "cohort_master.csv.gz"), index=False)
    return master
