"""Legacy single-file cohort pipeline (wide lab pivot + PE/PH labels).

Counterpart of ``multimodalrouting_tpu/data/legacy_cohort.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Parity target: reference Data/icustay_dataset.py:83-197 — first ICU stay per
patient, 0-24h labs pivoted to wide lab_{itemid}_b{bin} columns, PE/PH labels
from ICD-9 415/416 roots, cleaned/chunked notes. (The reference's
train_fame.py imports a nonexistent ICUStayDataset from this module —
SURVEY.md §2.5; here `load_legacy_cohort` is the real, working entry point.)
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from multimodalrouting_tpu_torch.data.cohort import clean_note_text


def pe_ph_labels(diagnoses: pd.DataFrame) -> pd.DataFrame:
    """PE (ICD-9 415.1x) and PH (416.x) per hadm."""
    dx = diagnoses[diagnoses["icd_version"].astype(int) == 9].copy()
    code = dx["icd_code"].astype(str).str.upper().str.replace(".", "", regex=False)
    pe = code.str.startswith("4151")
    ph = code.str.startswith("416")
    agg = pd.DataFrame({"hadm_id": dx["hadm_id"], "pe": pe.astype(int), "ph": ph.astype(int)})
    return agg.groupby("hadm_id", as_index=False).max()


def pivot_labs_wide(
    labevents: pd.DataFrame,
    stays: pd.DataFrame,
    *,
    window_hours: int = 24,
    bin_hours: int = 2,
    top_k_items: Optional[int] = 20,
) -> pd.DataFrame:
    """0-window_hours labs -> wide lab_{itemid}_b{bin} frame per stay."""
    n_bins = window_hours // bin_hours
    le = labevents.merge(stays[["hadm_id", "stay_id", "intime"]], on="hadm_id")
    le["charttime"] = pd.to_datetime(le["charttime"])
    delta = (le["charttime"] - pd.to_datetime(le["intime"])).dt.total_seconds() / 3600.0
    le = le[(delta >= 0) & (delta < window_hours)].copy()
    le["bin"] = (delta[delta.index.isin(le.index)] / bin_hours).astype(int)

    if top_k_items is not None:
        top = le["itemid"].value_counts().head(top_k_items).index
        le = le[le["itemid"].isin(top)]

    le["col"] = "lab_" + le["itemid"].astype(str) + "_b" + le["bin"].astype(str)
    wide = (
        le.groupby(["stay_id", "col"])["valuenum"].mean().unstack("col")
    )
    out = stays[["stay_id"]].merge(wide, on="stay_id", how="left").fillna(0.0)
    return out


def load_legacy_cohort(
    data_dir: str,
    *,
    window_hours: int = 24,
    bin_hours: int = 2,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """-> (structured wide frame + labels, notes frame)."""
    from multimodalrouting_tpu_torch.data.cohort import apply_cohort_filters, load_core, make_labels

    admissions, patients, icustays, diagnoses = load_core(data_dir)
    labels = make_labels(icustays, admissions, patients, diagnoses)
    stays = apply_cohort_filters(labels, admissions, min_stay_hours=window_hours)

    pep = pe_ph_labels(diagnoses)
    stays = stays.merge(pep, on="hadm_id", how="left")
    stays[["pe", "ph"]] = stays[["pe", "ph"]].fillna(0).astype(int)

    le_path = os.path.join(data_dir, "labevents.csv.gz")
    if not os.path.exists(le_path):
        le_path = le_path[:-3]
    le = pd.read_csv(le_path, compression="gzip" if le_path.endswith(".gz") else None,
                     parse_dates=["charttime"])
    wide = pivot_labs_wide(le, stays, window_hours=window_hours, bin_hours=bin_hours)
    structured = stays[["stay_id", "subject_id", "mortality", "pe", "ph"]].merge(
        wide, on="stay_id"
    )

    notes_path = os.path.join(data_dir, "notes.csv.gz")
    notes = pd.DataFrame(columns=["stay_id", "text"])
    if os.path.exists(notes_path):
        raw = pd.read_csv(notes_path, compression="gzip")
        raw = raw.merge(stays[["hadm_id", "stay_id"]], on="hadm_id")
        raw["text"] = raw["text"].map(clean_note_text)
        notes = raw.groupby("stay_id", as_index=False)["text"].apply(" ".join)
    return structured, notes
