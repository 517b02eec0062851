"""INSPECT cohort data scripts (PE CT cohort, OMOP EHR, impressions).

Counterpart of ``multimodalrouting_tpu/data/inspect_etl.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Parity targets (reference INSPECT/Data/):
  * 00: cohort merge — metadata <-> patient mapping <-> labels <-> splits,
    impressions join, and OMOP table filtering to events at or before each
    study_time (00_...py:19-100).
  * 01: long-format EHR over condition/procedure/measurement/drug tables +
    demographics.
  * 02: impressions + labels merge for the text-only model.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import pandas as pd

OMOP_TABLES = {
    "condition_occurrence": "condition_start_DATETIME",
    "procedure_occurrence": "procedure_DATETIME",
    "measurement": "measurement_DATETIME",
    "drug_exposure": "drug_exposure_start_DATETIME",
}

INSPECT_LABELS = (
    "pe_positive_nlp",
    "1_month_mortality",
    "1_month_readmission",
    "12_month_PH",
)


def merge_cohort(
    metadata: pd.DataFrame,
    mapping: pd.DataFrame,
    labels: pd.DataFrame,
    splits: pd.DataFrame,
    impressions: Optional[pd.DataFrame] = None,
) -> pd.DataFrame:
    """00-script: one row per impression/study with patient id, labels, split.

    Accepts either a patient-keyed mapping (patient_id -> person_id) or the
    reference's impression-keyed mapping (impression_id, person_id,
    procedure_DATETIME — renamed to study_time and deduplicated per
    impression, 00_...py:25-37). Labels/splits merges drop stray person_id
    columns like the reference (00_...py:45-56); a split column under any
    name containing 'split' is normalized to `split`.
    """
    mapping = mapping.rename(columns={"procedure_DATETIME": "study_time"})
    if "patient_id" in metadata.columns and "patient_id" in mapping.columns:
        df = metadata.merge(mapping, on="patient_id", how="inner")
    else:
        m = mapping.drop_duplicates(subset=["impression_id"])
        if "study_time" in m.columns:
            m = m.assign(study_time=pd.to_datetime(m["study_time"], errors="coerce"))
        df = metadata.merge(m, on="impression_id", how="inner")
    df = df.merge(labels.drop(columns=["person_id"], errors="ignore"),
                  on="impression_id", how="inner")
    splits = splits.drop(columns=["person_id"], errors="ignore")
    if "split" not in splits.columns:
        alt = [c for c in splits.columns if "split" in c.lower()]
        if alt:
            splits = splits.rename(columns={alt[0]: "split"})
    df = df.merge(splits[["impression_id", "split"]], on="impression_id", how="left")
    df["split"] = df["split"].fillna("train")
    if impressions is not None:
        df = df.merge(impressions[["impression_id", "impressions"]], on="impression_id", how="left")
    return df


def filter_omop_to_study_time(
    events: pd.DataFrame,
    cohort: pd.DataFrame,
    time_col: str,
    *,
    person_col: str = "person_id",
) -> pd.DataFrame:
    """Keep only events at or before the patient's study_time (no leakage)."""
    win = cohort[[person_col, "study_time"]].drop_duplicates()
    out = events.merge(win, on=person_col, how="inner")
    out[time_col] = pd.to_datetime(out[time_col])
    out["study_time"] = pd.to_datetime(out["study_time"])
    return out[out[time_col] <= out["study_time"]].drop(columns=["study_time"])


def build_long_ehr(
    tables: Dict[str, pd.DataFrame],
    cohort: pd.DataFrame,
    demographics: Optional[pd.DataFrame] = None,
) -> pd.DataFrame:
    """01-script: long-format EHR — one row per (person, concept, time, table)."""
    frames: List[pd.DataFrame] = []
    for name, time_col in OMOP_TABLES.items():
        if name not in tables:
            continue
        t = filter_omop_to_study_time(tables[name], cohort, time_col)
        concept_col = next((c for c in t.columns if c.endswith("_concept_id")), None)
        if concept_col is None:
            continue
        frames.append(
            pd.DataFrame(
                {
                    "person_id": t["person_id"],
                    "concept_id": t[concept_col],
                    "event_time": pd.to_datetime(t[time_col]),
                    "table": name,
                }
            )
        )
    long = (
        pd.concat(frames, ignore_index=True)
        if frames
        else pd.DataFrame(columns=["person_id", "concept_id", "event_time", "table"])
    )
    if demographics is not None:
        long = long.merge(demographics, on="person_id", how="left")
    return long.sort_values(["person_id", "event_time"]).reset_index(drop=True)


def impressions_with_labels(
    impressions: pd.DataFrame, labels: pd.DataFrame, label_cols: Iterable[str] = INSPECT_LABELS
) -> pd.DataFrame:
    """02-script: impressions text + task labels for the text-only model."""
    cols = [c for c in label_cols if c in labels.columns]
    return impressions.merge(labels[["impression_id"] + cols], on="impression_id", how="inner")


def concept_vocab(long_ehr: pd.DataFrame, table: str, max_size: int = 10000) -> Dict[int, int]:
    """Frequency-ranked concept -> index vocab (0 = PAD/UNK) per OMOP table."""
    sub = long_ehr[long_ehr["table"] == table]
    counts = sub["concept_id"].value_counts().head(max_size - 1)
    return {int(c): i + 1 for i, c in enumerate(counts.index)}


OMOP_CONCEPT_COLS = (
    "procedure_concept_name",
    "measurement_concept_name",
    "drug_concept_name",
)


def load_inspect_structured(
    csv_path: str,
    *,
    label_cols: Iterable[str] = INSPECT_LABELS,
    split_col: str = "split",
    seed: int = 0,
    val_frac: float = 0.15,
    test_frac: float = 0.15,
) -> Dict[str, Dict[str, "np.ndarray"]]:
    """INSPECT final_structured_dataset -> train_omop split dicts.

    Reference semantics (INSPECT/BEHRT.py FinalStructuredDataset, :23-60):
    fillna('missing'), pd.factorize each of the three concept-name columns
    into integer ids over the WHOLE file (so vocab is shared across splits),
    labels coerced to {0,1} ints. Splits come from a `split` column when
    present; otherwise a seeded patient-agnostic row split (the reference
    uses MultilabelStratifiedShuffleSplit — same intent, simpler mechanism).

    Returns {"train"/"val"/"test": {proc, meas, drug, y, sens?}} plus a
    "_vocab_sizes" entry (tuple of 3 factorized vocab sizes).
    """
    import numpy as np

    df = pd.read_csv(csv_path, compression="infer", low_memory=False)
    df = df.fillna("missing")
    labels = [c for c in label_cols if c in df.columns]
    if not labels:
        raise ValueError(f"{csv_path} has none of the INSPECT label columns {tuple(label_cols)}")
    for c in labels:
        df[c] = pd.to_numeric(df[c], errors="coerce").fillna(0).astype(int)

    ids, vocab_sizes = {}, []
    for col in OMOP_CONCEPT_COLS:
        if col not in df.columns:
            raise ValueError(f"{csv_path} missing concept column {col!r}")
        codes, uniques = pd.factorize(df[col].astype(str))
        ids[col] = codes.astype("int64")
        vocab_sizes.append(max(len(uniques), 1))

    n = len(df)
    if split_col in df.columns:
        assign = df[split_col].astype(str).str.lower().to_numpy()
        assign = np.where(np.isin(assign, ("train", "val", "valid", "test")), assign, "train")
        assign = np.where(assign == "valid", "val", assign)
    else:
        rng = np.random.default_rng(seed)
        order = rng.permutation(n)
        n_test = int(round(n * test_frac))
        n_val = int(round(n * val_frac))
        assign = np.full(n, "train", dtype=object)
        assign[order[:n_test]] = "test"
        assign[order[n_test : n_test + n_val]] = "val"

    y = df[labels].to_numpy(dtype="float32")
    sens = df["sens"].to_numpy() if "sens" in df.columns else None
    out: Dict[str, Dict[str, "np.ndarray"]] = {}
    for split in ("train", "val", "test"):
        sel = assign == split
        if not sel.any():
            continue
        d = {
            "proc": ids[OMOP_CONCEPT_COLS[0]][sel],
            "meas": ids[OMOP_CONCEPT_COLS[1]][sel],
            "drug": ids[OMOP_CONCEPT_COLS[2]][sel],
            "y": y[sel],
        }
        if sens is not None:
            d["sens"] = sens[sel]
        out[split] = d
    out["_vocab_sizes"] = tuple(vocab_sizes)  # type: ignore[assignment]
    out["_tasks"] = tuple(labels)  # type: ignore[assignment]
    return out


def assign_age_bucket(age) -> str:
    """INSPECT fairness buckets (INSPECT/BioClinicalBERT.py:120-125)."""
    try:
        a = int(age)
    except (TypeError, ValueError):
        return "unknown"
    if 18 <= a <= 29:
        return "18-29"
    if 30 <= a <= 49:
        return "30-49"
    if 50 <= a <= 69:
        return "50-69"
    if 70 <= a <= 89:
        return "70-89"
    return "90+"


def load_impressions_dataset(
    csv_path: str,
    *,
    label_cols: Iterable[str] = INSPECT_LABELS,
    max_len: int = 512,
    stride: int = 64,
    max_chunks: int = 8,
    tokenizer_name: str = "emilyalsentzer/Bio_ClinicalBERT",
    vocab_path: Optional[str] = None,
    seed: int = 42,
    test_frac: float = 0.15,
    val_frac: float = 0.05,
    current_year: int = 2130,
):
    """Radiology-impressions CSV -> per-patient note Batches for the INSPECT
    text-only multitask model.

    Reference semantics (INSPECT/BioClinicalBERT.py main:171-223): fillna('')
    on text, dropna on the label columns, drop empty-text rows, group notes
    per patient, chunk each patient's notes into 512-token windows, aggregate
    chunk embeddings per patient (aggregation happens inside the note
    encoder here), labels from the per-patient deduplicated row, age buckets
    from year_of_birth for the fairness report, and a stratified split that
    retries until every split carries both classes of every task
    (stratified_split:127-136 — the reference loops iterative_train_test_split;
    here reseeded permutations, capped at 200 tries).

    Returns {"train"/"val"/"test": Batch (sens = age-bucket group ids),
    "_tasks": tuple of the label columns found}.
    """
    import numpy as np

    from multimodalrouting_tpu_torch.data.batches import Batch
    from multimodalrouting_tpu_torch.data.tokenization import (
        ChunkingConfig,
        load_tokenizer,
        tokenize_stay_notes,
    )

    df = pd.read_csv(csv_path, compression="infer", low_memory=False)
    text_col = next(
        (c for c in ("impression_text", "impressions", "text") if c in df.columns), None
    )
    if text_col is None:
        raise ValueError(f"{csv_path} has no impression text column")
    id_col = next(
        (c for c in ("person_id", "patient_id", "impression_id") if c in df.columns),
        None,
    )
    if id_col is None:
        raise ValueError(f"{csv_path} has no patient id column")
    labels = [c for c in label_cols if c in df.columns]
    if not labels:
        raise ValueError(f"{csv_path} has none of the label columns {tuple(label_cols)}")

    df[text_col] = df[text_col].fillna("")
    df = df.dropna(subset=labels)
    df = df[df[text_col].astype(str).str.strip() != ""]

    # per-patient text groups + deduplicated label/demographic rows
    groups = df.groupby(id_col)[text_col].apply(lambda s: " ".join(map(str, s)))
    df_u = df.drop_duplicates(id_col).set_index(id_col).loc[groups.index]
    y = (
        df_u[labels].apply(pd.to_numeric, errors="coerce").fillna(0).astype(int)
        .to_numpy()
        .astype(np.float32)
    )
    if "year_of_birth" in df_u.columns:
        buckets = (current_year - pd.to_numeric(df_u["year_of_birth"], errors="coerce")).map(
            assign_age_bucket
        )
        sens = pd.factorize(buckets)[0].astype(np.int32)
    else:
        sens = np.zeros(len(df_u), np.int32)

    ccfg = ChunkingConfig(max_len=max_len, stride=stride, max_chunks=max_chunks)
    tok = load_tokenizer(tokenizer_name, vocab_path=vocab_path)
    ids_list, attn_list, mask_list = [], [], []
    for pid in groups.index:
        i, a, m = tokenize_stay_notes(groups.loc[pid], tok, ccfg)
        ids_list.append(i)
        attn_list.append(a)
        mask_list.append(m)
    note_ids = np.stack(ids_list).astype(np.int32)
    note_attn = np.stack(attn_list).astype(np.int32)
    chunk_mask = np.stack(mask_list).astype(np.float32)

    # stratified-intent split with the all-classes-present retry
    n = len(groups)
    n_test = max(int(round(n * test_frac)), 1)
    n_val = max(int(round(n * val_frac)), 1)

    def _assign(rng):
        order = rng.permutation(n)
        a = np.full(n, "train", dtype=object)
        a[order[:n_test]] = "test"
        a[order[n_test : n_test + n_val]] = "val"
        return a

    assign = None
    for trial in range(200):
        cand = _assign(np.random.default_rng(seed + trial))
        ok = all(
            {0.0, 1.0} <= set(np.unique(y[cand == s][:, k]))
            for s in ("train", "val", "test")
            for k in range(y.shape[1])
        )
        assign = cand
        if ok:
            break

    def _batch(sel: np.ndarray) -> Batch:
        m = int(sel.sum())
        return Batch(
            x_struct=np.zeros((m, 1, 1), np.float32),
            m_struct=np.ones((m, 1), np.float32),
            note_ids=note_ids[sel],
            note_attn=note_attn[sel],
            chunk_mask=chunk_mask[sel],
            image=np.zeros((m, 1, 1, 3), np.float32),
            has_l=np.zeros(m, np.float32),
            has_n=(chunk_mask[sel].sum(-1) > 0).astype(np.float32),
            has_i=np.zeros(m, np.float32),
            y=y[sel],
            sens=sens[sel],
        )

    out = {s: _batch(assign == s) for s in ("train", "val", "test")}
    out["_tasks"] = tuple(labels)
    return out
