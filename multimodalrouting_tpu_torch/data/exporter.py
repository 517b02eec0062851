"""Model-input exporter: cohort NPZ + master -> parquet model inputs.

Counterpart of ``multimodalrouting_tpu/data/exporter.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Parity target: reference MIMIC-IV/cohort/export_model_inputs.py:23-162 —
structured_24h.parquet (long format, one row per (stay, bin)),
images_24h.parquet, notes_24h.parquet (pretokenized), labels.parquet
(mortality + phenotype columns), splits.json.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import pandas as pd

from multimodalrouting_tpu_torch.data.tokenization import (
    ChunkingConfig,
    load_tokenizer,
    tokenize_stay_notes,
)


def export_model_inputs(
    cohort_dir: str,
    out_dir: str,
    *,
    chunking: Optional[ChunkingConfig] = None,
    tokenizer_name: str = "emilyalsentzer/Bio_ClinicalBERT",
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    master = pd.read_csv(os.path.join(cohort_dir, "cohort_master.csv.gz"))
    with open(os.path.join(cohort_dir, "normalization.json")) as f:
        norm = json.load(f)
    variables = norm["variables"]

    # --- structured long format ---
    rows = []
    npz_dir = os.path.join(cohort_dir, "stays")
    for stay_id in master["stay_id"].astype(int):
        z = np.load(os.path.join(npz_dir, f"{stay_id}.npz"))
        x = z["x"]  # [T, V]
        for b in range(x.shape[0]):
            rows.append({"stay_id": stay_id, "bin": b, **dict(zip(variables, x[b].tolist()))})
    pd.DataFrame(rows).to_parquet(os.path.join(out_dir, "structured_48h.parquet"), index=False)

    # --- images ---
    img_cols = [c for c in ("dicom_id", "study_id", "studydatetime") if c in master.columns]
    images = master[["stay_id"] + img_cols].copy()
    images["has_image"] = (
        master["dicom_id"].notna().astype(int) if "dicom_id" in master.columns else 0
    )
    # Propagate an image file path so the runtime loader can decode pixels
    # (reference export_model_inputs.py:67-87 writes an image_path column,
    # preferring paired_image_path_selected over the 48h/in-stay fallbacks).
    path_col = next(
        (
            c
            for c in (
                "paired_image_path_selected",
                "paired_image_path_48h",
                "paired_image_path_instay",
                "cxr_path",
                "image_path",
            )
            if c in master.columns
        ),
        None,
    )
    if path_col is not None:
        images["cxr_path"] = master[path_col]
    elif {"subject_id", "study_id", "dicom_id"} <= set(master.columns):
        # MIMIC-CXR-JPG canonical layout: p{subj[:2]}/p{subj}/s{study}/{dicom}.jpg
        def _jpg_path(r):
            if pd.isna(r["dicom_id"]):
                return None
            subj = str(int(r["subject_id"]))
            return os.path.join(
                f"p{subj[:2]}", f"p{subj}", f"s{int(r['study_id'])}", f"{r['dicom_id']}.jpg"
            )

        images["cxr_path"] = master.apply(_jpg_path, axis=1)
    images.to_parquet(os.path.join(out_dir, "images_48h.parquet"), index=False)

    # --- notes (pretokenized) ---
    chunking = chunking or ChunkingConfig()
    tokenizer = load_tokenizer(tokenizer_name)
    note_rows = []
    texts = master["note_text"] if "note_text" in master.columns else pd.Series("", index=master.index)
    for stay_id, text in zip(master["stay_id"].astype(int), texts.fillna("")):
        ids, attn, cmask = tokenize_stay_notes(str(text), tokenizer, chunking)
        note_rows.append(
            {
                "stay_id": stay_id,
                "input_ids": ids.ravel().tolist(),
                "attention_mask": attn.ravel().tolist(),
                "chunk_mask": cmask.tolist(),
                "n_chunks": int(cmask.sum()),
                "shape_s": ids.shape[0],
                "shape_l": ids.shape[1],
            }
        )
    pd.DataFrame(note_rows).to_parquet(os.path.join(out_dir, "notes_48h.parquet"), index=False)

    # --- labels ---
    label_cols = ["mortality"] + [c for c in master.columns if c.startswith("CCS_")]
    if "COPD_bronchiectasis" in master.columns:
        label_cols.append("COPD_bronchiectasis")
    if "readmit_30d" in master.columns:
        label_cols.append("readmit_30d")
    master[["stay_id"] + label_cols].to_parquet(
        os.path.join(out_dir, "labels.parquet"), index=False
    )

    # --- splits ---
    splits = {
        s: master.loc[master["split"] == s, "stay_id"].astype(int).tolist()
        for s in ("train", "val", "test")
    }
    with open(os.path.join(out_dir, "splits.json"), "w") as f:
        json.dump(splits, f)
