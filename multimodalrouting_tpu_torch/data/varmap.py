"""Varmap builder: map MIMIC-IV d_items / d_labitems to the 17 canonical
physiological variables.

Counterpart of ``multimodalrouting_tpu/data/varmap.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

Parity target: reference MIMIC-IV/cohort/build_varmap_17.py:68-125 —
regex-matching labels/abbreviations, <=8 itemids per variable with
MetaVision-first priority (itemid < 220000 first), target units for the
convertible variables. Emits the varmap CSV consumed by data/cohort.py.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import pandas as pd

#: (variable, source, patterns, to_unit)
VAR_CFG: List[Tuple[str, str, Sequence[str], Optional[str]]] = [
    ("HeartRate", "chartevents", [r"\bheart\s*rate\b", r"\bhr\b"], None),
    ("SysBP", "chartevents", [r"(?:systolic).*(?:bp|blood\s*pressure)", r"\bsys\b"], None),
    ("DiasBP", "chartevents", [r"(?:diastolic).*(?:bp|blood\s*pressure)", r"\bdia\b"], None),
    ("MeanBP", "chartevents", [r"(?:mean).*(?:bp|blood\s*pressure)", r"\bmap\b"], None),
    ("RespRate", "chartevents", [r"\bresp(?:iratory)?\s*rate\b", r"\brr\b"], None),
    ("Temperature", "chartevents", [r"\btemp(?:erature)?\b", r"\bcore temp\b"], "c"),
    ("SpO2", "chartevents", [r"\bspo2\b", r"oxygen\s*saturation", r"\bo2\s*sat"], None),
    ("Sodium", "labevents", [r"\bsodium\b", r"\bna\b"], None),
    ("Potassium", "labevents", [r"\bpotassium\b", r"\bk\b"], None),
    ("Chloride", "labevents", [r"\bchloride\b", r"\bcl\b"], None),
    ("Bicarbonate", "labevents", [r"\bbicarbonate\b", r"\btco2\b", r"\b(?:hco3|co2)\b"], None),
    ("BUN", "labevents", [r"\bbun\b", r"\burea\b"], None),
    ("Creatinine", "labevents", [r"\bcreatinine\b"], None),
    ("Glucose", "labevents", [r"\bglucose\b"], None),
    ("Hematocrit", "labevents", [r"\bhemat(?:ocrit)?\b", r"\bhct\b"], None),
    ("WBC", "labevents", [r"\bwbc\b", r"white\s*blood\s*cells?"], None),
    ("Platelets", "labevents", [r"\bplate(?:let)?s?\b", r"\bplt\b"], None),
]

CANONICAL_17 = [v for v, *_ in VAR_CFG]


def _match(frame: pd.DataFrame, patterns: Sequence[str], cols: Sequence[str]) -> pd.Series:
    pat = re.compile("|".join(patterns), re.IGNORECASE)
    mask = pd.Series(False, index=frame.index)
    for c in cols:
        if c in frame.columns:
            mask = mask | frame[c].astype(str).str.contains(pat, na=False)
    return mask


def _metavision_first(df: pd.DataFrame) -> pd.DataFrame:
    out = df.copy()
    out["_hint"] = (out["itemid"] < 220000).astype(int)
    return out.sort_values(["_hint", "itemid"]).drop(columns=["_hint"])


def build_varmap(
    d_items: pd.DataFrame,
    d_labitems: pd.DataFrame,
    *,
    max_per_var: int = 8,
    fluids: Sequence[str] = ("blood", "serum", "plasma"),
) -> pd.DataFrame:
    rows = []
    for var, src, patterns, to_unit in VAR_CFG:
        if src == "chartevents":
            pool = d_items
            if "linksto" in pool.columns:
                pool = pool[pool["linksto"] == "chartevents"]
            hits = pool[_match(pool, patterns, ("label", "abbreviation"))].copy()
            hits = _metavision_first(hits.drop_duplicates("itemid")).head(max_per_var)
        else:
            pool = d_labitems
            hits = pool[_match(pool, patterns, ("label",))].copy()
            if "fluid" in hits.columns:
                hits = hits[hits["fluid"].isin(fluids)]
            hits = (
                hits.sort_values(["label", "itemid"]).drop_duplicates("itemid").head(max_per_var)
            )
        if hits.empty:
            continue
        units = hits["unitname"] if "unitname" in hits.columns else pd.Series("", index=hits.index)
        for pri, (itemid, unit) in enumerate(
            zip(hits["itemid"].astype(int), units.fillna("").astype(str)), start=1
        ):
            rows.append(
                {
                    "variable": var,
                    "source": src,
                    "itemid": int(itemid),
                    "priority": pri,
                    "unit": unit,
                    "to_unit": (to_unit or "").lower(),
                }
            )
    return pd.DataFrame(rows, columns=["variable", "source", "itemid", "priority", "unit", "to_unit"])
