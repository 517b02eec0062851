"""The port's offline ETL (``multimodalrouting_tpu_torch/data/``: varmap,
cohort with the native and the pandas binner, exporter, medfuse,
legacy_cohort, inspect_etl, and ``cli etl``) against the JAX package's on
the same fixtures, bit for bit: every NPZ array, CSV, parquet and JSON file
each writes (``tests/torch_parity.assert_same_files``).

The fixtures are the JAX tests' own: the raw MIMIC-style dump of
``tests/test_etl.py`` (``raw_dir``), the MedFuse tree of
``tests/test_medfuse_chain.py`` and the INSPECT frames of
``tests/test_unimodal_legacy_inspect.py``. The port builds its C++ binner
into a temporary directory (``port_native_build_dir``); the JAX package
builds its own."""
import json
import os

import numpy as np
import pandas as pd
import pytest

from multimodalrouting_tpu import cli as jcli
from multimodalrouting_tpu.data import cohort as jcohort
from multimodalrouting_tpu.data import exporter as jexporter
from multimodalrouting_tpu.data import inspect_etl as jinspect
from multimodalrouting_tpu.data import legacy_cohort as jlegacy
from multimodalrouting_tpu.data import medfuse as jmedfuse
from multimodalrouting_tpu.data import native_binner as jnative_binner
from multimodalrouting_tpu.data import varmap as jvarmap
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch.data import cohort as tcohort
from multimodalrouting_tpu_torch.data import exporter as texporter
from multimodalrouting_tpu_torch.data import inspect_etl as tinspect
from multimodalrouting_tpu_torch.data import legacy_cohort as tlegacy
from multimodalrouting_tpu_torch.data import medfuse as tmedfuse
from multimodalrouting_tpu_torch.data import native_binner as tnative_binner
from multimodalrouting_tpu_torch.data import native_build
from multimodalrouting_tpu_torch.data import varmap as tvarmap
from multimodalrouting_tpu_torch.data.tokenization import ChunkingConfig
from tests.test_etl import raw_dir  # noqa: F401 (the shared raw-dump fixture)
from tests.test_medfuse_chain import CHANNELS, _cxr_fixture, _make_tree
from tests.test_native_binner import _random_fixture
from tests.test_torch_cli import run
from tests.torch_parity import assert_same_files, port_native_build_dir  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("port_native_build_dir")


def _cohort_cfg(mod, raw, out, vm):
    return mod.CohortConfig(data_dir=str(raw), out_dir=str(out), varmap_path=str(vm),
                            cxr_meta_path=str(raw / "cxr_metadata.csv.gz"), notes_path=str(raw / "notes.csv.gz"))


def test_build_varmap_matches_jax(raw_dir):  # noqa: F811
    d_items, d_lab = pd.read_csv(raw_dir / "d_items.csv.gz"), pd.read_csv(raw_dir / "d_labitems.csv.gz")
    pd.testing.assert_frame_equal(tvarmap.build_varmap(d_items, d_lab), jvarmap.build_varmap(d_items, d_lab),
                                  check_exact=True)
    assert tvarmap.CANONICAL_17 == jvarmap.CANONICAL_17 and tvarmap.VAR_CFG == jvarmap.VAR_CFG


@pytest.mark.parametrize("binner", ["native", "pandas"])
def test_build_cohort_matches_jax(binner, raw_dir, tmp_path, monkeypatch):  # noqa: F811
    """Every NPZ array, cohort_master.csv.gz and normalization.json, with
    the C++ binner (each package its own build) and with the pandas path."""
    vm = tmp_path / "varmap.csv"
    jvarmap.build_varmap(pd.read_csv(raw_dir / "d_items.csv.gz"),
                         pd.read_csv(raw_dir / "d_labitems.csv.gz")).to_csv(vm, index=False)
    if binner == "pandas":
        monkeypatch.setattr(jnative_binner, "load_native_binner", lambda: None)
        monkeypatch.setattr(tnative_binner, "load_native_binner", lambda: None)
    calls = []
    real = tnative_binner.bin_events_native
    monkeypatch.setattr(tnative_binner, "bin_events_native", lambda *a, **k: calls.append(1) or real(*a, **k))
    master_t = tcohort.build_cohort(_cohort_cfg(tcohort, raw_dir, tmp_path / "t", vm))
    master_j = jcohort.build_cohort(_cohort_cfg(jcohort, raw_dir, tmp_path / "j", vm))
    pd.testing.assert_frame_equal(master_t, master_j, check_exact=True)
    names = assert_same_files(tmp_path / "t", tmp_path / "j")
    assert "cohort_master.csv.gz" in names and "normalization.json" in names
    assert sum(n.endswith(".npz") for n in names) == len(master_j) > 0
    assert calls  # the cohort went through the binner's entry point
    if binner == "native":  # each package's library, each built into its own directory
        assert tnative_binner._LIB is not None and jnative_binner._LIB is not None
        assert os.path.dirname(jnative_binner._SO) != native_build.BUILD_DIR
        assert os.path.exists(os.path.join(native_build.BUILD_DIR, "libbinner.so"))
        assert os.path.dirname(native_build.library_path("binner")) == native_build.BUILD_DIR
    else:
        assert tnative_binner.bin_events_native(*([np.zeros(1)] * 6), 1, 1, 1) is None


@pytest.mark.parametrize("fill", [True, False])
def test_native_binner_matches_jax(fill):
    """``bin_events_native`` on the JAX binner test's random events (NaN
    priorities mapped to the int64 sentinel, as ``build_stay_matrices``
    does)."""
    stays, varmap, ce, _ = _random_fixture(seed=3)
    rng = np.random.default_rng(3)
    n = len(ce)
    args = (rng.integers(0, len(stays), n), rng.integers(0, 24, n), rng.integers(0, 4, n),
            np.where(rng.random(n) < 0.1, np.iinfo(np.int64).min, rng.integers(0, 3, n)),
            ce["charttime"].values.astype("datetime64[ns]").astype(np.int64), ce["valuenum"].values)
    got = tnative_binner.bin_events_native(*args, len(stays), 24, 4, fill=fill)
    ref = jnative_binner.bin_events_native(*args, len(stays), 24, 4, fill=fill)
    assert got is not None and ref is not None
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def cohort_dir(raw_dir, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("cohort")
    vm = d / "varmap.csv"
    jvarmap.build_varmap(pd.read_csv(raw_dir / "d_items.csv.gz"),
                         pd.read_csv(raw_dir / "d_labitems.csv.gz")).to_csv(vm, index=False)
    jcohort.build_cohort(_cohort_cfg(jcohort, raw_dir, d / "cohort", vm))
    return d / "cohort"


@pytest.mark.parametrize("chunking", [(32, 4, 2), (16, 4, 3)])
def test_export_model_inputs_matches_jax(chunking, cohort_dir, tmp_path):
    """Each parquet by ``assert_frame_equal`` and splits.json."""
    max_len, stride, max_chunks = chunking
    texporter.export_model_inputs(str(cohort_dir), str(tmp_path / "t"),
                                  chunking=ChunkingConfig(max_len=max_len, stride=stride, max_chunks=max_chunks))
    jexporter.export_model_inputs(str(cohort_dir), str(tmp_path / "j"),
                                  chunking=jexporter.ChunkingConfig(max_len=max_len, stride=stride,
                                                                    max_chunks=max_chunks))
    names = assert_same_files(tmp_path / "t", tmp_path / "j")
    assert names == ["images_48h.parquet", "labels.parquet", "notes_48h.parquet", "splits.json",
                     "structured_48h.parquet"]
    notes = pd.read_parquet(tmp_path / "t" / "notes_48h.parquet")
    assert (notes["shape_s"] == max_chunks).all() and (notes["shape_l"] == max_len).all()


MEDFUSE_CASES = {
    "phenotyping-partial_ehr_cxr": ("phenotyping", "partial_ehr_cxr", True),
    "phenotyping-paired_ehr_cxr": ("phenotyping", "paired_ehr_cxr", True),
    "ihm-partial_ehr": ("in-hospital-mortality", "partial_ehr", False),
}


@pytest.mark.parametrize("case", sorted(MEDFUSE_CASES))
def test_medfuse_export_matches_jax(case, tmp_path):
    """``medfuse_export`` on the JAX chain test's tree: the summary and every
    file (structured, images, empty notes, labels, splits, the normalizer)."""
    task, pairs, cxr = MEDFUSE_CASES[case]
    root, _ = _make_tree(tmp_path, task=task, **({} if task == "phenotyping" else {"classes": ("y_true",)}))
    cfg_path = tmp_path / "channels.json"
    cfg_path.write_text(json.dumps(CHANNELS))
    kw = dict(timestep=1.0, config_path=str(cfg_path), data_pairs=pairs, data_ratio=0.5, seed=3)
    if cxr:
        kw["cxr_data_dir"], kw["icu_stays_csv"] = _cxr_fixture(tmp_path, stay_ids=(101, 201))
    got = tmedfuse.medfuse_export(root, task, str(tmp_path / "t"), **kw)
    ref = jmedfuse.medfuse_export(root, task, str(tmp_path / "j"), **kw)
    assert {**got, "out": "OUT"} == {**ref, "out": "OUT"}
    names = assert_same_files(tmp_path / "t", tmp_path / "j")
    assert "medfuse_normalizer.json" in names and len(pd.read_parquet(tmp_path / "t" / "notes_48h.parquet")) == 0


def test_medfuse_discretizer_and_normalizer_match_jax(tmp_path):
    """The Discretizer under every impute strategy and the Normalizer's
    statistics, on one stay of the chain test's tree."""
    root, names = _make_tree(tmp_path)
    rows, header = jmedfuse.read_timeseries_csv(os.path.join(root, "phenotyping", "train", names["train"][0]))
    for impute in ("zero", "normal_value", "previous", "next"):
        td = tmedfuse.Discretizer(timestep=1.0, store_masks=True, impute_strategy=impute, config=CHANNELS)
        jd = jmedfuse.Discretizer(timestep=1.0, store_masks=True, impute_strategy=impute, config=CHANNELS)
        (xt, ht), (xj, hj) = td.transform(np.asarray(rows), header), jd.transform(np.asarray(rows), header)
        assert ht == hj and xt.dtype == xj.dtype
        np.testing.assert_array_equal(xt, xj, err_msg=impute)
    tn, jn = (m.Normalizer(fields=m.continuous_fields(hj)) for m in (tmedfuse, jmedfuse))
    for n in (tn, jn):
        n.feed(xj)
        n.feed(xj[::2] * 1.5)
        n.finalize()
    np.testing.assert_array_equal(tn.transform(xj), jn.transform(xj))


def test_load_legacy_cohort_matches_jax(raw_dir):  # noqa: F811
    for window in (24, 48):
        got = tlegacy.load_legacy_cohort(str(raw_dir), window_hours=window, bin_hours=2)
        ref = jlegacy.load_legacy_cohort(str(raw_dir), window_hours=window, bin_hours=2)
        for g, r in zip(got, ref):
            pd.testing.assert_frame_equal(g, r, check_exact=True)


def _inspect_frames():
    """The INSPECT frames of the JAX test (metadata / mapping / labels /
    splits / impressions and an OMOP condition table)."""
    metadata = pd.DataFrame({"impression_id": [1, 2, 3], "patient_id": [7, 8, 9],
                             "study_time": pd.to_datetime(["2130-05-01", "2130-06-01", "2130-07-01"])})
    mapping = pd.DataFrame({"patient_id": [7, 8, 9], "person_id": [70, 80, 90]})
    labels = pd.DataFrame({"impression_id": [1, 2, 3], "pe_positive_nlp": [1, 0, 1],
                           "1_month_mortality": [0, 1, 0]})
    splits = pd.DataFrame({"impression_id": [1, 3], "split": ["test", "val"]})
    imps = pd.DataFrame({"impression_id": [1, 2, 3], "impressions": ["PE seen", "clear", "small PE"]})
    events = pd.DataFrame({"person_id": [70, 70, 80, 90], "condition_concept_id": [101, 102, 103, 104],
                           "condition_start_DATETIME": pd.to_datetime(["2130-04-01", "2130-05-15", "2130-05-20",
                                                                       "2130-06-30"])})
    return metadata, mapping, labels, splits, imps, events


def test_inspect_merge_long_ehr_and_vocab_match_jax():
    metadata, mapping, labels, splits, imps, events = _inspect_frames()
    cohorts = [m.merge_cohort(metadata, mapping, labels, splits, imps) for m in (tinspect, jinspect)]
    pd.testing.assert_frame_equal(*cohorts, check_exact=True)
    demo = pd.DataFrame({"person_id": [70, 80, 90], "gender_concept_id": [1, 2, 1]})
    longs = [m.build_long_ehr({"condition_occurrence": events}, cohorts[1], demographics=demo)
             for m in (tinspect, jinspect)]
    pd.testing.assert_frame_equal(*longs, check_exact=True)
    assert tinspect.concept_vocab(longs[0], "condition_occurrence") == jinspect.concept_vocab(
        longs[1], "condition_occurrence")
    pd.testing.assert_frame_equal(tinspect.impressions_with_labels(imps, labels),
                                  jinspect.impressions_with_labels(imps, labels), check_exact=True)
    assert tinspect.OMOP_TABLES == jinspect.OMOP_TABLES and tinspect.INSPECT_LABELS == jinspect.INSPECT_LABELS


def inspect_structured_csv(path, n: int = 40, split: bool = False):
    """An INSPECT final_structured_dataset CSV (INSPECT/BEHRT.py's schema)."""
    rng = np.random.default_rng(n)
    df = pd.DataFrame({
        "procedure_concept_name": [None if i % 9 == 0 else f"p{i % 5}" for i in range(n)],
        "measurement_concept_name": [f"m{i % 3}" for i in range(n)],
        "drug_concept_name": [f"d{i % 4}" for i in range(n)],
        "pe_positive_nlp": [i % 2 for i in range(n)],
        "1_month_mortality": rng.integers(0, 2, n),
        "1_month_readmission": [("1" if i % 3 == 0 else None) for i in range(n)],
        "12_month_PH": rng.integers(0, 2, n),
        "sens": rng.choice(["m", "f"], n),
    })
    if split:
        df["split"] = rng.choice(["train", "valid", "test", "other"], n)
    df.to_csv(path, index=False, compression="infer")
    return str(path)


@pytest.mark.parametrize("split", [False, True])
def test_load_inspect_structured_matches_jax(split, tmp_path):
    csv = inspect_structured_csv(tmp_path / "final_structured_dataset.csv.gz", split=split)
    got, ref = tinspect.load_inspect_structured(csv, seed=7), jinspect.load_inspect_structured(csv, seed=7)
    assert sorted(got) == sorted(ref) and got["_vocab_sizes"] == ref["_vocab_sizes"]
    assert got["_tasks"] == ref["_tasks"]
    for s in ("train", "val", "test"):
        assert sorted(got[s]) == sorted(ref[s])
        for k in ref[s]:
            assert got[s][k].dtype == ref[s][k].dtype
            np.testing.assert_array_equal(got[s][k], ref[s][k])


# --- cli etl: the port's subcommands write what the JAX CLI's write ----------


def _etl_argv(sub, raw, tmp, out):
    if sub == "varmap":
        return ["varmap", "--data-dir", str(raw), "--out", out + "/varmap.csv"]
    if sub == "legacy":
        return ["legacy", "--data-dir", str(raw), "--out", out]
    if sub == "medfuse":
        root, _ = _make_tree(tmp)
        cfg_path = tmp / "channels.json"
        cfg_path.write_text(json.dumps(CHANNELS))
        cxr_dir, stays_csv = _cxr_fixture(tmp, stay_ids=(101, 201))
        return ["medfuse", "--ehr-data-dir", root, "--task", "phenotyping", "--out", out, "--channels-config",
                str(cfg_path), "--cxr-data-dir", cxr_dir, "--icu-stays", stays_csv, "--data-ratio", "0.5"]
    if sub == "inspect":
        metadata, mapping, labels, splits, imps, events = _inspect_frames()
        d = tmp / "in"
        (d / "omop").mkdir(parents=True)
        for name, df in (("metadata", metadata), ("mapping", mapping), ("labels", labels), ("splits", splits)):
            df.to_csv(d / f"{name}.tsv", sep="\t", index=False)
        imps.to_csv(d / "impressions.csv", index=False)
        events.to_csv(d / "omop" / "condition_occurrence.csv", index=False)
        return ["inspect", *(a for n in ("metadata", "mapping", "labels", "splits")
                             for a in (f"--{n}", str(d / f"{n}.tsv"))),
                "--impressions", str(d / "impressions.csv"), "--omop-dir", str(d / "omop"), "--out", out]
    raise AssertionError(sub)


@pytest.mark.parametrize("sub", ["varmap", "medfuse", "inspect", "legacy"])
def test_cli_etl_writes_what_the_jax_cli_writes(sub, raw_dir, tmp_path):  # noqa: F811
    """The same files and the same JSON summary (its paths aside)."""
    outs = {}
    (tmp_path / "in").mkdir()
    argv = _etl_argv(sub, raw_dir, tmp_path / "in", "OUT")  # the inputs once, for both CLIs
    for tag, main in (("t", tcli.main), ("j", jcli.main)):
        out = str(tmp_path / tag)
        rc, text = run(main, ["etl", *(a.replace("OUT", out) if a.startswith("OUT") else a for a in argv)])
        assert rc == 0
        outs[tag] = json.loads(text.strip().splitlines()[-1].replace(out, "OUT"))
    assert outs["t"] == outs["j"]
    assert_same_files(tmp_path / "t", tmp_path / "j")


def test_cli_etl_chain_writes_what_the_jax_cli_writes(raw_dir, tmp_path):  # noqa: F811
    """varmap -> cohort -> export through each CLI: the varmap, every cohort
    file and every export file."""
    for tag, main in (("t", tcli.main), ("j", jcli.main)):
        d = tmp_path / tag
        for argv in (["varmap", "--data-dir", str(raw_dir), "--out", str(d / "varmap.csv")],
                     ["cohort", "--data-dir", str(raw_dir), "--out", str(d / "cohort"), "--varmap",
                      str(d / "varmap.csv"), "--cxr-meta", str(raw_dir / "cxr_metadata.csv.gz"),
                      "--notes", str(raw_dir / "notes.csv.gz")],
                     ["export", "--cohort", str(d / "cohort"), "--out", str(d / "export"), "--max-len", "32",
                      "--max-chunks", "2"]):
            rc, _ = run(main, ["etl", *argv])
            assert rc == 0, argv
    names = assert_same_files(tmp_path / "t", tmp_path / "j")
    assert "export/notes_48h.parquet" in names and "cohort/cohort_master.csv.gz" in names
