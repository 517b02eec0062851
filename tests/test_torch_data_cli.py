"""The data layer wired through the port's CLI on the CPU (tiny widths):

- the JAX integration chain (tests/test_integration_chain.py, its
  ``TINY_SETS``) on the port: raw csv.gz -> ``cli etl varmap | cohort |
  export`` -> JPEGs at the exported paths -> ``cli train`` on the real
  export -> ``cli eval --drop-table`` -> ``cli predict --split test``, whose
  rows carry their ``stay_id``, one per test stay, and equal the port's
  ``Predictor`` on the port's ``load_split`` of that split;
- ``cli train`` with ``data.stream=true``: the epoch's stream holds exactly
  the dense train split's stays, and the steps read its first batches;
- ``cli unimodal --modality note --impressions-csv --vocab`` (the native
  WordPiece) and ``--modality omop --inspect-csv``, and
  ``train_unimodal(tasks=)`` reporting the CSV's tasks as the JAX driver
  does.
"""
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from multimodalrouting_tpu.data.batches import Batch as JBatch
from multimodalrouting_tpu.train import unimodal as jtrain
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch.data import images as timages
from multimodalrouting_tpu_torch.data import loader as tloader
from multimodalrouting_tpu_torch.data import streaming as tstreaming
from multimodalrouting_tpu_torch.serve import Predictor
from multimodalrouting_tpu_torch.train import unimodal as ttrain
from tests.helpers import tiny_batch, tiny_config
from tests.test_etl import raw_dir  # noqa: F401 (the shared raw-dump fixture)
from tests.test_integration_chain import TINY_SETS
from tests.test_torch_cli import run
from tests.test_torch_data_etl import inspect_structured_csv
from tests.test_torch_data_loaders import vocab_file  # noqa: F401 (a fixture)
from tests.test_unimodal_legacy_inspect import _impressions_csv
from tests.torch_parity import (  # noqa: F401 (fixtures)
    one_torch_thread,
    port_etl_export,
    port_native_build_dir,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "port_native_build_dir")


@pytest.fixture(scope="module")
def export(raw_dir, tmp_path_factory):  # noqa: F811
    return port_etl_export(raw_dir, tmp_path_factory.mktemp("chain"))


def _train_argv(export, out, *extra):
    export_dir, image_root = export
    argv = ["train", "--family", "capsule", "--task", "mort", "--out", str(out), "--device", "cpu",
            "--set", "data.synthetic=false", "--set", f"data.data_root={export_dir}",
            "--set", f"data.image_root={image_root}", "--set", "train.ckpt_every=0"]
    for s in TINY_SETS:
        argv += ["--set", s]
    return argv + list(extra)


def test_raw_csv_to_train_eval_predict_on_the_port(export, tmp_path):
    export_dir, image_root = export
    out = tmp_path / "run"
    rc, text = run(tcli.main, _train_argv(export, out))
    assert rc == 0 and (out / "final" / "weights.pt").exists()
    assert np.isfinite(json.loads((out / "history.json").read_text())[0]["train_loss"])

    rc, text = run(tcli.main, ["eval", "--ckpt", str(out), "--drop-table", "--out", str(out / "eval"),
                               "--device", "cpu"])
    rows = [line.split()[0] for line in text.splitlines() if line.split()[:1] and line.split()[0] in
            ("full", "dropL", "dropN", "dropI", "rand1")]
    assert rc == 0 and rows == ["full", "dropL", "dropN", "dropI", "rand1"]

    preds_path = out / "preds.jsonl"
    rc, text = run(tcli.main, ["predict", "--ckpt", str(out), "--split", "test", "--out", str(preds_path),
                               "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(line) for line in preds_path.read_text().splitlines()]
    with open(os.path.join(export_dir, "splits.json")) as f:
        test_ids = [int(s) for s in json.load(f)["test"]]
    assert [r["stay_id"] for r in rows] == test_ids and len(rows) > 0
    # the port's Predictor on the port's load_split of that split, eval images
    pred = Predictor(str(out / "final"), device="cpu")
    e = pred.cfg.encoder
    arrays = tloader.load_split(export_dir, "test", image_size=e.image_size, image_dtype=np.uint8,
                                image_loader=timages.make_image_loader("test", resize=e.image_resize,
                                                                       crop=e.image_size, root=image_root,
                                                                       pixels="uint8"))
    assert arrays.batch.has_i.sum() > 0
    ref = pred.predict(arrays.batch)
    for i, row in enumerate(rows):
        assert row["stay_id"] == int(arrays.stay_ids[i])
        assert row["probs"] == pytest.approx(float(np.round(ref["probs"][i], 6)), abs=0)
        assert row["pred"] == int(ref["pred"][i])
    shutil.rmtree(out / "final")  # ~0.2 GB of train state: keep the suite's disk small


def test_cli_train_streams_the_train_split(export, tmp_path, monkeypatch):
    """data.stream=true: the epoch's stream (its full batches and the
    remainder it drops) holds exactly the dense train split's stays, each
    once, and the steps take its first batches; val stays dense."""
    export_dir, _ = export
    calls, pulled = [], []
    real = tstreaming.iter_split_batches

    def recording(*args, **kw):
        calls.append((args, kw))
        for batch, sids in real(*args, **kw):
            pulled.extend(int(s) for s in sids)
            yield batch, sids

    monkeypatch.setattr(tstreaming, "iter_split_batches", recording)
    rc, text = run(tcli.main, _train_argv(export, tmp_path / "run", "--set", "data.stream=true",
                                          "--set", "data.stream_shuffle_buffer=3", "--set", "train.sampler_mode=none"))
    summary = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and summary["epochs_ran"] == 1
    with open(os.path.join(export_dir, "splits.json")) as f:
        train_ids = sorted(int(s) for s in json.load(f)["train"])
    (args, kw), = calls  # one epoch's stream; the same stream again, to its end
    assert kw["drop_remainder"] and kw["shuffle_buffer"] == 3
    stream = [int(s) for _, sids in real(*args, **{**kw, "drop_remainder": False, "stats": None}) for s in sids]
    assert sorted(stream) == train_ids and len(set(stream)) == len(stream)
    bs = 2  # TINY_SETS' train.batch_size
    assert pulled == stream[:len(pulled)] and len(pulled) == (len(train_ids) // bs) * bs > 0
    hist = json.loads((tmp_path / "run" / "history.json").read_text())
    assert np.isfinite(hist[0]["train_loss"])
    shutil.rmtree(tmp_path / "run" / "final")


def test_cli_unimodal_note_reads_impressions_with_the_native_wordpiece(vocab_file, tmp_path):  # noqa: F811
    csv = _impressions_csv(tmp_path, n=24)
    rc, text = run(tcli.main, ["unimodal", "--modality", "note", "--impressions-csv", str(csv), "--vocab", vocab_file,
                               "--stride", "4", "--epochs", "2", "--out", str(tmp_path / "run"), "--device", "cpu",
                               *(a for kv in ("encoder.d=32", "model.d=32", "encoder.bert_hidden=32",
                                              "encoder.bert_layers=1", "encoder.bert_heads=4",
                                              "encoder.bert_intermediate=64", "encoder.bert_max_position=64",
                                              "encoder.bert_vocab_size=256", "encoder.notes_max_chunks=2",
                                              "encoder.text_max_len=16", "train.batch_size=8")
                                 for a in ("--set", kv))])
    lines = text.strip().splitlines()
    res = json.loads(lines[-1])
    assert rc == 0 and any(line.startswith("[tokenizer] native WordPiece") for line in lines)
    assert res["modality"] == "note" and res["tasks"] == ["pe_positive_nlp", "1_month_mortality"]
    fair = json.loads((tmp_path / "run" / "fairness.json").read_text())
    assert sorted(fair) == sorted(res["tasks"]) and all(np.isfinite(v) for v in res["auroc"].values())


def test_cli_unimodal_omop_reads_an_inspect_csv(tmp_path):
    csv = inspect_structured_csv(tmp_path / "final_structured_dataset.csv", n=96, split=True)
    rc, text = run(tcli.main, ["unimodal", "--modality", "omop", "--inspect-csv", csv, "--epochs", "2",
                               "--out", str(tmp_path / "run"), "--device", "cpu", "--set", "model.d=16",
                               "--set", "train.batch_size=16"])
    res = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and res["modality"] == "omop" and res["tasks"] == ["pe", "mort1m", "read1m", "ph12m"]
    metrics = json.loads((tmp_path / "run" / "unimodal_metrics.json").read_text())
    assert metrics["tasks"] == res["tasks"] and len(metrics["history"]) >= 1


def test_train_unimodal_reports_the_given_tasks_as_jax():
    """``tasks=`` names the tasks (the impressions CSV's label columns)
    whatever y's shape would infer, in the JAX driver's order."""
    tasks = ("pe_positive_nlp", "1_month_mortality")
    cfg = tiny_config(**{"train.epochs": 1, "train.batch_size": 4})
    splits = []
    for i, n in enumerate((8, 4, 4)):
        b = tiny_batch(n, seed=i, task="multitask")
        splits.append(b._replace(y=np.asarray(b.y)[:, :2], sens=np.arange(n) % 2))
    ref = jtrain.train_unimodal(cfg, *splits, modality="behrt", task="multitask", tasks=tasks, log_fn=lambda s: None)
    from multimodalrouting_tpu_torch import configs as tc
    from tests.helpers import TINY

    tcfg = tc.apply_overrides(tc.Config(), {**TINY, "train.epochs": 1, "train.batch_size": 4})
    got = ttrain.train_unimodal(tcfg, *[_torch_batch(b) for b in splits], modality="behrt", task="multitask",
                                tasks=tasks, log_fn=lambda s: None, device="cpu")
    assert list(got.metrics) == list(ref.metrics) == list(tasks) and sorted(got.fairness) == sorted(ref.fairness)
    default = ttrain.train_unimodal(tcfg, *[_torch_batch(b) for b in splits], modality="behrt", task="multitask",
                                    log_fn=lambda s: None, device="cpu")
    assert list(default.metrics) == list(jtrain._tasks_for(np.asarray(splits[0].y), "multitask"))


def _torch_batch(b: JBatch):
    from multimodalrouting_tpu_torch.data.batches import Batch

    return Batch(*(None if v is None else np.asarray(v) for v in b))


def test_real_cohort_predict_needs_a_known_split(export, tmp_path):
    from multimodalrouting_tpu_torch import configs as tc

    cfg = tc.apply_overrides(tc.Config(), {"data.synthetic": False, "data.data_root": export[0]})
    with pytest.raises(SystemExit, match="train\\|val\\|test"):
        tcli._load_split(cfg, "mort", "holdout")


def test_streaming_rows_are_the_dense_rows(export):
    """``cli._load_data`` under data.stream: the train split is a
    ``StreamingSplit`` whose unshuffled batches are load_split's rows."""
    from multimodalrouting_tpu_torch import configs as tc

    cfg = tc.apply_overrides(tc.Config(), {"data.synthetic": False, "data.data_root": export[0],
                                           "data.image_root": export[1], "data.stream": True,
                                           "data.stream_shuffle_buffer": 0, "encoder.image_size": 32,
                                           "encoder.image_resize": 40})
    train, val, test = tcli._load_data(cfg, "mort")
    assert isinstance(train, tstreaming.StreamingSplit) and not hasattr(val, "epoch_iter")
    dense = tcli._load_split(cfg, "mort", "train")[0]
    got = train.example_batch(train.batch_size)
    np.testing.assert_array_equal(np.asarray(got.x_struct), dense.x_struct)
    np.testing.assert_array_equal(np.asarray(got.note_ids), dense.note_ids)
    assert train.batch_size == dense.batch_size and pd.Series(np.asarray(got.has_i)).equals(
        pd.Series(np.asarray(dense.has_i)))
