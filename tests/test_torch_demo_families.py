"""scripts/torch_demo_families.py against the JAX package's
scripts/demo_families.py on the CPU:

- with each CLI's ``main`` replaced by a recorder that returns 0, the two
  scripts drive the same commands (the port's with ``--device`` appended)
  and write the same impressions CSV;
- --harvest over one set of run directories writes the same summary.json;
- the port's script trains the gated chain (step3 under the loss-based
  gate from step2's learned one), the 7-route capsule and the BEHRT driver
  at tiny widths, each row with rc 0 and the JAX rows' keys;
- it imports no JAX and exits non-zero without a card.
"""
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import pandas as pd
import pytest
import torch

import multimodalrouting_tpu.cli as jcli
import multimodalrouting_tpu_torch.cli as tcli
from multimodalrouting_tpu_torch.ckpt import load_config, restore_train_state
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train.state import create_train_state
from tests.test_torch_bench import imported_modules
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_demo_families as tdf  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARGS = ["--small", "--n", "32", "--epochs", "1"]
TRAIN_KEYS = {"label", "rc", "sec", "val_auroc_first", "val_auroc_best", "epochs"}
UNIMODAL_KEYS = {"label", "rc", "sec", "val_auroc_best", "epochs", "val_loss_first", "val_loss_last"}


def jax_script():
    """scripts/demo_families.py as a module (its main() is not run here)."""
    path = os.path.join(ROOT, "scripts", "demo_families.py")
    spec = importlib.util.spec_from_file_location("jax_demo_families", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(monkeypatch, argv):
    """The JAX script's main() with `argv` as its command line -> its rc."""
    monkeypatch.setattr(sys, "argv", ["demo_families.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        return jax_script().main()


def run_port(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return tdf.main([*argv, "--device", "cpu"])


def recorder(calls):
    def main(argv):
        calls.append(list(argv))
        return 0
    return main


def test_commands_and_impressions_equal_the_jax_script(monkeypatch, tmp_path):
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jcli, "main", recorder(jax_calls))
    monkeypatch.setattr(tcli, "main", recorder(port_calls))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert run_jax(monkeypatch, [*ARGS, "--out", jout]) == 0
    assert run_port([*ARGS, "--out", tout]) == 0
    assert len(jax_calls) == len(port_calls) == 18
    for j, t in zip(jax_calls, port_calls):
        assert t[-2:] == ["--device", "cpu"]
        assert [a.replace(tout, jout) for a in t[:-2]] == j
    jcsv, tcsv = (pd.read_csv(os.path.join(d, "ui", "impressions.csv.gz")) for d in (jout, tout))
    pd.testing.assert_frame_equal(tcsv, jcsv)
    assert len(tcsv) > 32 and set(tcsv["person_id"]) == set(range(32))
    with open(os.path.join(jout, "summary.json")) as f:
        jrows = json.load(f)
    with open(os.path.join(tout, "summary.json")) as f:
        trows = json.load(f)
    assert [r["label"] for r in trows] == [r["label"] for r in jrows] == list(tdf.LABEL_DIRS)
    assert all(r["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0} for r in trows)


def write_runs(root):
    """Run directories as the 18 runs leave them, some missing or empty."""
    def hist(aurocs):
        return [{"epoch": i + 1, "val_auroc": a, "train_loss": 0.7} for i, a in enumerate(aurocs)]

    files = {
        "cap7/history.json": hist([0.61234, 0.70119, 0.68]),
        "pheno10/history.json": hist([0.5]),
        "g1/history.json": [],
        "g2/history.json": [{"epoch": 1}],
        "ft/history.json": hist([0.3, 0.9, 0.85, 0.9]),
        "ub/unimodal_metrics.json": {"metrics": {"mortality": {"auroc": 0.81234}, "pe": {"auroc": None},
                                                 "ph": {"auroc": 0.7}},
                                     "history": [{"val_loss": 2.77071}, {"val_loss": 3.03844}]},
        "uo/unimodal_metrics.json": {"metrics": {"pe": {"auroc": 0.9}}, "history": []},
        "ui/unimodal_metrics.json": {"metrics": {"pe_positive_nlp": {"auroc": 1.0}},
                                     "history": [{"val_loss": 2.17}]},
    }
    for rel, obj in files.items():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)


@pytest.mark.parametrize("only", [None, "cap7-missing,capsule-mort-7,unimodal-behrt"])
def test_harvest_writes_the_jax_summary(monkeypatch, tmp_path, only):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    write_runs(jout)
    shutil.copytree(jout, tout)
    flags = ["--harvest", *(["--only", only] if only else [])]
    assert run_jax(monkeypatch, [*flags, "--out", jout]) == 0
    assert run_port([*flags, "--out", tout]) == 0
    with open(os.path.join(jout, "summary.json")) as f:
        ref = f.read()
    with open(os.path.join(tout, "summary.json")) as f:
        got = f.read()
    assert got == ref and len(json.loads(ref)) == (2 if only else 7)  # the same rows, keys in the same order


def test_a_chain_and_a_driver_train_on_the_cpu(tmp_path):
    """The gated chain includes step3 under the loss-based gate, warm-started
    from step2's learned gate (fault F6: the port refused the gate net's
    weights that the loss-based model lacks, where flax leaves them out)."""
    out = str(tmp_path / "fam")
    labels = ["capsule-mort-7", "gated-step1", "gated-step2", "gated-step3-lossbased", "unimodal-behrt"]
    assert run_port([*ARGS, "--out", out, "--only", ",".join(labels)]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        rows = {r["label"]: r for r in json.load(f)}
    assert list(rows) == labels
    for label, row in rows.items():
        assert row["rc"] == 0 and row["epochs"] == 1, row
        assert set(row) == (UNIMODAL_KEYS if label.startswith("unimodal") else TRAIN_KEYS) | {"launches"}, row
        assert 0.0 <= row["val_auroc_best"] <= 1.0

    # the warm start takes every weight of step2's that the loss-based model
    # has and leaves out the gate net; the other way round, a missing weight raises
    def fresh(d):
        cfg = load_config(os.path.join(out, d, "final"))
        return create_train_state(cfg, build_model(cfg, "gated_concat", device="cpu"), stage="step3")

    lossbased = restore_train_state(os.path.join(out, "g2"), fresh("g3lb"), name="final", params_only=True)
    saved = torch.load(os.path.join(out, "g2", "final", "train_state.pt"), weights_only=True)["model"]
    own = lossbased.model.state_dict()
    assert {k for k in saved if k not in own} and all(k.startswith("gate_net.") for k in saved if k not in own)
    assert all(torch.equal(v, saved[k].to(v.dtype)) for k, v in own.items())
    with pytest.raises(RuntimeError, match="Missing key"):
        restore_train_state(os.path.join(out, "g3lb"), fresh("g2"), name="final", params_only=True)


def test_script_imports_no_jax_and_needs_a_card():
    mods = set(imported_modules(os.path.join("scripts", "torch_demo_families.py")))
    assert mods and not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "multimodalrouting_tpu")}
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as exc:
        with contextlib.redirect_stdout(io.StringIO()):
            tdf.main(["--only", "capsule-mort-7"])
    assert exc.value.code not in (0, None)
