"""The port's CLI (``multimodalrouting_tpu_torch/cli.py``) on the CPU at tiny
widths: its parser against the JAX package's, train then eval with the drop
table, a resume that reproduces a run without a break, a warm start, eval
against the JAX CLI's on the same weights, and predict against
``Predictor``."""
import argparse
import contextlib
import csv
import glob
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import cli as jcli
from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.audit import droptable as jdroptable
from multimodalrouting_tpu.ckpt import save_checkpoint as jsave_checkpoint
from multimodalrouting_tpu.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.audit import droptable as tdroptable
from multimodalrouting_tpu_torch.bridge import train_state_from_jax
from multimodalrouting_tpu_torch.ckpt import save_checkpoint
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.serve import Predictor
from multimodalrouting_tpu_torch.train.state import serving_state_dict, train_state_dict
from tests.torch_parity import jitter, to_numpy

# tests/test_cli_and_baselines.py's tiny widths, with BatchNorm in the ResNet
# so that the train state carries buffers
TINY_SETS = {
    "encoder.d": 32, "encoder.structured_seq_len": 12, "encoder.structured_n_feats": 16,
    "encoder.structured_layers": 1, "encoder.structured_heads": 4, "encoder.bert_hidden": 32,
    "encoder.bert_layers": 1, "encoder.bert_heads": 4, "encoder.bert_intermediate": 64,
    "encoder.bert_vocab_size": 1024, "encoder.bert_max_position": 64, "encoder.notes_max_chunks": 2,
    "encoder.text_max_len": 16, "encoder.image_size": 32, "encoder.vision_backbone": "resnet18",
    "encoder.vision_norm": "batch", "model.d": 32, "model.mult_layers": 1, "model.mult_self_layers": 1,
    "model.mult_heads": 4, "model.pc_dim": 8, "model.mc_caps_dim": 16, "model.dtype": "float32",
    "train.batch_size": 8, "train.min_epochs": 0, "train.early_stop_patience": 2,
    "train.encoder_warmup_epochs": 0, "data.synthetic_n": 20,
}
SUMMARY_KEYS = {"family", "stage", "best_val_auroc", "temperature", "epochs_ran", "ckpt_dir"}
PARITY_ATOL = 2e-4  # metrics and drop-table rows against the JAX CLI
TABLE_ATOL = 2e-5  # heatmap CSV / NPY values


def _sets(**extra):
    out = []
    for k, v in {**TINY_SETS, **extra}.items():
        out += ["--set", f"{k}={v}"]
    return out


def run(main, argv):
    """`main(argv)` in-process -> (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def train(out, *extra):
    rc, text = run(tcli.main, ["train", "--family", "capsule", "--task", "mort", "--routes", "10", "--device",
                               "cpu", "--out", out, *extra, *_sets()])
    assert rc == 0
    return json.loads(text.strip().splitlines()[-1])


def load_state(path):
    return torch.load(os.path.join(path, "train_state.pt"), map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """One CLI run of two epochs without a break: (out dir, summary)."""
    out = str(tmp_path_factory.mktemp("cli") / "two")
    return out, train(out, "--epochs", "2")


# --- (a) the parser ---------------------------------------------------------


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, caught as its main() parses."""

    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as caught:
        jcli.main([])
    monkeypatch.undo()
    return caught.value.args[0]


def _describe(parser, path=()):
    """{(subcommand path, option strings or dest): (dest, default, choices,
    required, type, nargs, const, action, metavar)}; help text left out."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_describe(sub, path + (name,)))
            out[path + ("<subcommands>",)] = (action.dest, action.required, sorted(action.choices))
        elif not isinstance(action, argparse._HelpAction):
            key = path + (tuple(action.option_strings) or action.dest,)
            out[key] = (action.dest, action.default, action.choices, action.required,
                        getattr(action.type, "__name__", action.type), action.nargs, action.const,
                        type(action).__name__, action.metavar)
    return out


@pytest.mark.parametrize("cmd", ["train", "unimodal", "eval", "etl", "predict", "interpret"])
def test_parser_matches_the_jax_cli(cmd, monkeypatch):
    ref = {k: v for k, v in _describe(_jax_parser(monkeypatch)).items() if k[0] == cmd}
    got = {k: v for k, v in _describe(tcli.build_parser()).items() if k[0] == cmd}
    device = got.pop((cmd, ("--device",)), None)
    assert got == ref
    if cmd in ("train", "unimodal", "eval", "predict", "interpret"):
        assert device == ("device", "cuda", ["cuda", "cpu"], False, None, None, None, "_StoreAction", None)
    else:
        assert device is None
    tops = {k: v for k, v in _describe(tcli.build_parser()).items() if len(k) == 1}
    assert tops == {k: v for k, v in _describe(_jax_parser(monkeypatch)).items() if len(k) == 1}


# --- (b) train, then eval with the drop table -------------------------------


def test_train_then_eval_with_drop_table(two_epochs):
    out, summary = two_epochs
    assert set(summary) == SUMMARY_KEYS
    assert summary["epochs_ran"] == 2 and summary["ckpt_dir"] == out and summary["stage"] == ""
    with open(os.path.join(out, "history.json")) as f:
        history = json.load(f)
    assert [row["epoch"] for row in history] == [0, 1]
    assert os.path.exists(os.path.join(out, "final", "train_state.pt"))
    assert os.path.exists(os.path.join(out, "val_reliability.csv"))
    with open(os.path.join(out, "final", "meta.json")) as f:
        assert json.load(f)["step"] == 2 * (20 // 8)
    rc, text = run(tcli.main, ["eval", "--ckpt", out, "--drop-table", "--device", "cpu"])
    assert rc == 0
    assert "auroc" in text and "dropN" in text
    assert os.path.exists(os.path.join(out, "test_route_audit.json"))
    assert os.path.exists(os.path.join(out, "test_reliability.csv"))


# --- (c) resume and warm start ----------------------------------------------


def test_resume_reproduces_the_run_without_a_break(two_epochs, tmp_path):
    """Exact: the resumed run continues the sampler, the dropout generator
    and the LR schedule from the checkpoint, on the same CPU kernels."""
    ref = load_state(os.path.join(two_epochs[0], "final"))
    out = str(tmp_path / "broken")
    assert train(out, "--epochs", "1")["epochs_ran"] == 1
    assert load_state(os.path.join(out, "last"))["step"] == 20 // 8
    summary = train(out, "--epochs", "2", "--resume", out)
    assert summary["epochs_ran"] == 1
    got = load_state(os.path.join(out, "final"))
    assert (got["step"], got["count"]) == (ref["step"], ref["count"]) == (4, 4)
    for part in ("model", "mu", "nu", "ema"):
        assert sorted(got[part]) == sorted(ref[part])
        for key, value in ref[part].items():
            assert torch.equal(got[part][key], value), f"{part}.{key}"


def test_init_from_takes_raw_parameters_and_fresh_moments(two_epochs, tmp_path):
    src = load_state(os.path.join(two_epochs[0], "final"))
    out = str(tmp_path / "warm")
    train(out, "--epochs", "0", "--init-from", two_epochs[0])
    got = load_state(os.path.join(out, "final"))
    assert (got["step"], got["count"], got["loop"]) == (0, 0, {})
    for key, value in src["model"].items():
        assert torch.equal(got["model"][key], value), key
    for key, value in src["ema"].items():
        assert torch.equal(got["ema"][key], value), key
    assert all(not v.any() for part in ("mu", "nu") for v in got[part].values())


def test_resume_from_a_serving_checkpoint_raises(two_epochs, tmp_path):
    old = tmp_path / "old"
    for name in ("last", "final"):
        (old / name).mkdir(parents=True)
        for f in ("config.json", "meta.json", "weights.pt"):
            os.link(os.path.join(two_epochs[0], name, f), old / name / f)
    for flag in ("--resume", "--init-from"):
        with pytest.raises(FileNotFoundError, match="train_state.pt"):
            train(str(tmp_path / "out"), "--epochs", "1", flag, str(old))


PHENO_ATTEN_MULT = os.path.join(os.path.dirname(__file__), "..", "configs", "pheno_atten_mult.yaml")


@pytest.mark.parametrize("argv, item", [
    (["train", "--mesh", "data=2"], "item 12"),
    (["train", "--set", "train.ckpt_backend=orbax_async"], "item 13"),
    (["eval", "--ckpt", "ORBAX"], "item 13"),
    (["predict", "--ckpt", "ORBAX"], "item 13"),
])
def test_unported_options_raise_naming_their_roadmap_item(argv, item, tmp_path):
    if argv[0] == "train":
        argv = [*argv, "--device", "cpu", "--out", str(tmp_path), *_sets()]
    if "ORBAX" in argv:  # a JAX orbax checkpoint: reading it needs orbax, which imports JAX
        os.makedirs(tmp_path / "final.orbax")
        argv = [str(tmp_path) if a == "ORBAX" else a for a in argv] + ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
        tcli.main(argv)


@pytest.mark.parametrize("argv", [
    ["--set", "model.bi_fusion_mode=mult"],
    ["--config", PHENO_ATTEN_MULT],
    ["--stage", "step1", "--set", "model.bi_fusion_mode=mult"],
    ["--set", "encoder.text_embedding_cache=true"],
])
def test_formerly_unported_options_now_run(argv, tmp_path):
    """The per-route MulT family (ROADMAP.md §1 item 6) and the frozen-BERT
    text cache (item 3) train for an epoch."""
    rc, text = run(tcli.main, ["train", *argv, "--epochs", "1", "--device", "cpu", "--out", str(tmp_path),
                               *_sets(**{"train.ckpt_every": 0})])
    summary = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and summary["epochs_ran"] == 1 and np.isfinite(summary["best_val_auroc"])
    assert ("[text-cache]" in text) == ("encoder.text_embedding_cache=true" in argv)
    shutil.rmtree(tmp_path / "final")  # ~0.2 GB of train state: keep the suite's disk small


@pytest.fixture(scope="module")
def exported(two_epochs, tmp_path_factory):
    """`cli predict --export-artifact` of the two-epoch run's checkpoint."""
    art = str(tmp_path_factory.mktemp("cli") / "art")
    rc, text = run(tcli.main, ["predict", "--ckpt", two_epochs[0], "--export-artifact", art, "--device", "cpu"])
    assert rc == 0 and json.loads(text.strip().splitlines()[-1]) == {"artifact": art, "platforms": ["cpu"]}
    return art


@pytest.fixture(scope="module")
def gated_ckpt(tmp_path_factory):
    """A seeded gated-concat checkpoint (learned gate) at the tiny widths."""
    cfg = tc.apply_overrides(tc.Config(), TINY_SETS)
    torch.manual_seed(0)
    out = str(tmp_path_factory.mktemp("cli") / "gated")
    save_checkpoint(os.path.join(out, "final"), build_model(cfg, "gated_concat", device="cpu").state_dict(), cfg)
    return out


@pytest.mark.parametrize("case", ["artifact_any_family", "artifact", "export_artifact", "interpret"])
def test_formerly_unported_predict_and_interpret_run(case, two_epochs, exported, gated_ckpt, tmp_path):
    """The serving artifact (ROADMAP.md §1 item 11) and `cli interpret` (item
    9) run: an artifact serves its own family whatever --family says, a
    checkpoint exports, the gated sweep writes its CSV."""
    out = str(tmp_path / "out")
    argv = {
        "artifact_any_family": ["predict", "--artifact", exported, "--family", "trimf", "--out", out],
        "artifact": ["predict", "--artifact", exported, "--out", out],
        "export_artifact": ["predict", "--ckpt", two_epochs[0], "--export-artifact", out],
        "interpret": ["interpret", "--ckpt", gated_ckpt, "--out-csv", out, "--n-mc", "2"],
    }[case]
    rc, text = run(tcli.main, [*argv, "--device", "cpu"])
    assert rc == 0
    if case.startswith("artifact"):
        with open(out) as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == TINY_SETS["data.synthetic_n"] and len(rows[0]["top_routes"]) == 3
    elif case == "export_artifact":
        assert sorted(os.listdir(out)) == ["meta.json", "program.pt2"]
    else:
        with open(out) as f:
            table = list(csv.reader(f))
        assert len(table) == 1 + TINY_SETS["data.synthetic_n"] and "gate__LNI" in table[0]
        assert "block means:" in text and f"wrote {len(table) - 1} rows" in text


def test_cli_export_and_serve(two_epochs, exported, tmp_path):
    """`predict --artifact` scores the split as `predict --ckpt` does (the JAX
    test's tolerance), and the flags refuse each other."""
    paths = {}
    for flag, src in (("--artifact", exported), ("--ckpt", two_epochs[0])):
        paths[flag] = str(tmp_path / f"{flag[2:]}.jsonl")
        rc, _ = run(tcli.main, ["predict", flag, src, "--out", paths[flag], "--device", "cpu"])
        assert rc == 0
    rows = {flag: [json.loads(line) for line in open(path)] for flag, path in paths.items()}
    np.testing.assert_allclose([r["probs"] for r in rows["--artifact"]], [r["probs"] for r in rows["--ckpt"]],
                               rtol=1e-5, atol=1e-6)
    assert [r["top_routes"] for r in rows["--artifact"]] == [r["top_routes"] for r in rows["--ckpt"]]
    for argv in (["predict", "--ckpt", two_epochs[0], "--artifact", exported], ["predict"],
                 ["predict", "--artifact", exported, "--export-artifact", str(tmp_path / "again")]):
        with pytest.raises(SystemExit):
            tcli.main([*argv, "--device", "cpu"])


def test_a_multi_host_environment_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 12"):
        tcli.main(["train", "--device", "cpu", "--out", str(tmp_path), *_sets()])


# --- (d) eval against the JAX CLI on the same weights -----------------------


def _numbers(path):
    if path.endswith(".npy"):
        return np.load(path).ravel()
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        flat = []

        def walk(x):
            if isinstance(x, dict):
                [walk(v) for v in x.values()]
            elif isinstance(x, list):
                [walk(v) for v in x]
            elif isinstance(x, (int, float)) and not isinstance(x, bool):
                flat.append(float(x))

        walk(data)
        return np.asarray(flat)
    with open(path) as f:
        cells = [c for row in csv.reader(f) for c in row]
    return np.asarray([float(c) for c in cells if c.replace(".", "", 1).replace("-", "", 1).isdigit()])


def _metrics_json(text):
    start = text.index("{\n")
    return json.loads(text[start: text.index("\n}", start) + 2])


def _recorded(monkeypatch, module):
    tables = []
    real = module.drop_table_eval
    monkeypatch.setattr(module, "drop_table_eval", lambda *a, **k: tables.append(real(*a, **k)) or tables[-1])
    return tables


def _random_variables(model, example, seed: int):
    """Seeded random flax variables of `model`'s structure (fan-in scaled
    kernels, BatchNorm statistics away from 0 and 1), without running its
    init op by op."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), example, train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.standard_normal(s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) == 4 else s.shape[-2])
        elif name == "var":
            x = 0.5 + rng.random(s.shape)
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _template_init(monkeypatch):
    """Give the models the JAX CLI builds an init that returns zeros of the
    right shapes and dtypes: eval uses its init as the template that
    ``restore_checkpoint`` fills, and an eager flax init takes most of a
    minute on the CPU."""
    build = jcli._build

    def build_fast(cfg, family):
        model = build(cfg, family)
        real = model.init

        def init(*args, **kwargs):
            shapes = jax.eval_shape(lambda: real(*args, **kwargs))
            return jax.tree_util.tree_map(lambda s: jax.numpy.zeros(s.shape, s.dtype), shapes)

        object.__setattr__(model, "init", init)
        return model

    monkeypatch.setattr(jcli, "_build", build_fast)


def test_eval_matches_the_jax_cli_on_the_same_weights(tmp_path, monkeypatch):
    jcfg = jc.apply_overrides(jc.Config(), TINY_SETS)
    tcfg = tc.apply_overrides(tc.Config(), TINY_SETS)
    model = jbuild_model(jcfg, "capsule")
    example = make_synthetic_cohort(8, t=12, f=16, s=2, l=16, image_size=32, vocab_size=1024, seed=0)
    variables = _random_variables(model, example, seed=3)
    state = jcreate_train_state(jcfg, model, jax.tree_util.tree_map(jax.numpy.asarray, variables))
    ema = jitter({"params": variables["params"]}, seed=4, scale=0.05)["params"]
    ema = jax.tree_util.tree_map_with_path(
        lambda path, e, p: p if any(getattr(k, "key", None) == "bbert" for k in path) else e,
        ema, to_numpy(variables["params"]))
    state = state.replace(ema_params=jax.tree_util.tree_map(jax.numpy.asarray, ema), step=7)
    temperature, thresholds = 1.7, [0.35]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsave_checkpoint(jdir, state, jcfg, name="final", thresholds=thresholds, extra={"temperature": temperature})

    tmodel = build_model(tcfg, device="cpu")
    tstate = train_state_from_jax(tcfg, tmodel, to_numpy({
        "params": state.params, "batch_stats": state.batch_stats, "ema_params": state.ema_params,
        "opt_state": state.opt_state, "step": state.step}))
    save_checkpoint(os.path.join(tdir, "final"), serving_state_dict(tstate), tcfg, temperature=temperature,
                    thresholds=thresholds, train_state=train_state_dict(tstate))

    _template_init(monkeypatch)
    jtables, ttables = _recorded(monkeypatch, jdroptable), _recorded(monkeypatch, tdroptable)
    rc, jtext = run(jcli.main, ["eval", "--ckpt", jdir, "--drop-table"])
    assert rc == 0
    rc, ttext = run(tcli.main, ["eval", "--ckpt", tdir, "--drop-table", "--device", "cpu"])
    assert rc == 0

    jm, tm = _metrics_json(jtext), _metrics_json(ttext)
    assert sorted(tm) == sorted(jm) and "eddi" in tm and tm["temperature"] == temperature
    for key in jm:
        assert tm[key] == pytest.approx(jm[key], abs=PARITY_ATOL), key
    (jt,), (tt,) = jtables, ttables
    assert list(tt) == list(jt) == ["full", "dropL", "dropN", "dropI", "rand1"]
    for cond in jt:
        assert sorted(tt[cond]) == sorted(jt[cond])
        for key, ref in jt[cond].items():
            if isinstance(ref, float):
                assert tt[cond][key] == pytest.approx(ref, abs=PARITY_ATOL, nan_ok=True), (cond, key)
    assert "dropN" in ttext and ttext.count("\n") == jtext.count("\n")

    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(jdir, "test_*")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(os.path.join(tdir, "test_*")))
    assert "test_route_audit.json" in names and "test_alpha_raw.npy" in names
    for name in names:
        if name.endswith(".png"):
            continue
        ref, got = _numbers(os.path.join(jdir, name)), _numbers(os.path.join(tdir, name))
        assert got.shape == ref.shape and ref.size > 0, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=TABLE_ATOL, err_msg=name)


# --- (e) predict ------------------------------------------------------------


def test_predict_writes_one_row_per_stay_as_predictor_scores_them(two_epochs, tmp_path):
    out = str(tmp_path / "preds.jsonl")
    rc, text = run(tcli.main, ["predict", "--ckpt", two_epochs[0], "--split", "test", "--device", "cpu",
                               "--out", out])
    assert rc == 0
    summary = json.loads(text.strip().splitlines()[-1])
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert summary["rows"] == len(rows) == TINY_SETS["data.synthetic_n"]
    pred = Predictor(os.path.join(two_epochs[0], "final"), device="cpu")
    cohort = tcli._load_data(pred.cfg, "mort")[2]
    ref = pred.predict(cohort)
    assert summary["temperature"] == pred.temperature
    for i, row in enumerate(rows):
        assert row["probs"] == pytest.approx(float(np.round(ref["probs"][i], 6)), abs=0)
        assert row["pred"] == int(ref["pred"][i])
        assert row["top_routes"] == [pred.routes[j] for j in np.argsort(-ref["alpha"][i])[:3]]
