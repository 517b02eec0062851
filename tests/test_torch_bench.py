"""The port's measuring scripts (scripts/torch_bench.py, torch_bench_phases.py,
torch_trace_report.py, torch_bench_serve.py) against the JAX package's
(bench.py, scripts/bench_phases.py, scripts/trace_report.py,
scripts/bench_serve.py) on the CPU, at tiny widths:

(a) the config overrides and the env knobs' defaults, read from the JAX
    scripts' source with ``ast`` (never run), equal the port's;
(b) the workload's cohort is bit-equal to the JAX ``make_synthetic_cohort``
    and its note pack to the JAX ``note_pack_bucket``;
(c) one frozen and one fine-tuned step of the workload, from weights carried
    across by ``bridge.py``, against the JAX ``make_train_step`` at the
    workload's learning rates and pack;
(d) the JSON line: bench.py's keys, metric names and baseline keys;
(e) the phases: ``bert_fwd``'s embeddings and ``model_fwd``'s logits
    against the JAX modules;
(f) the trace summariser and its check of launches against the counters;
(g) torch_bench_serve.py on a tiny checkpoint, live and from an artifact;
(h) no new script imports JAX or the JAX package, and each exits non-zero
    without a card unless given ``--device cpu``.
"""
import ast
import contextlib
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.data.synthetic import make_synthetic_cohort as jmake_synthetic_cohort
from multimodalrouting_tpu.models.clinbert import BioClinBERTEncoder as JBioClinBERTEncoder
from multimodalrouting_tpu.models.clinbert import note_pack_capacity
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train.loop import note_pack_bucket as jnote_pack_bucket
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu.train.steps import make_train_step as jmake_train_step
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.artifact import export_serving_artifact
from multimodalrouting_tpu_torch.bridge import load_jax_variables, train_state_from_jax
from multimodalrouting_tpu_torch.ckpt import save_checkpoint
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.serve import Predictor
from tests.helpers import TINY
from tests.torch_parity import (
    ATOL,
    O0,
    RTOL,
    RTOL_STEPS,
    TRAIN_SMALL,
    assert_close,
    assert_same_batch,
    assert_same_weights,
    compiled,
    jitter,
    one_torch_thread,  # noqa: F401 (a fixture)
    seeded_like,
    to_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_bench as tb  # noqa: E402
import torch_bench_phases as tbp  # noqa: E402
import torch_bench_serve as tbs  # noqa: E402
import torch_trace_report as ttr  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")
PORT_SCRIPTS = ("torch_bench.py", "torch_bench_phases.py", "torch_trace_report.py", "torch_bench_serve.py")
ENVS = ({}, {"BENCH_FINETUNE": "1", "BENCH_LN": "bf16", "BENCH_GELU": "erf", "BENCH_BATCH": "4"})
TINY_KNOBS = {"batch": 4, "chunks": 5}  # TRAIN_SMALL's batch and chunk count


def source_tree(path: str) -> ast.Module:
    with open(os.path.join(ROOT, path)) as f:
        return ast.parse(f.read())


def overrides_node(path: str) -> ast.Dict:
    """The dict literal `apply_overrides(Config(), {...})` is given in `path`."""
    nodes = [n.args[1] for n in ast.walk(source_tree(path)) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "apply_overrides" and isinstance(n.args[1], ast.Dict)]
    assert len(nodes) == 1, path
    return nodes[0]


def jax_overrides(path: str, env: dict, **names) -> dict:
    """That dict literal evaluated with `env` as os.environ and `names` bound
    (the script's locals it reads), without running the script."""
    scope = {"os": types.SimpleNamespace(environ=env), **names}
    return eval(compile(ast.Expression(overrides_node(path)), path, "eval"), scope)  # noqa: S307


def env_defaults(path: str) -> dict:
    """{BENCH_* variable: its default} of every os.environ.get in `path`."""
    out = {}
    for n in ast.walk(source_tree(path)):
        if (isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "get"
                and isinstance(n.args[0], ast.Constant) and str(n.args[0].value).startswith("BENCH_")):
            out[n.args[0].value] = n.args[1].value
    return out


# --- (a) the overrides and the knobs ------------------------------------------


@pytest.mark.parametrize("env", ENVS, ids=["defaults", "set"])
def test_bench_overrides_equal_bench_py(env):
    k = tb.knobs(env)
    ref = jax_overrides("bench.py", env, batch_size=k.batch, finetune=env.get("BENCH_FINETUNE", "0") == "1")
    assert tb.bench_overrides(k.batch, k.finetune, env) == ref
    assert ref["encoder.bert_ln"] == env.get("BENCH_LN", "fp32") and ref["encoder.finetune_text"] == k.finetune


@pytest.mark.parametrize("path", ["scripts/bench_phases.py", "scripts/trace_report.py"])
@pytest.mark.parametrize("env", ENVS, ids=["defaults", "set"])
def test_phase_overrides_equal_the_jax_scripts(path, env):
    k = tb.knobs(env)
    ref = jax_overrides(path, env, batch_size=k.batch, cfg_overrides=None)
    assert tb.phase_overrides(k.batch, env) == ref
    assert "encoder.bert_ln" not in ref and "encoder.bert_gelu" not in ref


@pytest.mark.parametrize("path, steps, warmup", [("bench.py", 20, 3), ("scripts/bench_phases.py", 10, 2)])
def test_knob_defaults_equal_the_jax_scripts(path, steps, warmup):
    defaults = env_defaults(path)
    k = tb.knobs({}, steps=steps, warmup=warmup)
    fields = {"BENCH_BATCH": k.batch, "BENCH_CHUNKS": k.chunks, "BENCH_STEPS": k.steps, "BENCH_WARMUP": k.warmup,
              "BENCH_FINETUNE": int(k.finetune)}
    for var, default in defaults.items():
        if var in fields:
            assert int(default) == fields[var], var
    assert {"BENCH_BATCH", "BENCH_CHUNKS", "BENCH_STEPS", "BENCH_WARMUP", "BENCH_FINETUNE"} <= set(defaults)


# --- (b) the workload's inputs --------------------------------------------------


def configs(overrides: dict, extra=None):
    over = {**overrides, **(extra or {})}
    return jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)


@pytest.mark.parametrize("extra, knobs", [(TRAIN_SMALL, TINY_KNOBS), (None, {})], ids=["tiny", "flagship"])
def test_workload_cohort_and_pack_equal_jax(extra, knobs):
    k = tb.Knobs(**knobs)
    jcfg, tcfg = configs(tb.bench_overrides(k.batch, False, {}), extra)
    e = jcfg.encoder
    ref = jmake_synthetic_cohort(k.batch, t=e.structured_seq_len, f=e.structured_n_feats, s=k.chunks,
                                 l=e.text_max_len, image_size=e.image_size, vocab_size=e.bert_vocab_size,
                                 seed=0, task="mort")
    got = tb.make_cohort(tcfg, k)
    assert_same_batch(got, ref)
    from multimodalrouting_tpu_torch.train.loop import note_pack_bucket

    cap = note_pack_bucket(tcfg, got)
    assert cap == jnote_pack_bucket(jcfg, ref) and 0 < cap < got.chunk_mask.size


# --- (c) one step of each leg against the JAX train step ------------------------


def jax_variables(model, batch, seed: int):
    """The model's init, jittered as tests/test_torch_train.py's trajectories
    start (``jitter``: every leaf moved, BatchNorm statistics nonzero)."""
    return jitter(compiled(lambda b: model.init(jax.random.PRNGKey(0), b, train=False), batch), seed=seed)


@pytest.mark.parametrize("finetune", [False, True], ids=["frozen", "finetuned"])
def test_one_step_of_each_leg_matches_jax(finetune):
    k = tb.Knobs(finetune=finetune, **TINY_KNOBS)
    over = tb.bench_overrides(k.batch, finetune, {})
    jcfg = jc.apply_overrides(jc.Config(), {**jax_overrides("bench.py", {}, batch_size=k.batch, finetune=finetune),
                                            **TRAIN_SMALL})
    w = tb.build_workload(over, k, "cpu", TRAIN_SMALL)
    jcohort = jmake_synthetic_cohort(k.batch, t=16, f=16, s=k.chunks, l=256, image_size=32, vocab_size=2048,
                                     seed=0, task="mort")
    cap = jnote_pack_bucket(jcfg, jcohort)
    assert cap == w.cap > 0
    jb = jax.tree_util.tree_map(jnp.asarray, jcohort)
    jmodel = jbuild_model(jcfg, "capsule")
    state = compiled(lambda v: jcreate_train_state(jcfg, jmodel, v), jax_variables(jmodel, jb, seed=3))
    init = to_numpy({"params": state.params, "batch_stats": state.batch_stats, "ema_params": state.ema_params,
                     "opt_state": state.opt_state, "step": state.step})
    step = jmake_train_step(jcfg, jmodel, "capsule")
    lr = jnp.asarray(jcfg.train.lr)  # bench.py: lr_head = lr_enc = train.lr
    args = (state, jb, jax.random.PRNGKey(1), lr, lr)
    jstate, jmetrics = step.lower(*args, note_pack=cap).compile(compiler_options=O0)(*args)

    w.state = train_state_from_jax(w.cfg, w.model, init)
    metrics = w.step_once()
    assert metrics.grad_finite
    np.testing.assert_allclose(float(metrics.loss), float(jmetrics.loss), rtol=RTOL_STEPS)
    assert_same_weights(w.model, w.state, jstate)
    trains_bert = any(n.startswith("encoders.bbert.bert.") for n in w.state.names)
    assert trains_bert == finetune


# --- (d) the JSON line ----------------------------------------------------------


def bench_py_strings():
    """bench.py's metric name, its fine-tuned suffix, the result's keys and
    the baseline keys (frozen, fine-tuned)."""
    tree = source_tree("bench.py")
    name = suffix = keys = base = None
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "name":
            name = n.value.value
        elif isinstance(n, ast.AugAssign) and getattr(n.target, "id", None) == "name":
            suffix = n.value.value
        elif isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "result":
            keys = [kn.value for kn in n.value.keys]
        elif isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "key":
            base = {False: n.value.orelse.value, True: n.value.body.value}
    return name, suffix, keys, base


def test_json_line_has_bench_py_keys_and_names():
    name, suffix, keys, base = bench_py_strings()
    assert (tb.METRIC, tb.FINETUNE_SUFFIX, tb.BASELINE_KEYS) == (name, suffix, base)
    with open(os.path.join(ROOT, "bench_baseline.json")) as f:
        baseline = json.load(f)
    frozen, tuned = tb.result_line(2.0, False), tb.result_line(2.0, True)
    assert list(frozen) == list(tuned) == keys
    assert frozen["metric"] == name and tuned["metric"] == name + suffix
    assert frozen["vs_baseline"] == round(2.0 / baseline[base[False]], 3)
    assert base[True] not in baseline and tuned["vs_baseline"] is None


def test_bench_script_runs_on_the_cpu(monkeypatch):
    for var, value in {"BENCH_STEPS": "1", "BENCH_WARMUP": "1", "BENCH_BATCH": "2", "BENCH_CHUNKS": "2"}.items():
        monkeypatch.setenv(var, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tb.main(["--device", "cpu", "--small"]) == 0
    lines = out.getvalue().splitlines()
    line = json.loads(lines[-1])
    assert line["metric"] == tb.METRIC and line["value"] > 0 and line["unit"] == "stays/sec/chip"
    assert any("tf32" in x for x in lines) and any("note pack" in x for x in lines)


# --- (e) the phases ---------------------------------------------------------------


def test_phases_match_the_jax_modules():
    k = tb.Knobs(**TINY_KNOBS)
    over = tb.phase_overrides(k.batch, {})
    jcfg, tcfg = configs(over, TRAIN_SMALL)
    w = tb.build_workload(over, k, "cpu", TRAIN_SMALL)
    mods = tbp.phase_modules(w.cfg, torch.device("cpu"))
    calls = tbp.phase_calls(w, mods)
    jcohort = jmake_synthetic_cohort(k.batch, t=16, f=16, s=k.chunks, l=256, image_size=32, vocab_size=2048,
                                     seed=0, task="mort")
    jb = jax.tree_util.tree_map(jnp.asarray, jcohort)
    cap = jnote_pack_bucket(jcfg, jcohort)
    assert cap == w.cap > 0
    e = jcfg.encoder
    jbert = JBioClinBERTEncoder(
        d=e.d, vocab_size=e.bert_vocab_size, hidden=e.bert_hidden, layers=e.bert_layers, heads=e.bert_heads,
        intermediate=e.bert_intermediate, max_position=e.bert_max_position, note_agg=e.note_agg,
        chunk_agg=e.note_chunk_agg, dtype=jnp.float32, finetune_text=e.finetune_text,
    )
    bvars = seeded_like(jax.eval_shape(lambda nd: jbert.init(jax.random.PRNGKey(0), nd), jb.notes_dict()), 7)
    jmodel = jbuild_model(jcfg, "capsule")
    mvars = jax_variables(jmodel, jb, seed=8)

    def refs(bv, mv, b):
        with note_pack_capacity(cap):
            return jbert.apply(bv, b.notes_dict()), jmodel.apply(mv, b, train=False).logits

    (h, _, pooled), logits = compiled(refs, bvars, mvars, jb)
    load_jax_variables(mods["bert"], bvars)
    load_jax_variables(w.model, mvars)
    got_h, _, got_pooled = calls["bert_fwd"]()
    assert_close(got_h, h, RTOL, ATOL)
    assert_close(got_pooled, pooled, RTOL, ATOL)
    assert_close(calls["model_fwd"](), logits, RTOL, ATOL)


def test_phase_table_on_the_cpu():
    k = tb.Knobs(batch=2, chunks=2)
    w = tb.build_workload(tb.phase_overrides(k.batch, {}), k, "cpu", tb.SMALL)
    res = tbp.run_phases(w, steps=1, warmup=0, device=torch.device("cpu"))
    for name in ("bert_fwd_ms", "behrt_fwd_ms", "cxr_fwd_ms", "model_fwd_ms", "train_step_ms"):
        assert res[name] > 0, name
    parts = res["model_fwd_ms"] - res["bert_fwd_ms"] - res["behrt_fwd_ms"] - res["cxr_fwd_ms"]
    assert abs(res["fusion_routing_fwd_ms_derived"] - parts) <= 0.02  # each row rounded to 0.01
    assert res["config"]["gelu_ln"]["model_fwd, train_step"] == "poly/bf16"


# --- (f) the trace summariser ----------------------------------------------------

NAMED = {
    "attn::attention_fwd_wgmma_kernel<64, 0>": "attention (K1, K2, K4)",
    "attn::bwd_dkdv_wgmma_kernel<64, 64, 0>": "attention (K1, K2, K4)",
    "void (anonymous namespace)::capsule_routing_kernel<float, 32, 64>(Params)": "capsule routing (K3)",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "convolution",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": "gemm",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>": "normalization",
    "void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(float, float)": "normalization",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps>>": "reduction",
    "Memcpy DtoD (Device -> Device)": "copies",
    "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, float>>": "elementwise",
    "void at::native::max_pool_forward_nhwc<float>": "uncategorized",
}


def test_summary_counts_every_kernel_before_the_cut():
    events = [(name, 0.5 + i, 1) for i, name in enumerate(NAMED)] * 3
    rows, by_cat, total = ttr.summarize(events, top=4)
    assert len(rows) == 4 and [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)
    assert total == pytest.approx(sum(ms for _, ms, _ in events))
    assert sum(by_cat.values()) == pytest.approx(total)
    assert {r["op"]: r["category"] for r in ttr.summarize(events, top=99)[0]} == NAMED
    assert all(r["calls"] == 3 for r in rows)


def test_summary_of_a_cpu_trace():
    window = ttr.trace_window(lambda: torch.ones(64, 64) @ torch.ones(64, 64) + 1, 3, torch.device("cpu"))
    rows, by_cat, total = ttr.summarize(window["events"], top=2)
    assert len(window["events"]) > 2 and len(rows) == 2
    assert total == pytest.approx(sum(ms for _, ms, _ in window["events"]))
    assert sum(by_cat.values()) == pytest.approx(total)
    report = ttr.report("step", window, 3, torch.device("cpu"), top=2)
    assert report["events"] == "cpu ops, self time" and "idle_share" not in report


class FakeProfile:
    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("traces, ok", [
    ([2, 3], True),  # a trace that lost a launch is taken again
    ([2, 2, 2], False),  # ... at most TRACE_TRIES times
    ([0], False),  # no device kernel at all
])
def test_trace_is_held_to_the_counters(monkeypatch, traces, ok):
    """On the card: K1's launches in the trace against the counters."""
    counters = {"K1": 0, "K3": 0, "K4_fwd": 0}
    seen = iter(traces)

    def run():
        counters["K1"] += 3
        counters["K3"] += 1

    def events(prof):
        n = next(seen)
        return [("attn::attention_fwd_wgmma_kernel<64, 0>", 0.3, 1)] * n + \
            [("capsule_routing_kernel<float, 32, 64>", 0.01, 1)] * bool(n)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(ttr, "forward_launches", lambda: dict(counters))
    monkeypatch.setattr(ttr, "kernel_events", events)
    device = types.SimpleNamespace(type="cuda")
    if ok:
        window = ttr.trace_window(run, 1, device)
        assert window["traced"] == window["counted"] == {"attention_fwd_wgmma_kernel": 3, "capsule_routing_kernel": 1}
    else:
        with pytest.raises(RuntimeError):
            ttr.trace_window(run, 1, device)


def test_trace_report_runs_on_the_cpu(monkeypatch):
    for var, value in {"TRACE_STEPS": "1", "BENCH_BATCH": "2", "BENCH_CHUNKS": "2"}.items():
        monkeypatch.setenv(var, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ttr.main(["cxr", "--device", "cpu", "--small"]) == 0
    text = out.getvalue()
    report = json.loads(text[text.index("{"):])
    assert report["mode"] == "cxr" and report["total_ms"] > 0 and report["top_ops"]


# --- (g) torch_bench_serve.py -----------------------------------------------------


def bench_serve_keys():
    """The keys of bench_serve.py's JSON line."""
    tree = source_tree("scripts/bench_serve.py")
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "dumps"]
    return [k.value for k in dumps[0].args[0].keys]


@pytest.fixture(scope="module")
def serve_dirs(tmp_path_factory):
    """A tiny synthetic-cohort checkpoint as DIR/final, and its artifact."""
    cfg = tc.apply_overrides(tc.Config(), {**TINY, "train.batch_size": 4, "encoder.image_size": 32,
                                         "encoder.text_max_len": 64})
    torch.manual_seed(0)
    root = tmp_path_factory.mktemp("bench_serve")
    save_checkpoint(str(root / "final"), build_model(cfg, device="cpu").state_dict(), cfg)
    art = str(root / "art")
    export_serving_artifact(Predictor(str(root), device="cpu"), art)
    return str(root), art


@pytest.mark.parametrize("which", ["ckpt", "artifact"])
def test_bench_serve_prints_the_jax_keys(serve_dirs, which):
    ckpt, art = serve_dirs
    argv = ["--ckpt", ckpt] if which == "ckpt" else ["--artifact", art]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tbs.main([*argv, "--device", "cpu", "--requests", "3", "--batches", "1"]) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line) == bench_serve_keys()
    assert line["serving_batch"] == 4 and line["request_p50_ms"] > 0 and line["batch_scoring_stays_per_sec"] > 0
    assert line["metric"].endswith(f"({'Predictor' if which == 'ckpt' else 'ExportedPredictor'}, full request path)")


# --- (h) the scripts import no JAX and need a card --------------------------------


def imported_modules(path: str):
    for n in ast.walk(source_tree(path)):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            yield n.module or ""


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_scripts_import_no_jax(script):
    mods = set(imported_modules(os.path.join("scripts", script)))
    assert mods and not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "multimodalrouting_tpu")}


@pytest.mark.parametrize("main, argv", [
    (tb.main, []), (tbp.main, []), (ttr.main, ["step"]), (tbs.main, ["--ckpt", "runs/none"]),
], ids=PORT_SCRIPTS)
def test_scripts_exit_without_a_card(main, argv):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code not in (0, None)
