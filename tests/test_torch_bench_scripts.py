"""The port's copies of the JAX repo's last bench scripts
(scripts/torch_bench_text_cache.py, torch_bench_bert.py, torch_bench_int8.py)
against the JAX scripts (scripts/bench_text_cache.py, bench_bert.py,
bench_int8.py) on the CPU, at tiny widths:

(a) the text cache: the config overrides and the env knobs' defaults, read
    from the JAX script's source with ``ast`` (never run), equal the port's;
    the cohort is bit-equal to JAX's; the cache equals JAX
    ``attach_note_cache`` on the same weights in fp32; the JSON line has the
    JAX script's keys and metric, and both legs start from the same weights;
(b) bench_bert: ``bert_fwd_flops`` equals the JAX script's function, the
    encoder is built with that script's arguments, the ids are its draw, the
    env defaults are its own, and the line carries its keys;
(c) bench_int8: the dynamic dense equals the JAX script's ``quant_dense``
    (read from its source) within one int8 step on a few elements; the
    shapes, steps and printed names are the script's;
(d) none of the three imports JAX or the JAX package, and each exits
    non-zero without a card unless given ``--device cpu``.
"""
import ast
import contextlib
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.data.synthetic import make_synthetic_cohort as jmake_synthetic_cohort
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train.text_cache import attach_note_cache as jattach_note_cache
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm
from multimodalrouting_tpu_torch.ops.quant import QuantDense
from multimodalrouting_tpu_torch.train.text_cache import attach_note_cache
from tests.test_torch_bench import env_defaults, imported_modules, jax_overrides, source_tree
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    TRAIN_SMALL,
    assert_close,
    assert_same_batch,
    one_torch_thread,
    seeded_variables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_bench as tb  # noqa: E402
import torch_bench_bert as tbb  # noqa: E402
import torch_bench_int8 as tbi  # noqa: E402
import torch_bench_text_cache as ttc  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")
PORT_SCRIPTS = ("torch_bench_text_cache.py", "torch_bench_bert.py", "torch_bench_int8.py")
# fp32 at tiny widths, notes short of every attention kernel's gate in both packages
CACHE_SMALL = {**TRAIN_SMALL, "encoder.text_max_len": 16, "encoder.bert_max_position": 64,
               "encoder.vision_norm": "group"}
CACHE_KNOBS = tb.Knobs(batch=4, chunks=3, steps=1, warmup=1)


def jax_function(path: str, name: str, scope: dict):
    """The function `name` defined anywhere in `path` (nested ones too),
    compiled without its decorators in `scope`."""
    node = next(n for n in ast.walk(source_tree(path)) if isinstance(n, ast.FunctionDef) and n.name == name)
    node.decorator_list = []
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), scope)  # noqa: S102
    return scope[name]


def dumped_keys(path: str) -> dict:
    """The dict literal that `path` passes to json.dumps, as {key: its value
    where that is a constant, else None}."""
    node = next(n for n in ast.walk(source_tree(path)) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    d = node.args[0]
    return {k.value: (v.value if isinstance(v, ast.Constant) else None) for k, v in zip(d.keys, d.values)}


# --- (a) the text cache --------------------------------------------------------


@pytest.mark.parametrize("batch", [16, 4])
def test_text_cache_overrides_equal_the_jax_script(batch):
    ref = jax_overrides("scripts/bench_text_cache.py", {}, batch_size=batch)
    assert ttc.overrides(batch) == ref
    assert "encoder.bert_ln" not in ref and "encoder.bert_gelu" not in ref and "encoder.finetune_text" not in ref


def test_text_cache_knob_defaults_equal_the_jax_script():
    k = tb.knobs({})
    assert env_defaults("scripts/bench_text_cache.py") == {
        "BENCH_BATCH": str(k.batch), "BENCH_CHUNKS": str(k.chunks), "BENCH_STEPS": str(k.steps),
        "BENCH_WARMUP": str(k.warmup)}


def cache_case():
    """(JAX cfg, JAX cohort, JAX variables as numpy, the port workload with them)."""
    over = {**ttc.overrides(CACHE_KNOBS.batch), **CACHE_SMALL}
    jcfg = jc.apply_overrides(jc.Config(), over)
    e = jcfg.encoder
    jcohort = jmake_synthetic_cohort(CACHE_KNOBS.batch, t=e.structured_seq_len, f=e.structured_n_feats,
                                     s=CACHE_KNOBS.chunks, l=e.text_max_len, image_size=e.image_size,
                                     vocab_size=e.bert_vocab_size, seed=0, task="mort")
    variables = seeded_variables(jbuild_model(jcfg, "capsule"), jax.tree_util.tree_map(jnp.asarray, jcohort), 11)
    w = tb.build_workload(ttc.overrides(CACHE_KNOBS.batch), CACHE_KNOBS, "cpu", CACHE_SMALL)
    load_jax_variables(w.model, variables)
    return jcfg, jcohort, variables, w


def test_text_cache_cohort_and_cache_equal_jax():
    jcfg, jcohort, variables, w = cache_case()
    assert_same_batch(w.cohort, jcohort)
    ref = jattach_note_cache(jcfg, variables["params"], jcohort).note_chunk_embs
    got = attach_note_cache(w.cfg, w.model, w.cohort).note_chunk_embs
    assert tuple(got.shape) == (CACHE_KNOBS.batch, CACHE_KNOBS.chunks, w.cfg.encoder.bert_hidden)
    assert_close(got, ref)


def test_text_cache_line_has_the_jax_keys_and_both_legs_start_alike():
    """The JSON line's keys and metric are the JAX script's. With the fp32
    LayerNorm the cached forward equals the direct one, so the two legs'
    last losses agree only if both start from the same weights and draws."""
    ref = dumped_keys("scripts/bench_text_cache.py")
    out = ttc.run_text_cache(CACHE_KNOBS, "cpu", {**CACHE_SMALL, "encoder.bert_ln": "fp32"})
    line = out["line"]
    assert list(line) == list(ref) and line["metric"] == ref["metric"] == ttc.METRIC
    assert line["direct_stays_per_sec"] > 0 and line["cached_stays_per_sec"] > 0
    assert abs(line["speedup"] - line["cached_stays_per_sec"] / line["direct_stays_per_sec"]) <= 0.01
    assert (line["batch"], line["chunks"], line["steps"]) == (CACHE_KNOBS.batch, CACHE_KNOBS.chunks, 1)
    np.testing.assert_allclose(out["losses"]["cached"], out["losses"]["direct"], rtol=2e-5)
    assert set(out["launches"]) == {"cache_build", "direct", "cached"}


# --- (b) bench_bert --------------------------------------------------------------


@pytest.mark.parametrize("n, dims", [(1, {}), (16, {}), (128, {}), (3, {"t": 256, "d": 128, "ff": 256, "layers": 2})])
def test_bert_flops_equal_the_jax_script(n, dims):
    ref = jax_function("scripts/bench_bert.py", "bert_fwd_flops", {})
    assert tbb.bert_fwd_flops(n, **dims) == ref(n, **dims)
    assert tbb.bert_fwd_flops(128) == pytest.approx(1.237e13, rel=1e-3)


def test_bert_encoder_arguments_and_inputs_are_the_jax_script():
    call = next(n for n in ast.walk(source_tree("scripts/bench_bert.py")) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "BertEncoder")
    assert sorted(k.arg for k in call.keywords) == ["dtype", "gelu", "int8"]
    assert env_defaults("scripts/bench_bert.py") == env_defaults("scripts/torch_bench_bert.py") == {
        "BENCH_BERT_N": "128", "BENCH_BERT_STEPS": "10", "BENCH_BERT_INT8": "0", "BENCH_GELU": "poly"}
    for int8 in (False, True):
        enc = tbb.build_encoder(int8, "poly", "cpu", small=True)
        layer = enc.layer_0
        assert layer.gelu == "poly" and layer.intermediate.dtype == torch.bfloat16
        assert isinstance(layer.intermediate, QuantDense) == int8
        assert type(enc.embed_ln) is LayerNorm and type(layer.ln) is LayerNorm  # the fp32 default, not FastLayerNorm
        assert all(p.dtype == torch.float32 for p in enc.parameters())
    ids, attn = tbb.inputs(3, "cpu")
    np.testing.assert_array_equal(ids.numpy(), np.random.default_rng(0).integers(0, 28996, size=(3, 512)))
    assert ids.dtype == torch.int32 and attn.dtype == torch.float32 and bool((attn == 1).all())


def test_bench_bert_line_on_the_cpu(monkeypatch):
    for var, value in {"BENCH_BERT_N": "2", "BENCH_BERT_STEPS": "1", "MMR_FLASH": "1"}.items():
        monkeypatch.setenv(var, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tbb.main(["--device", "cpu", "--small"]) == 0
    last = out.getvalue().splitlines()[-1]
    m = re.fullmatch(r"\[bench_bert\] n=2 int8=0 flash=1: ([\d.]+) ms/fwd  ([\d.]+) TFLOP/s  MFU=([\d.]+)% "
                     r"\(H100 bf16 dense peak 989 TFLOP/s\)", last)
    assert m and float(m.group(1)) > 0, last


# --- (c) bench_int8 --------------------------------------------------------------


def test_int8_constants_equal_the_jax_script():
    tree = source_tree("scripts/bench_int8.py")
    shape = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)
                 and [t.id for t in n.targets[0].elts] == ["m", "k", "n"])
    assert tuple(e.value for e in shape.value.elts) == (tbi.M, tbi.K, tbi.N)
    timeit = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "timeit")
    assert [d.value for d in timeit.args.kw_defaults + timeit.args.defaults] == [tbi.STEPS]
    names = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert {"bf16", "int8-pre", "int8-dynamic-dense"} <= names


@pytest.mark.parametrize("m, k, n", [(64, 32, 48), (40, 96, 16)])
def test_dynamic_dense_matches_the_jax_script(m, k, n):
    """Within one int8 step (127 * s_x * s_w, plus a bf16 rounding of the
    output) on at most a few elements; the rest bit-equal."""
    jquant_dense = jax_function("scripts/bench_int8.py", "quant_dense", {"jax": jax, "jnp": jnp})
    x32, w32, _, _ = tbi.operands(m, k, n)
    ref = np.asarray(jquant_dense(jnp.asarray(x32), jnp.asarray(w32)).astype(jnp.float32))
    got = tbi.quant_dense(torch.from_numpy(x32), torch.from_numpy(w32))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    step = 127 * (np.abs(x32).max(1, keepdims=True) / 127) * (np.abs(w32).max(0, keepdims=True) / 127)
    off = got != ref
    assert off.sum() <= 3, off.sum()
    assert (np.abs(got - ref) <= step + 2.0**-7 * np.abs(ref))[off].all()


def test_bench_int8_lines_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tbi.main(["--device", "cpu", "--small"]) == 0
    lines = out.getvalue().splitlines()
    for name in ("bf16", "int8-pre", "int8-dynamic-dense"):
        assert any(re.fullmatch(rf"\[bench_int8\] {name}: [\d.]+ ms  [\d.]+ T\(FL\)OP/s", x) for x in lines), name
    m = re.fullmatch(r"\[bench_int8\] dynamic dense rel err: mean=([\d.]+) p99=([\d.]+)", lines[-1])
    assert m and 0 < float(m.group(1)) < float(m.group(2)), lines[-1]


# --- (d) no JAX, and a card unless asked for the CPU ------------------------------


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_scripts_import_no_jax(script):
    mods = set(imported_modules(os.path.join("scripts", script)))
    assert mods and not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "multimodalrouting_tpu")}


@pytest.mark.parametrize("main", [ttc.main, tbb.main, tbi.main], ids=PORT_SCRIPTS)
def test_scripts_exit_without_a_card(main):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as exc:
        main([])
    assert exc.value.code not in (0, None)
