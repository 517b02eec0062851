"""Shared helpers of the PyTorch port's parity tests: the same numpy inputs
and weights go through a JAX module and its port."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train.loop import note_pack_bucket as jnote_pack_bucket
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu.train.state import n_route_loss_ema_for as jn_route_loss_ema_for
from multimodalrouting_tpu.train.steps import make_train_step as jmake_train_step
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import state_dict_from_jax, train_state_from_jax
from multimodalrouting_tpu_torch.data.batches import Batch as TorchBatch
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket
from multimodalrouting_tpu_torch.train.state import serving_state_dict
from multimodalrouting_tpu_torch.train.steps import make_train_step

RTOL, ATOL = 2e-4, 2e-5  # fp32 parity, as tests/test_pallas.py holds the kernels
# XLA:CPU compile options for the JAX references: LLVM without its expensive
# passes compiles a tiny model's step in about half the time, same numbers
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tiny models: the suite's workers
    share the cores, and at these sizes threads only contend (a test module
    uses it with ``pytestmark = pytest.mark.usefixtures(...)``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, dtype=np.asarray(x).dtype), tree)


def jitter(variables, seed: int = 0, scale: float = 0.1):
    """Numpy copy of flax variables with every parameter perturbed and
    BatchNorm statistics made nonzero, so zero-initialised leaves (capsule
    head embedding, biases) carry signal through the comparison."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in to_numpy(dict(variables)).items():
        if col == "batch_stats":
            def stat(path, x):
                name = str(getattr(path[-1], "key", path[-1]))
                if name == "var":
                    return (0.5 + rng.random(x.shape)).astype(x.dtype)
                return (0.1 * rng.normal(size=x.shape)).astype(x.dtype)

            out[col] = jax.tree_util.tree_map_with_path(stat, tree)
        else:
            out[col] = jax.tree_util.tree_map(
                lambda x: (x + scale * rng.normal(size=x.shape)).astype(x.dtype), tree
            )
    return out


def seeded_like(shapes, seed: int):
    """Numpy values for a tree of ShapeDtypeStructs (``jax.eval_shape`` of a
    flax init), from a seeded generator: LayerNorm scales near 1, biases
    near 0, residual scales near 0.5, kernels and tables N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name in ("scale", "ln_scale"):
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("bias", "ln_bias", "b1", "b2"):
            x = 0.1 * rng.normal(size=shape)
        elif name == "res_scale":
            x = 0.5 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            fan_in = shape[-2] if len(shape) == 3 else int(np.prod(shape[:-1]))
            x = rng.normal(size=shape) / np.sqrt(fan_in)
        else:
            x = 0.1 * rng.normal(size=shape)
        return np.asarray(x, dtype=s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def compiled(fn, *args):
    """fn(*args) as one program compiled with ``O0``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)(*args)


def torch_batch(batch) -> TorchBatch:
    """A JAX-package Batch of numpy arrays as the port's Batch of CPU tensors."""
    return batch_to(TorchBatch(*batch), "cpu")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def assert_close(got, ref, rtol: float = RTOL, atol: float = ATOL, err_msg: str = ""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, dtype=np.float32), rtol=rtol, atol=atol, err_msg=err_msg)


# --- the train-step trajectories (tests/test_torch_train*.py) ---------------

# the --small widths of scripts/demo_synthetic.py, BERT at 256 tokens x 128
# hidden with 2 heads so the packed gate holds, BatchNorm, fp32, no dropout
TRAIN_SMALL = {
    "encoder.d": 48, "encoder.structured_seq_len": 16, "encoder.structured_n_feats": 16,
    "encoder.structured_layers": 1, "encoder.structured_heads": 4, "encoder.bert_hidden": 128,
    "encoder.bert_layers": 2, "encoder.bert_heads": 2, "encoder.bert_intermediate": 96,
    "encoder.bert_vocab_size": 2048, "encoder.bert_max_position": 256, "encoder.notes_max_chunks": 5,
    "encoder.text_max_len": 256, "encoder.image_size": 32, "encoder.vision_backbone": "resnet18",
    "encoder.vision_norm": "batch", "model.d": 48, "model.mult_layers": 1, "model.mult_self_layers": 1,
    "model.mult_heads": 4, "model.pc_dim": 8, "model.mc_caps_dim": 16, "model.dtype": "float32",
    "model.attn_dropout": 0.0, "model.relu_dropout": 0.0, "model.res_dropout": 0.0,
    "model.embed_dropout": 0.0, "train.batch_size": 4, "train.route_dropout_p": 0.0,
}
LR_HEAD, LR_ENC = 2e-4, 1e-4
RTOL_STEPS = 5e-4  # ROADMAP.md's figure for K optimizer steps against the JAX package


def train_cfgs(**extra):
    over = {**TRAIN_SMALL, **extra}
    return jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)


def train_cohorts(k: int, seed: int = 10):
    return [make_synthetic_cohort(4, t=16, f=16, s=5, l=256, image_size=32, vocab_size=2048, seed=seed + i)
            for i in range(k)]


def jax_trajectory(jcfg, batches):
    """(the initial JAX TrainState as numpy, per-step losses, final state)."""
    model = jbuild_model(jcfg, "capsule")
    example = jax.tree_util.tree_map(jnp.asarray, batches[0])
    variables = jitter(model.init(jax.random.PRNGKey(0), example, train=False), seed=3, scale=0.1)
    state = jcreate_train_state(jcfg, model, jax.tree_util.tree_map(jnp.asarray, variables))
    init = to_numpy({"params": state.params, "batch_stats": state.batch_stats, "ema_params": state.ema_params,
                     "opt_state": state.opt_state, "step": state.step})
    step = jmake_train_step(jcfg, model, "capsule")
    losses = []
    for i, b in enumerate(batches):
        state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, b), jax.random.PRNGKey(i),
                              jnp.asarray(LR_HEAD), jnp.asarray(LR_ENC), note_pack=jnote_pack_bucket(jcfg, b))
        losses.append(float(metrics.loss))
    return init, losses, state


def port_trajectory(tcfg, init, batches):
    """(model, train state, per-step losses) from the JAX initial state."""
    model = build_model(tcfg, device="cpu", train=True)
    state = train_state_from_jax(tcfg, model, init)
    step = make_train_step(tcfg, model)
    losses = []
    for b in batches:
        tb = TorchBatch(*b)
        metrics = step(state, torch_batch(b), None, LR_HEAD, LR_ENC, note_pack=note_pack_bucket(tcfg, tb))
        assert metrics.grad_finite
        losses.append(float(metrics.loss))
    return model, state, losses


def relative_errors(got, ref):
    """Per state_dict key: ||got - ref|| / ||ref||."""
    out = {}
    for key, r in ref.items():
        r = r.float().numpy()
        out[key] = float(np.linalg.norm(got[key].float().numpy() - r) / max(np.linalg.norm(r), 1e-30))
    return out


def assert_same_weights(model, state, jstate):
    bs = to_numpy(jstate.batch_stats)
    ref = state_dict_from_jax({"params": to_numpy(jstate.params), "batch_stats": bs}, model)
    ref_ema = state_dict_from_jax({"params": to_numpy(jstate.ema_params), "batch_stats": bs}, model)
    for name, got, want in (("params", model.state_dict(), ref), ("ema", serving_state_dict(state), ref_ema)):
        errors = relative_errors(got, want)
        worst = max(errors, key=errors.get)
        assert errors[worst] <= RTOL_STEPS, f"{name}: {worst} off by {errors[worst]:.3e} in relative norm"


# --- one family step or forward from eval_shape weights (tests/test_torch_families.py,
# tests/test_torch_route_mult.py) ---------------------------------------------

STEP_LR = 2e-3


def seeded_variables(model, batch, seed: int):
    """The model's variables at init's shapes (``seeded_like``)."""
    return seeded_like(jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b, train=False), batch), seed)


def jax_forwards(model, variables, batch, calls):
    """The JAX model's eval outputs under each kwargs dict of `calls`, as
    one program compiled without LLVM's expensive passes (eager JAX compiles
    every op's shape on first use: several times slower here)."""
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def run(v, b):
        return [model.apply(v, b, train=False, **kw) for kw in calls]

    return compiled(run, variables, jb)


def jax_step(jcfg, model, variables, family, batch, stage="", **step_kw):
    """One JAX train step from `variables` -> (initial state as numpy,
    metrics, state after)."""
    # a fresh state (the step donates it; `variables` is shared), made by one
    # compiled program: eagerly, optax's init compiles op by op
    state = compiled(lambda v: jcreate_train_state(jcfg, model, v, stage=stage,
                                                   n_route_loss_ema=jn_route_loss_ema_for(jcfg, family)), variables)
    if state.route_loss_ema is not None:
        state = state.replace(route_loss_ema=jnp.asarray(step_kw.pop("ema")))
    init = to_numpy({"params": state.params, "batch_stats": state.batch_stats, "ema_params": state.ema_params,
                     "opt_state": state.opt_state, "step": state.step, "route_loss_ema": state.route_loss_ema})
    step = jmake_train_step(jcfg, model, family, **({"stage": stage} if stage else {}))
    args = (state, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0), jnp.asarray(STEP_LR),
            jnp.asarray(STEP_LR / 2))
    new_state, metrics = step.lower(*args).compile(compiler_options=O0)(*args)
    return init, metrics, new_state


def port_step(tcfg, family, model_family, init, batch, stage=""):
    model = build_model(tcfg, model_family, device="cpu", train=True)
    state = train_state_from_jax(tcfg, model, init, stage=stage)
    step = make_train_step(tcfg, model, family, **({"stage": stage} if stage else {}))
    metrics = step(state, torch_batch(batch), None, STEP_LR, STEP_LR / 2)
    assert metrics.grad_finite
    return model, state, metrics


def assert_step(tcfg, family, model_family, jcfg_model_vars, batch, stage="", **step_kw):
    jcfg, model, variables = jcfg_model_vars
    init, jmetrics, jstate = jax_step(jcfg, model, variables, family, batch, stage=stage, **step_kw)
    tmodel, state, metrics = port_step(tcfg, family, model_family, init, batch, stage=stage)
    np.testing.assert_allclose(float(metrics.loss), float(jmetrics.loss), rtol=RTOL_STEPS)
    np.testing.assert_allclose(float(metrics.reg_loss), float(jmetrics.reg_loss), rtol=RTOL_STEPS, atol=1e-7)
    assert_same_weights(tmodel, state, jstate)
    if jmetrics.gates_mean is not None:
        assert_close(metrics.gates_mean, jmetrics.gates_mean)
    return init, tmodel, state, jstate


# --- the data layer (data/*.py): files and batches, bit for bit --------------


def assert_same_files(got_dir, ref_dir, skip=()):
    """Every file under `ref_dir` (recursively) is under `got_dir` with the
    same contents: parquet and CSV (gz) frames by ``pd.testing.
    assert_frame_equal``, JSON by value, NPZ array by array, anything else
    byte for byte; and no file is missing on either side."""
    import json
    import os

    import pandas as pd

    def listing(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs
                      if os.path.relpath(os.path.join(r, f), d) not in skip)

    names = listing(ref_dir)
    assert names and listing(got_dir) == names, (listing(got_dir), names)
    for name in names:
        got, ref = os.path.join(got_dir, name), os.path.join(ref_dir, name)
        if name.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(got), pd.read_parquet(ref), check_exact=True, obj=name)
        elif name.endswith((".csv", ".csv.gz")):
            pd.testing.assert_frame_equal(pd.read_csv(got), pd.read_csv(ref), check_exact=True, obj=name)
        elif name.endswith(".json"):
            with open(got) as g, open(ref) as r:
                assert json.load(g) == json.load(r), name
        elif name.endswith(".npz"):
            zg, zr = np.load(got), np.load(ref)
            assert sorted(zg.files) == sorted(zr.files), name
            for k in zr.files:
                assert zg[k].dtype == zr[k].dtype, (name, k)
                np.testing.assert_array_equal(zg[k], zr[k], err_msg=f"{name}:{k}")
        else:
            with open(got, "rb") as g, open(ref, "rb") as r:
                assert g.read() == r.read(), name
    return names


def assert_same_batch(got, ref, fields=None):
    """A port Batch against a JAX Batch, field by field: the same dtype and
    shape and the same bits (None where the JAX one is None)."""
    for name in fields or ref._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if r is None:
            assert g is None, name
            continue
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (name, g.dtype, r.dtype, g.shape, r.shape)
        np.testing.assert_array_equal(g, r, err_msg=name)


def write_cxr_jpegs(export_dir, image_root, seed: int = 0, size=(48, 48)) -> int:
    """A grayscale JPEG at every exported ``cxr_path`` under `image_root`, as
    MIMIC-CXR-JPG lays them out -> the number written."""
    import os

    import pandas as pd
    from PIL import Image

    images = pd.read_parquet(os.path.join(export_dir, "images_48h.parquet"))
    rng = np.random.default_rng(seed)
    n = 0
    for p in images.get("cxr_path", []):
        if not isinstance(p, str) or not p:
            continue
        full = os.path.join(image_root, p)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        Image.fromarray(rng.integers(30, 220, size=size, dtype=np.uint8), mode="L").save(full, format="JPEG")
        n += 1
    return n


@pytest.fixture(scope="module")
def port_native_build_dir(tmp_path_factory):
    """The port's C++ data libraries built into a temporary directory for a
    module (``data/native_build.BUILD_DIR``), never the JAX package's
    ``native/*.so``; the JAX package's own build code writes its libraries
    into another (``_SO``), so no other test process loads one half
    written."""
    from multimodalrouting_tpu.data import native_binner as jnative_binner
    from multimodalrouting_tpu.data import native_tokenizer as jnative_tokenizer
    from multimodalrouting_tpu_torch.data import native_binner, native_build

    d = tmp_path_factory.mktemp("native_build")
    (d / "jax").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_build, "BUILD_DIR", str(d))
        mp.setattr(native_binner, "_LIB", None)
        mp.setattr(jnative_binner, "_SO", str(d / "jax" / "libbinner.so"))
        mp.setattr(jnative_binner, "_LIB", None)
        mp.setattr(jnative_tokenizer, "_SO", str(d / "jax" / "libwordpiece.so"))
        yield str(d)


def port_etl_export(raw_dir, d, max_len: int = 32, max_chunks: int = 2):
    """The port's ``cli etl varmap | cohort | export`` chain over a raw dump
    into `d` (``d/export``), JPEGs at the export's ``cxr_path``s under
    ``d/images`` -> (export dir, image root)."""
    import contextlib
    import io

    from multimodalrouting_tpu_torch import cli as tcli

    for argv in (["varmap", "--data-dir", str(raw_dir), "--out", str(d / "varmap.csv")],
                 ["cohort", "--data-dir", str(raw_dir), "--out", str(d / "cohort"), "--varmap",
                  str(d / "varmap.csv"), "--cxr-meta", str(raw_dir / "cxr_metadata.csv.gz"),
                  "--notes", str(raw_dir / "notes.csv.gz")],
                 ["export", "--cohort", str(d / "cohort"), "--out", str(d / "export"), "--max-len", str(max_len),
                  "--max-chunks", str(max_chunks)]):
        with contextlib.redirect_stdout(io.StringIO()):
            assert tcli.main(["etl", *argv]) == 0, argv
    assert write_cxr_jpegs(str(d / "export"), str(d / "images")) > 0
    return str(d / "export"), str(d / "images")
