"""JAX checkpoints into the port (ckpt.resolve, utils/flax_msgpack.py,
bridge.train_state_dict_from_jax) on the CPU.

Each fixture is a tiny JAX train state after one JAX train step (non-zero
moments), written by the JAX package's own ``save_checkpoint`` as
``<name>.msgpack`` + ``<name>.meta.json``:

- the reader gives ``flax.serialization.msgpack_restore``'s leaves bit for
  bit: fp32, bf16 (the frozen BERT body under bf16 compute), chunked leaves
  (flax's chunk size monkeypatched small), 0-d leaves and numpy scalars,
  and it runs with ``jax``, ``flax``, ``msgpack`` and ``ml_dtypes``
  unimportable;
- ``Predictor(dir, name=...)`` serves the JAX state's EMA weights: its
  forward equals JAX ``apply`` (2e-4 / 2e-5), with and without JAX
  importable; the bf16 weights load bit for bit;
- a full restore and one more step equal JAX ``make_train_step``'s second
  step, per leaf within 5e-4 in relative norm, the step counter continuing;
- ``--init-from`` a pipeline-layout checkpoint into the layered model, and
  the full restore across layouts refused with the JAX package's error;
- a loss-based FAME++ state keeps its route-loss EMA;
- the same states written by the JAX ``save_checkpoint(..., backend="orbax")``
  (the fp32 one with its largest kernel sharded over four host devices, so
  that it is written as four zarr chunks): ``utils/orbax_reader.py`` gives
  ``read_msgpack``'s tree and orbax's own restore bit for bit, serves and
  resumes as the msgpack pair does, reads with ``jax``, ``flax``,
  ``orbax``, ``tensorstore`` and ``ml_dtypes`` unimportable, and refuses a
  node whose checksum fails; a None and an empty dict come back as orbax
  stores them (not at all); tensorstore's multi-level B-trees read too;
- an empty ``.orbax`` directory and missing names raise; the CLI's ``eval
  --ckpt DIR --name`` and ``train --resume DIR`` read a JAX pair;
- chip_smoke.py's flax-layout writer (the card's JAX checkpoints) writes
  what the JAX package's ``restore_checkpoint`` restores.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.ckpt import restore_checkpoint as jrestore_checkpoint
from multimodalrouting_tpu.ckpt import save_checkpoint as jsave_checkpoint
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu.train.state import n_route_loss_ema_for as jn_route_loss_ema_for
from multimodalrouting_tpu.train.steps import make_train_step as jmake_train_step
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import load_config, load_meta, resolve, restore_train_state
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.serve import Predictor
from multimodalrouting_tpu_torch.train.state import create_train_state, n_route_loss_ema_for
from multimodalrouting_tpu_torch.train.steps import make_train_step
from multimodalrouting_tpu_torch.utils.flax_msgpack import msgpack_restore, read_msgpack
from multimodalrouting_tpu_torch.utils.orbax_reader import OcdbtStore, read_orbax, zstd_decompress
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    O0,
    RTOL_STEPS,
    STEP_LR,
    assert_close,
    assert_same_weights,
    compiled,
    one_torch_thread,
    seeded_variables,
    to_numpy,
    torch_batch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {**TINY, "encoder.text_max_len": 16, "encoder.image_size": 32, "data.synthetic_n": 8,
        "model.attn_dropout": 0.0, "model.relu_dropout": 0.0, "model.res_dropout": 0.0, "model.embed_dropout": 0.0}
PATHS = {  # the flagship in fp32; in bf16 on the pipeline layout; FAME++ with the loss-based gate
    "fp32": ("capsule", {}),
    "bf16_pp": ("capsule", {"model.dtype": "bfloat16", "train.pipeline_parallel": True}),
    "fame": ("fame", {"model.smro_gate_mode": "loss_based", "model.task": "multitask", "model.num_classes": 3}),
}


def _lrs():
    return jnp.asarray(STEP_LR), jnp.asarray(STEP_LR / 2)


def _shard_largest_kernel(state):
    """`state` with its largest parameter sharded over a 2 x 2 mesh of host
    devices along its last two axes (orbax writes each shard as a chunk)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    path, leaf = max(jax.tree_util.tree_leaves_with_path(state.params), key=lambda pl: pl[1].size)
    spec = PartitionSpec(*([None] * (leaf.ndim - 2)), "a", "b")
    sharded = jax.device_put(leaf, NamedSharding(mesh, spec))
    return state.replace(params=jax.tree_util.tree_map_with_path(lambda p, x: sharded if p == path else x,
                                                                 state.params))


def _write(tmp, key: str, chunk_size=None):
    """Build, step and save one JAX state; keep what the tests compare as
    numpy: the state after the step, the eval forward of its EMA weights
    and, from the state on disk, the state and loss one more step on."""
    family, extra = PATHS[key]
    jcfg = jc.apply_overrides(jc.Config(), {**BASE, **extra})
    model = jbuild_model(jcfg, family)
    batch = tiny_batch(n=4, seed=1, task=jcfg.model.task, missing_rate=0.25)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = seeded_variables(model, jb, 7)
    n_rle = jn_route_loss_ema_for(jcfg, family)
    state = compiled(lambda v: jcreate_train_state(jcfg, model, v, n_route_loss_ema=n_rle), variables)
    if n_rle:
        state = state.replace(route_loss_ema=jnp.asarray(np.linspace(0.3, 0.9, n_rle, dtype=np.float32)))
    step = jmake_train_step(jcfg, model, family)
    args = (state, jb, jax.random.PRNGKey(0), *_lrs())
    run = step.lower(*args).compile(compiler_options=O0)
    state, _ = run(*args)
    ckpt_dir = str(tmp / key)
    mp = pytest.MonkeyPatch()
    if chunk_size:
        mp.setattr(serialization, "MAX_CHUNK_SIZE", chunk_size)
    try:
        jsave_checkpoint(ckpt_dir, state, jcfg, name="final", thresholds=[0.4], extra={"temperature": 1.25})
    finally:
        mp.undo()
    orbax_dir = ckpt_dir + "_orbax"  # the same state through the orbax backend
    jsave_checkpoint(orbax_dir, _shard_largest_kernel(state) if key == "fp32" else state, jcfg, name="final",
                     thresholds=[0.4], extra={"temperature": 1.25}, backend="orbax")
    out = types.SimpleNamespace(key=key, family=family, jcfg=jcfg, dir=ckpt_dir, orbax_dir=orbax_dir, batch=batch,
                                saved=to_numpy({
        "params": state.params, "batch_stats": state.batch_stats, "ema_params": state.ema_params,
        "step": state.step, "route_loss_ema": state.route_loss_ema}))
    if key != "bf16_pp":  # the serving forward (under the loss-based gate, of the state's route-loss EMA)
        kw = {} if state.route_loss_ema is None else {"route_losses_ema": state.route_loss_ema}
        out.forward = to_numpy(compiled(lambda v, b: model.apply(v, b, train=False, **kw),
                                        {"params": state.ema_params, "batch_stats": state.batch_stats}, jb))
    if key == "fp32":
        out.next_state, metrics = run(state, jb, jax.random.PRNGKey(1), *_lrs())
        out.next_loss = float(metrics.loss)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    out = {key: _write(tmp, key, chunk_size=2**18 if key == "bf16_pp" else None) for key in PATHS}
    yield out
    shutil.rmtree(tmp)  # ~0.5 GB of JAX train states: keep the suite's disk small


def _tcfg(run):
    return tc.apply_overrides(tc.Config(), {**BASE, **PATHS[run.key][1]})


def _leaves_equal(got, ref, path="", ordered=True) -> int:
    """Same tree, every leaf bit for bit; -> the number of array leaves.
    `ordered`: each dict's keys in the same order too (orbax keeps no order:
    its tree comes back with sorted keys)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(ref) if ordered else sorted(got) == sorted(ref), path
        return sum(_leaves_equal(got[k], ref[k], f"{path}/{k}", ordered) for k in ref)
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(ref), path
        return sum(_leaves_equal(g, r, f"{path}[{i}]", ordered) for i, (g, r) in enumerate(zip(got, ref)))
    if isinstance(ref, torch.Tensor):  # a bf16 leaf of the port's own reader
        assert isinstance(got, torch.Tensor) and got.dtype == ref.dtype and got.shape == ref.shape, path
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16)), path
        return 1
    if isinstance(ref, (np.ndarray, np.generic)):
        r = np.asarray(ref)
        if r.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            g = got.contiguous().view(torch.int16).numpy().view(np.uint16)
            r = r.view(np.uint16)
        else:
            g = np.asarray(got)
            assert g.dtype == r.dtype, path
        assert g.shape == r.shape and g.tobytes() == r.tobytes(), path
        return 1
    assert type(got) is type(ref) and got == ref, (path, got, ref)
    return 0


@pytest.mark.parametrize("key", ["fp32", "bf16_pp"])
def test_reader_gives_flax_leaves_bit_for_bit(runs, key):
    path = os.path.join(runs[key].dir, "final.msgpack")
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got = read_msgpack(path)
    assert _leaves_equal(got, ref) > 100
    assert got["step"].shape == () and int(got["step"]) == 1
    bert = got["params"]["encoders"]["bbert"]["bert"]["word_embeddings"]["embedding"]
    assert (bert.dtype == torch.bfloat16) == (key == "bf16_pp")
    if key == "bf16_pp":  # saved with flax's chunk size at 256 KiB: the ResNet's big kernels were chunked
        with open(path, "rb") as f:
            assert b"__msgpack_chunked_array__" in f.read()


def test_reader_on_every_type_and_chunks(monkeypatch):
    import ml_dtypes

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.standard_normal((50, 40)).astype(np.float32),  # 8000 B: chunked
        "bf16": rng.standard_normal((30, 50)).astype(ml_dtypes.bfloat16),  # 3000 B: chunked
        "small": {"i8": np.arange(-3, 4, dtype=np.int8), "u64": np.array([2**63], np.uint64),
                  "f16": np.ones((2, 3), np.float16), "b": np.array([True, False])},
        "step": np.asarray(7, np.int32), "scalar": np.float32(1.5), "empty": {}, "none": None,
        "flags": [True, False], "text": "x" * 40, "ints": [0, -1, 127, -33, 300, -300, 70000, 2**40, -2**40],
        "floats": [0.25, 1e300], "blob": b"\x00\x01" * 200, "long": list(range(20)),
        "keys": {f"k{i}": i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    got = msgpack_restore(bytearray(data))
    assert _leaves_equal(got, ref) == 8
    assert isinstance(got["scalar"], np.float32) and got["f32"].flags.writeable
    with pytest.raises(ValueError, match="ext 2"):
        msgpack_restore(serialization.msgpack_serialize({"c": complex(1, 2)}))
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-5])


def test_served_forward_equals_jax_apply(runs):
    """fp32: the EMA weights' forward at 2e-4 / 2e-5. bf16: the weights the
    Predictor loads are the JAX state's EMA leaves bit for bit (BERT body in
    bf16)."""
    run = runs["fp32"]
    pred = Predictor(run.dir, name="final", device="cpu")
    assert (pred.temperature, pred.thresholds.tolist()) == (1.25, [0.4])
    with torch.no_grad():
        got = pred.forward(torch_batch(run.batch))
    for name in ("logits", "alpha", "r_matrix"):
        assert_close(getattr(got, name), getattr(run.forward, name), err_msg=name)
    assert Predictor(run.dir, device="cpu").temperature == 1.25  # name defaults to JAX's "final"
    run = runs["bf16_pp"]
    pred = Predictor(os.path.join(run.dir, "final"), device="cpu")
    ref = state_dict_from_jax({"ema_params": run.saved["ema_params"], "params": run.saved["params"],
                               "batch_stats": run.saved["batch_stats"]}, pred.model)
    got = pred.model.state_dict()
    assert got["encoders.bbert.bert.pp_layers.i_kernel"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], v) for k, v in ref.items())


def test_serving_needs_no_jax(runs):
    """A fresh process with jax, flax, msgpack, ml_dtypes, orbax and the JAX
    package unimportable serves the fp32 fixture (the port's synthetic
    cohort is bit-identical to the JAX package's)."""
    run = runs["fp32"]
    code = f"""
import json, sys
for m in ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "orbax", "multimodalrouting_tpu"):
    sys.modules[m] = None
import torch
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.serve import Predictor
torch.set_num_threads(1)
batch = make_synthetic_cohort(4, t=12, f=16, s=2, l=16, image_size=32, vocab_size=1024, seed=1, missing_rate=0.25)
pred = Predictor({run.dir!r}, name="final", device="cpu")
print(json.dumps(pred.forward(batch_to(batch, "cpu")).logits.tolist()))
"""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert_close(torch.tensor(json.loads(out.stdout.splitlines()[-1])), run.forward.logits)


def test_resumed_step_matches_jax(runs):
    run = runs["fp32"]
    tcfg = load_config(run.dir, "final")
    assert tcfg == _tcfg(run) and tcfg.train.pos_weight_clip == (0.1, 5.0)
    model = build_model(tcfg, device="cpu", train=True)
    state = restore_train_state(run.dir, create_train_state(tcfg, model), name="final")
    assert (state.step, state.count, state.loop) == (1, 1, {})
    assert any(float(v.abs().max()) > 0 for v in state.mu.values())
    metrics = make_train_step(tcfg, model)(state, torch_batch(run.batch), None, STEP_LR, STEP_LR / 2)
    assert metrics.grad_finite and state.step == int(run.next_state.step) == 2
    np.testing.assert_allclose(float(metrics.loss), run.next_loss, rtol=RTOL_STEPS)
    assert_same_weights(model, state, run.next_state)


def test_init_from_a_pipeline_layout_checkpoint(runs):
    """The stacked pp_layers checkpoint warm-starts the layered model: its
    raw weights are the JAX package's own unstacking of the checkpoint's,
    bit for bit; a full restore across the layouts raises the JAX package's
    ValueError, and one on the same layout resumes."""
    from multimodalrouting_tpu.parallel.pp import from_pp_layout as jfrom_pp_layout

    run = runs["bf16_pp"]
    tcfg = tc.apply_overrides(_tcfg(run), {"train.pipeline_parallel": False})
    model = build_model(tcfg, device="cpu", train=True)
    state = restore_train_state(run.dir, create_train_state(tcfg, model), name="final", params_only=True)
    assert state.step == 0
    params = dict(run.saved["params"])
    params["encoders"] = {**params["encoders"], "bbert": {**params["encoders"]["bbert"]}}
    params["encoders"]["bbert"]["bert"] = to_numpy(jfrom_pp_layout(params["encoders"]["bbert"]["bert"]))
    want = state_dict_from_jax({"params": params, "batch_stats": run.saved["batch_stats"]}, model)
    got = model.state_dict()
    assert "encoders.bbert.bert.layer_0.intermediate.weight" in got
    assert all(torch.equal(got[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match="different BERT param layouts"):
        restore_train_state(run.dir, create_train_state(tcfg, build_model(tcfg, device="cpu")), name="final")
    pp_model = build_model(_tcfg(run), device="cpu", train=True)
    assert restore_train_state(run.dir, create_train_state(_tcfg(run), pp_model), name="final").step == 1


def test_loss_based_fame_keeps_its_route_loss_ema(runs):
    run = runs["fame"]
    want = torch.from_numpy(run.saved["route_loss_ema"])
    assert not torch.allclose(want, torch.linspace(0.3, 0.9, 7))  # the JAX step moved it
    tcfg = _tcfg(run)
    for params_only in (False, True):
        model = build_model(tcfg, "fame", device="cpu")
        state = create_train_state(tcfg, model, n_route_loss_ema=n_route_loss_ema_for(tcfg, "fame"))
        state = restore_train_state(run.dir, state, name="final", params_only=params_only)
        assert torch.equal(state.route_loss_ema, want)
    pred = Predictor(run.dir, "fame", name="final", device="cpu")
    assert torch.equal(pred.route_loss_ema, want)
    with torch.no_grad():
        assert_close(pred.forward(torch_batch(run.batch)).logits, run.forward.logits)


def test_orbax_and_missing_names_raise(runs, tmp_path):
    """An orbax directory without its manifest (an unfinished save) and
    missing names raise FileNotFoundError; a whole orbax checkpoint
    resolves."""
    os.makedirs(tmp_path / "x.orbax")
    with pytest.raises(FileNotFoundError, match="x.orbax holds no manifest.ocdbt"):
        resolve(str(tmp_path), "x")
    with pytest.raises(FileNotFoundError, match="x.orbax holds no manifest.ocdbt"):
        Predictor(str(tmp_path), name="x", device="cpu")
    assert resolve(runs["fp32"].orbax_dir, "final") == ("orbax", os.path.join(runs["fp32"].orbax_dir, "final.orbax"))
    with pytest.raises(FileNotFoundError, match="no checkpoint 'missing'"):
        load_config(str(tmp_path), "missing")
    with open(tmp_path / "lone.msgpack", "wb") as f:
        f.write(b"\x80")
    with pytest.raises(FileNotFoundError, match="meta.json"):
        load_meta(str(tmp_path), "lone")
    assert resolve(runs["fp32"].dir, "final")[0] == "jax"
    assert load_meta(runs["fp32"].dir, "final")["step"] == 1


# --- the orbax backend (utils/orbax_reader.py) --------------------------------


def _orbax(run) -> str:
    return os.path.join(run.orbax_dir, "final.orbax")


@pytest.mark.parametrize("key", list(PATHS))
def test_orbax_reader_gives_the_msgpack_tree_bit_for_bit(runs, key):
    """The orbax checkpoint of a state reads as its msgpack file does, and
    as orbax's own restore gives it, leaf for leaf and bit for bit (fp32,
    the bf16 BERT body, the 0-d step, empty optimizer states); the fp32
    state's largest kernel (several MB) comes back from its four chunks."""
    import orbax.checkpoint as ocp

    run = runs[key]
    got = read_orbax(_orbax(run))
    assert _leaves_equal(got, read_msgpack(os.path.join(run.dir, "final.msgpack")), ordered=False) > 100
    restored = ocp.StandardCheckpointer().restore(os.path.abspath(_orbax(run)))
    assert _leaves_equal(got, jax.tree_util.tree_map(np.asarray, restored), ordered=False) > 100
    assert got["step"].shape == () and int(got["step"]) == 1
    if key == "fp32":
        chunks = {}
        for k in OcdbtStore(_orbax(run)).keys():
            if not k.endswith("/.zarray"):
                chunks.setdefault(k.split("/")[0], []).append(k.split("/")[1])
        (sharded,) = [k for k, v in chunks.items() if len(v) > 1]
        assert sorted(chunks[sharded]) == ["0.0.0.0", "0.0.0.1", "0.0.1.0", "0.0.1.1"]
        leaf = got
        for part in sharded.split("."):
            leaf = leaf[part]
        assert leaf.nbytes > 2**21 and leaf.flags.writeable


def test_orbax_checkpoint_serves_and_resumes(runs):
    """Predictor on the orbax fp32 checkpoint serves the msgpack pair's
    weights bit for bit; a full restore and one more step equal JAX
    ``make_train_step``'s second step (as from the msgpack pair); the
    loss-based FAME++ state keeps its route-loss EMA."""
    run = runs["fp32"]
    pred = Predictor(run.orbax_dir, name="final", device="cpu")
    ref = Predictor(run.dir, name="final", device="cpu")
    assert (pred.temperature, pred.thresholds.tolist()) == (1.25, [0.4])
    assert all(torch.equal(v, ref.model.state_dict()[k]) for k, v in pred.model.state_dict().items())
    tcfg = load_config(run.orbax_dir, "final")
    assert tcfg == _tcfg(run)
    model = build_model(tcfg, device="cpu", train=True)
    state = restore_train_state(run.orbax_dir, create_train_state(tcfg, model), name="final")
    assert (state.step, state.count) == (1, 1)
    metrics = make_train_step(tcfg, model)(state, torch_batch(run.batch), None, STEP_LR, STEP_LR / 2)
    np.testing.assert_allclose(float(metrics.loss), run.next_loss, rtol=RTOL_STEPS)
    assert_same_weights(model, state, run.next_state)
    fame = runs["fame"]
    pred = Predictor(fame.orbax_dir, "fame", name="final", device="cpu")
    assert torch.equal(pred.route_loss_ema, torch.from_numpy(fame.saved["route_loss_ema"]))


def test_orbax_reads_with_jax_and_orbax_unimportable(runs):
    """A fresh process with jax, flax, orbax, tensorstore, msgpack,
    ml_dtypes, zstandard and the JAX package unimportable reads the orbax
    checkpoint and serves it: the same logits as JAX ``apply``."""
    run = runs["fp32"]
    code = f"""
import json, sys
for m in ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "orbax", "tensorstore", "zstandard",
          "multimodalrouting_tpu"):
    sys.modules[m] = None
import torch
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.serve import Predictor
torch.set_num_threads(1)
batch = make_synthetic_cohort(4, t=12, f=16, s=2, l=16, image_size=32, vocab_size=1024, seed=1, missing_rate=0.25)
pred = Predictor({run.orbax_dir!r}, name="final", device="cpu")
print(json.dumps(pred.forward(batch_to(batch, "cpu")).logits.tolist()))
"""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert_close(torch.tensor(json.loads(out.stdout.splitlines()[-1])), run.forward.logits)


def test_orbax_node_with_a_bad_checksum_is_refused(runs, tmp_path):
    """One flipped byte in the root B-tree node (a copy; the data files are
    linked) fails its crc32c."""
    src, dst = _orbax(runs["fp32"]), str(tmp_path / "final.orbax")
    shutil.copytree(src, dst, copy_function=os.link)
    (node,) = os.listdir(os.path.join(dst, "d"))
    path = os.path.join(dst, "d", node)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    os.remove(path)  # a new file, not the linked one
    data[len(data) // 2] ^= 0x40
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="crc32c checksum mismatch"):
        read_orbax(dst)


def test_orbax_reader_on_the_unstored_leaves(tmp_path):
    """A state without an EMA (None) and an empty optimizer state ({}):
    orbax stores neither, and the reader gives both back as orbax's restore
    and read_msgpack do; a leaf of another unstored type is refused."""
    import orbax.checkpoint as ocp

    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "ema_params": None, "opt_state": {}}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "a.orbax"), tree)
    ckptr.save(str(tmp_path / "b.orbax"), {**tree, "t": ()})
    ckptr.wait_until_finished()
    got = read_orbax(str(tmp_path / "a.orbax"))
    assert got["ema_params"] is None and got["opt_state"] == {}
    assert _leaves_equal(got, msgpack_restore(bytearray(serialization.msgpack_serialize(tree))), ordered=False) == 1
    with pytest.raises(ValueError, match="'Tuple' is not stored"):
        read_orbax(str(tmp_path / "b.orbax"))


def test_ocdbt_reader_on_a_multi_level_tree_and_zstd(tmp_path):
    """tensorstore's OCDBT store with small nodes (a B-tree several levels
    deep, keys stored under their subtree's prefix), values inline and in
    data files: every key and value as tensorstore reads them. pyarrow's
    zstd round-trips a frame whose size the header states."""
    import pyarrow as pa
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
                                     "compression": {"id": "zstd", "level": 5}}}).result()
    want = {f"key{i:04d}/x": (b"v%d" % i) * (1 + i % 20) for i in range(200)}
    for k, v in want.items():
        kv.write(k, v).result()
    store = OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(want)
    assert all(store[k] == v for k, v in want.items())
    payload = np.random.default_rng(0).standard_normal(5000).astype(np.float32).tobytes()
    frame = pa.Codec("zstd").compress(payload, asbytes=True)
    assert zstd_decompress(frame) == payload


def test_chip_smoke_writer_is_the_jax_layout(tmp_path):
    """chip_smoke.write_flax_checkpoint (the card has no JAX to write one):
    the JAX package's restore_checkpoint takes its file into a JAX
    TrainState template (the same optimizer-state structure, step and
    count), with the port state's weights bit for bit, bf16 BERT body
    included; the port's reader and the bridge give them back too."""
    import chip_smoke

    jcfg = jc.apply_overrides(jc.Config(), {**BASE, **PATHS["bf16_pp"][1], "train.pipeline_parallel": False})
    tcfg = tc.apply_overrides(tc.Config(), {**BASE, **PATHS["bf16_pp"][1], "train.pipeline_parallel": False})
    model = build_model(tcfg, device="cpu", train=True)
    state = create_train_state(tcfg, model)
    batch = tiny_batch(n=4, seed=1, missing_rate=0.25)
    assert make_train_step(tcfg, model)(state, torch_batch(batch), None, STEP_LR, STEP_LR).grad_finite
    chip_smoke.write_flax_checkpoint(str(tmp_path), "last", state, tcfg, {"thresholds": [0.4]})
    jmodel = jbuild_model(jcfg, "capsule")
    template = compiled(lambda v: jcreate_train_state(jcfg, jmodel, v),
                        seeded_variables(jmodel, jax.tree_util.tree_map(jnp.asarray, batch), 0))
    restored = jrestore_checkpoint(str(tmp_path), template, name="last")
    assert jax.tree_util.tree_structure(restored.opt_state) == jax.tree_util.tree_structure(template.opt_state)
    assert int(restored.step) == 1 and int(restored.opt_state.inner_states["train"].inner_state[1].count) == 1
    want = model.state_dict()
    got = state_dict_from_jax({"params": to_numpy(restored.params), "batch_stats": to_numpy(restored.batch_stats)},
                              model)
    assert want["encoders.bbert.bert.layer_0.intermediate.weight"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert load_config(str(tmp_path), "last") == tcfg
    os.remove(tmp_path / "last.msgpack")


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue().splitlines()


def test_cli_reads_a_jax_pair(runs, tmp_path):
    """eval --ckpt DIR --name final on the JAX pair, then train --resume DIR
    (its last checkpoint: the same pair under the name last): the resume
    continues the step counter from the JAX state's step."""
    run = runs["fp32"]
    lines = _cli(["eval", "--ckpt", run.dir, "--name", "final", "--out", str(tmp_path), "--device", "cpu"])
    metrics = json.loads("\n".join(lines[lines.index("{"): lines.index("}") + 1]))
    assert metrics["temperature"] == 1.25 and np.isfinite(metrics["auroc"])
    for ext in (".msgpack", ".meta.json"):
        os.symlink(os.path.join(run.dir, "final" + ext), tmp_path / ("last" + ext))
    sets = []
    for k, v in {**BASE, "train.min_epochs": 0, "train.ckpt_every": 0}.items():
        sets += ["--set", f"{k}={v}"]
    out = str(tmp_path / "resumed")
    lines = _cli(["train", "--resume", str(tmp_path), "--epochs", "1", "--out", out, "--device", "cpu", *sets])
    assert f"[resume] {tmp_path}/last at step 1" in lines
    assert load_meta(out, "final")["step"] == 1 + 8 // 4
    shutil.rmtree(out)
