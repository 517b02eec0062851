"""Tensor and route parallelism on the port's process mesh
(``parallel/tp.py``, ``parallel/ep.py``, ``parallel/mesh.py``'s roles and
placement) on the CPU: ranks as subprocesses over gloo
(``tests/torch_tp_ep_ranks.py``, which imports no JAX), a world of two
(data=1, model=2) and one of four (data=2, model=2), started together while
the parent compiles the JAX references.

- the tiny fine-tuned flagship's step under ``train.tensor_parallel`` and
  under ``train.route_parallel``, and the per-route MulT family's under
  route parallelism, against the JAX package's single-device global-batch
  step (GSPMD makes the mesh step value-identical to it; the JAX package's
  own `slow` tests/test_tp.py and tests/test_ep.py pin that): the loss at
  2e-4 / 2e-5, Adam's first moment (the clipped gradient) per leaf in
  relative norm, at both worlds; each rank's state placed as the bridge
  slices the same variables; each rank's BERT (or stream) parameter bytes
  half of the whole;
- planted faults that the comparison catches: the sharded slices averaged
  over the world, and a clip norm that counts each rank's slice alone (the
  clip binds at ``train.grad_clip=0.05``);
- TP + ZeRO-1 on data=2, model=2 against the replicated layout;
- a row-parallel int8 product against ``QuantDense`` on the whole tensors,
  bit for bit;
- ``train_model`` under TP against one process over 2 epochs, a TP mesh
  checkpoint resumed in one process, a one-process checkpoint and a JAX
  train state loaded onto the TP mesh;
- ``cli train --mesh data=1,model=2`` under each role, then ``cli eval`` of
  its checkpoint in one process;
- the spec functions on the port's parameter names, the JAX package's
  validations and messages, and the attention dispatch on a rank's local
  shape at 2 and 4 model shards.
"""
import contextlib
import io
import json
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.parallel.ep import ep_spec_for_path as jep_spec_for_path
from multimodalrouting_tpu.parallel.ep import validate_ep as jvalidate_ep
from multimodalrouting_tpu.parallel.tp import tp_spec_for_path as jtp_spec_for_path
from multimodalrouting_tpu.parallel.tp import validate_tp_divisibility as jvalidate_tp
from multimodalrouting_tpu.train.loop import note_pack_bucket as jnote_pack_bucket
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu.train.steps import make_train_step as jmake_train_step
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import train_state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import restore_train_state
from multimodalrouting_tpu_torch.models import attention as tattention
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops import flash, flash_packed
from multimodalrouting_tpu_torch.parallel import mesh as pmesh
from multimodalrouting_tpu_torch.parallel.ep import ep_spec_for_name
from multimodalrouting_tpu_torch.parallel.tp import local_attention_branch, tp_spec_for_name
from multimodalrouting_tpu_torch.train import loop as tloop
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict
from tests import torch_mesh_ranks as mr
from tests import torch_tp_ep_ranks as ranks
from tests.test_torch_cli import _sets
from tests.test_torch_mesh import LOOP_TOL, assert_leaves, rank_env, wait_all
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    O0,
    RTOL,
    assert_close,
    compiled,
    one_torch_thread,
    seeded_variables,
    to_numpy,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
CLI_ROLES = ("tensor", "route")


def bn_at_init(variables):
    """BatchNorm scale 1 and bias 0 (tests/test_torch_mesh.py's jax_setup:
    seeded BN biases make the tiny ResNet's gradient depend on row order)."""
    def at_init(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        if any("bn" in k for k in keys[:-1]) and keys[-1] in ("scale", "bias"):
            return np.full_like(x, 1.0 if keys[-1] == "scale" else 0.0)
        return x

    return jax.tree_util.tree_map_with_path(at_init, variables)


def jax_case(over: dict, batch):
    """(config, model, seeded variables) of the JAX package at `over`."""
    jcfg = jc.apply_overrides(jc.Config(), over)
    jmodel = jbuild_model(jcfg, "capsule")
    return jcfg, jmodel, bn_at_init(seeded_variables(jmodel, batch, seed=5))


def jax_global_step(jcfg, jmodel, variables, batch) -> dict:
    """The JAX single-device step on the global batch -> loss, reg and the
    state after it (numpy)."""
    state = compiled(lambda v: jcreate_train_state(jcfg, jmodel, v), variables)
    step = jmake_train_step(jcfg, jmodel, "capsule")
    args = (state, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0),
            jnp.asarray(mr.STEP_LR), jnp.asarray(mr.STEP_LR / 2))
    new_state, metrics = step.lower(*args, note_pack=jnote_pack_bucket(jcfg, batch)).compile(
        compiler_options=O0)(*args)
    return {"loss": float(metrics.loss), "reg": float(metrics.reg_loss), "state": to_numpy({
        "params": new_state.params, "batch_stats": new_state.batch_stats, "ema_params": new_state.ema_params,
        "opt_state": new_state.opt_state, "step": new_state.step})}


def spawn(argv):
    import subprocess

    return subprocess.Popen(argv, cwd=ROOT, env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def one_process_loop(epochs: int, ckpt_dir=None):
    """train_model of the ranks' TP_LOOP config in one process (torch's
    seeded init)."""
    cfg = ranks.cfg_of(ranks.TP_LOOP, **{"train.epochs": epochs, "train.tensor_parallel": False,
                                         "train.num_model_shards": 1})
    torch.manual_seed(0)
    tr, va = mr.loop_cohorts()
    return tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tr, va, log_fn=lambda _: None,
                             ckpt_dir=ckpt_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' scenarios; meanwhile the parent writes the one-process
    checkpoint the ranks load, compiles the JAX global-batch steps and
    trains the one-process references."""
    work = tmp_path_factory.mktemp("tp_ep")
    flagship = jax_case(ranks.TP_EP, mr.step_batch())
    mult = jax_case(ranks.MULT, ranks.pheno_batch())
    for name, (_, _, variables) in (("variables", flagship), ("variables_mult", mult)):
        with open(work / f"{name}.pkl", "wb") as f:
            pickle.dump(variables, f)
    with open(work / "cli_sets.json", "w") as f:
        json.dump(_sets(**{"train.ckpt_every": 0}), f)
    procs = []
    for i, world in enumerate(WORLDS):
        port = str(mr.free_port(skip=i))
        procs += [spawn([sys.executable, "-m", "tests.torch_tp_ep_ranks", str(r), str(world), port, str(work)])
                  for r in range(world)]
    try:
        out = {"work": work}
        # the one-process checkpoint the world of two loads onto its TP mesh
        one_process_loop(1, ckpt_dir=str(work / "one_process_tmp"))
        os.rename(work / "one_process_tmp", work / "one_process")
        out["jax"] = jax_global_step(*flagship, mr.step_batch())
        with open(work / "jax_state.tmp", "wb") as f:
            pickle.dump(out["jax"]["state"], f)
        os.rename(work / "jax_state.tmp", work / "jax_state.pkl")
        out["jax_mult"] = jax_global_step(*mult, ranks.pheno_batch())
        out["one_loop"] = one_process_loop(2)
    finally:
        wait_all(procs)
    for f in os.listdir(work):
        if f.endswith(".pt"):
            out[f[:-3]] = torch.load(work / f, weights_only=False)
    return out


def jax_reference(runs, key: str, base: dict) -> dict:
    return train_state_dict_from_jax(runs[key]["state"], build_model(ranks.cfg_of(base), device="cpu"))


def assert_matches_jax(got: dict, j: dict, ref: dict, what: str):
    assert got["finite"] and got["step"] == 1 and got["placed_ok"], what
    assert_close(got["loss"], j["loss"], err_msg=what)
    assert_close(got["reg"], j["reg"], err_msg=what)
    assert sorted(got["mu"]) == sorted(ref["mu"])
    assert_leaves(got["mu"], ref["mu"], RTOL, f"{what}: Adam's first moment")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("role", ["tensor", "route"])
def test_the_flagship_step_matches_the_jax_global_batch_step(runs, role, world):
    """The fine-tuned flagship's step under each role, against the JAX
    global-batch step; the ranks' whole parameters bit-identical; each
    rank holds half of the sharded parameters' bytes (the BERT layers' or
    the cross streams')."""
    ref = jax_reference(runs, "jax", ranks.TP_EP)
    rs = [runs[f"{role}_step.w{world}.rank{r}"] for r in range(world)]
    assert_matches_jax(rs[0], runs["jax"], ref, f"{role} world {world}")
    for r, got in enumerate(rs):
        assert got["finite"] and got["placed_ok"] and got["loss"] == rs[0]["loss"], (role, r)
        assert (got["model_sha"], got["mu_sha"]) == (rs[0]["model_sha"], rs[0]["mu_sha"]), (role, r)
    sharded = rs[0]["sharded"]
    assert sharded and all((".bert.layer_" if role == "tensor" else "mult.cross_streams.") in n for n in sharded)
    assert all(got["sharded_bytes"] * 2 == got["sharded_bytes_whole"] for got in rs)


def test_the_per_route_mult_family_under_route_parallelism_matches_jax(runs):
    """configs/pheno_atten_mult.yaml's family on data=1, model=2 under
    route parallelism: route_mult.directional split, the tri program
    replicated."""
    ref = jax_reference(runs, "jax_mult", ranks.MULT)
    got = runs["route_mult_step.w2.rank0"]
    assert_matches_jax(got, runs["jax_mult"], ref, "per-route MulT")
    assert got["sharded"] and all("route_mult.directional." in n for n in got["sharded"])
    assert got["model_sha"] == runs["route_mult_step.w2.rank1"]["model_sha"]


def global_norm(tensors: dict) -> float:
    return float(torch.linalg.vector_norm(torch.stack([v.float().norm() for v in tensors.values()])))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("role", ["tensor", "route"])
def test_the_clip_norm_counts_each_sharded_leaf_once(runs, role, world):
    """The global norm the step clips by is the norm of the whole averaged
    gradient (each sharded leaf's slices summed over the model group once);
    and the clip binds: the JAX reference's first moment is 0.1 times a
    gradient of norm grad_clip."""
    for r in range(world):
        got = runs[f"{role}_step.w{world}.rank{r}"]
        assert got["clip_norm"] == pytest.approx(got["grad_norm"], rel=1e-6)
    ref = jax_reference(runs, "jax", ranks.TP_EP)
    assert global_norm(ref["mu"]) / 0.1 == pytest.approx(ranks.TP_EP["train.grad_clip"], rel=1e-4)


@pytest.mark.parametrize("fault", ["world_average", "local_norm"])
def test_a_planted_fault_is_caught(runs, fault):
    """The TP step with the sharded slices averaged over the world: Adam's
    first moment leaves the tolerance the real step holds. With each rank's
    slices alone in the clip norm: the norm misses the whole gradient's."""
    got = runs[f"fault_{fault}.w2.rank0"]
    if fault == "world_average":
        with pytest.raises(AssertionError):
            assert_leaves(got["mu"], jax_reference(runs, "jax", ranks.TP_EP)["mu"], RTOL, fault)
    else:
        assert got["clip_norm"] < got["grad_norm"] * (1 - 1e-5)


def test_tensor_parallel_zero_matches_the_replicated_layout(runs):
    """TP with ZeRO-1 on data=2, model=2 after one step: the moments and
    parameters equal the replicated layout's to fp32 rounding, and the four
    ranks' whole parameters are bit-identical."""
    got, rep = runs["tensor_zero_step.w4.rank0"], runs["tensor_step.w4.rank0"]
    assert got["loss"] == rep["loss"]
    for part in ("mu", "model"):
        for k, v in rep[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9, err_msg=k)
    assert len({runs[f"tensor_zero_step.w4.rank{r}"]["model_sha"] for r in range(4)}) == 1


def test_fused_qkv_on_a_tensor_parallel_rank_is_the_unfused_step(runs):
    """MMR_FUSED_QKV=1 on data=1, model=2 under tensor parallelism: each
    rank projects its heads' q/k/v column slices as one product in every
    BERT layer (forward), and the step is the unfused one: the loss bit for
    bit, Adam's first moment (the clipped gradient) per leaf within
    LOOP_TOL in relative norm, summation order only (the fused product's
    backward runs one GEMM over the three projections: 7.5e-6 at worst
    here, in a q_proj weight; the key biases' gradients are rounding noise
    and left out, as in every mesh test), the ranks' parameters
    bit-identical to each other."""
    for r in range(2):
        got, ref = runs[f"tensor_fused_qkv_step.w2.rank{r}"], runs[f"tensor_step.w2.rank{r}"]
        assert got["fused_calls"] == ranks.TP_EP["encoder.bert_layers"], r
        assert got["finite"] and got["placed_ok"] and got["loss"] == ref["loss"], r
    assert runs["tensor_fused_qkv_step.w2.rank0"]["model_sha"] == runs["tensor_fused_qkv_step.w2.rank1"]["model_sha"]
    got, ref = runs["tensor_fused_qkv_step.w2.rank0"], runs["tensor_step.w2.rank0"]
    assert_leaves(got["mu"], ref["mu"], LOOP_TOL, "fused QKV: Adam's first moment")


def test_a_row_parallel_int8_product_is_quant_dense_s(runs):
    for r in range(2):
        got = runs[f"int8_row.w2.rank{r}"]
        assert torch.equal(got["got"], got["want"])


def test_train_model_under_tensor_parallelism_matches_one_process(runs):
    got, ref = runs["tp_loop.w2.rank0"], runs["one_loop"]
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in ref.history], rtol=LOOP_TOL)
    np.testing.assert_allclose([h["val_auroc"] for h in got["history"]], [h["val_auroc"] for h in ref.history])
    noise = 2 * len(ref.history) * tc.Config().train.lr
    assert_leaves(got["model"], ref.state.model.state_dict(), LOOP_TOL, "TP params", noise_abs=noise)
    assert_leaves(got["serving"], serving_state_dict(ref.state), LOOP_TOL, "TP EMA", noise_abs=noise)
    assert got["model_sha"] == runs["tp_loop.w2.rank1"]["model_sha"]


def test_a_tensor_parallel_checkpoint_resumes_in_one_process(runs):
    """One TP epoch on the mesh, its checkpoint (full tensors, written by
    rank 0) resumed for the second epoch in one process, against the mesh's
    two epochs without a break."""
    ckpt = runs["work"] / "tp_ckpt"
    assert sorted(p.name for p in ckpt.iterdir() if p.is_dir()) == ["final"]
    cfg = ranks.cfg_of(ranks.TP_LOOP, **{"train.tensor_parallel": False, "train.num_model_shards": 1})
    model = build_model(cfg, device="cpu", train=True)
    state = restore_train_state(str(ckpt), create_train_state(cfg, model), name="final")
    assert state.step == 2 and model.state_dict()["encoders.bbert.bert.layer_0.intermediate.weight"].shape[0] == 64
    tr, va = mr.loop_cohorts()
    res = tloop.train_model(cfg, model, tr, va, state=state, log_fn=lambda _: None)
    mesh = runs["tp_loop.w2.rank0"]
    np.testing.assert_allclose([h["train_loss"] for h in res.history], [mesh["history"][1]["train_loss"]],
                               rtol=LOOP_TOL)
    assert_leaves(mesh["model"], model.state_dict(), LOOP_TOL, "resumed params", noise_abs=4 * cfg.train.lr)


def test_a_one_process_checkpoint_loads_onto_a_tensor_parallel_mesh(runs):
    """The one-process run's first epoch, its checkpoint resumed on the TP
    mesh for the second, against the one-process run's two epochs; and a
    JAX train state loaded into TP slices."""
    got, ref = runs["tp_from_one.w2.rank0"], runs["one_loop"]
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]], [ref.history[1]["train_loss"]],
                               rtol=LOOP_TOL)
    assert_leaves(got["model"], ref.state.model.state_dict(), LOOP_TOL, "params", noise_abs=4 * tc.Config().train.lr)
    for r in range(2):
        j = runs[f"jax_state.w2.rank{r}"]
        assert j["ok"] and j["sharded"] > 0 and j["step"] == 1


@pytest.mark.parametrize("role", CLI_ROLES)
def test_cli_train_on_a_model_mesh_then_eval_in_one_process(runs, role):
    """`cli train --mesh data=1,model=2` under each role for one epoch in the
    world of two; `cli eval` serves its checkpoint in one process."""
    out = runs["work"] / f"cli_{role}"
    assert all(runs[f"cli_{role}.w2.rank{r}"]["rc"] == 0 for r in range(2))
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == ["final"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["eval", "--ckpt", str(out), "--device", "cpu"]) == 0
    assert '"auroc"' in buf.getvalue()
    shutil.rmtree(out)  # ~0.2 GB of train state


# --- in one process -----------------------------------------------------------


def _names(over: dict):
    return list(build_model(ranks.cfg_of(over), device="cpu").state_dict())


def _jax_paths(over: dict):
    jcfg = jc.apply_overrides(jc.Config(), over)
    shapes = jax.eval_shape(lambda b: jbuild_model(jcfg, "capsule").init(jax.random.PRNGKey(0), b, train=False),
                            jax.tree_util.tree_map(jnp.asarray, mr.step_batch()))["params"]
    return [path for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def test_tp_specs_follow_the_megatron_pattern_on_the_port_s_names():
    """tests/test_tp.py:46 on the port's names and [out, in] weights: every
    BERT layer's q/k/v/intermediate on dimension 0 (weight and bias),
    out_proj/output weights on dimension 1 and their biases replicated,
    everything else replicated; the same leaves as the JAX package's specs
    on its paths."""
    names = _names(ranks.TP_EP)
    spec = {n: tp_spec_for_name(n) for n in names}
    layers = ranks.TP_EP["encoder.bert_layers"]
    for i in range(layers):
        pre = f"encoders.bbert.bert.layer_{i}."
        for owner in ("attention.attn.q_proj", "attention.attn.k_proj", "attention.attn.v_proj", "intermediate"):
            assert spec[pre + owner + ".weight"] == 0 and spec[pre + owner + ".bias"] == 0
        for owner in ("attention.attn.out_proj", "output"):
            assert spec[pre + owner + ".weight"] == 1 and spec[pre + owner + ".bias"] is None
    sharded = sorted(n for n, d in spec.items() if d is not None)
    assert len(sharded) == 10 * layers and all(".bert.layer_" in n for n in sharded)
    jax_sharded = sorted(".".join(str(getattr(k, "key", k)) for k in path) for path in _jax_paths(ranks.TP_EP)
                         if jtp_spec_for_path(path) != jax.sharding.PartitionSpec())
    assert len(jax_sharded) == len(sharded)


@pytest.mark.parametrize("over, scope", [(ranks.TP_EP, "mult.cross_streams."),
                                         (ranks.MULT, "route_mult.directional.")], ids=["flagship", "per_route"])
def test_ep_specs_shard_the_six_stream_programs_only(over, scope):
    """tests/test_ep.py:47 and :76 on the port's names: every leaf of
    cross_streams (the flagship) or route_mult.directional (the per-route
    family) on its stream axis of 6, the tri program and everything else
    replicated; the same count as the JAX package's specs."""
    model = build_model(ranks.cfg_of(over), device="cpu")
    sd = model.state_dict()
    sharded = [n for n in sd if ep_spec_for_name(n) is not None]
    assert sharded and all(n.startswith(scope) and sd[n].shape[0] == 6 for n in sharded)
    assert all(ep_spec_for_name(n) is None for n in sd if ".LNI." in n)
    jax_sharded = [p for p in _jax_paths(over) if jep_spec_for_path(p) != jax.sharding.PartitionSpec()]
    assert len(jax_sharded) == len(sharded)


@pytest.mark.parametrize("over, match", [
    ({"train.tensor_parallel": True, "encoder.bert_heads": 3, "encoder.bert_hidden": 48,
      "encoder.bert_intermediate": 96, "train.num_model_shards": 2}, "bert_heads=3 divisible"),
    ({"train.route_parallel": True, "train.num_data_shards": 2}, "divisible by the model shards"),
    ({"train.route_parallel": True, "train.num_model_shards": 2, "model.routes": "7"}, "model.routes=10"),
    ({"train.route_parallel": True, "train.tensor_parallel": True, "train.num_model_shards": 2},
     "mutually exclusive"),
    ({"train.route_parallel": True, "train.num_model_shards": 4}, "use 2, 3 or 6"),
], ids=["tp_heads", "ep_one_model_shard", "ep_seven_routes", "ep_with_tp", "ep_four"])
def test_mesh_configs_get_the_jax_package_s_checks(over, match):
    """train_model refuses what the JAX package's validations refuse (in
    its loop's order), with their messages, before any mesh is set."""
    jcfg = jc.apply_overrides(jc.Config(), {**mr.LOOP, **over})
    with pytest.raises(ValueError, match=match) as jerr:
        if jcfg.train.tensor_parallel:
            jvalidate_tp(jcfg, jcfg.train.num_model_shards)
        jvalidate_ep(jcfg, jcfg.train.num_model_shards)
    cfg = ranks.cfg_of(mr.LOOP, **over)
    tr, va = mr.loop_cohorts()
    with pytest.raises(ValueError) as err:
        tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tr, va)
    assert str(err.value) == str(jerr.value)
    assert pmesh.get_active_mesh() is None


@pytest.mark.parametrize("n_model, heads, branch", [(2, 6, "packed"), (4, 3, "flash")], ids=["M2", "M4"])
def test_attention_dispatch_on_a_rank_s_local_shape(monkeypatch, n_model, heads, branch):
    """BERT-base's 12 heads of 64 at T = 256 split over `n_model` shards: the
    rank's local shape decides. At M = 2 (6 heads, d = 384) the packed
    gate holds (K1 / K2); at M = 4 (3 heads, d = 192) it fails on d % 128
    and the odd head count, and the shape takes K4a. On the CPU each
    branch's plain version computes the rank's heads of the whole
    attention."""
    monkeypatch.setenv("MMR_ATTN", "flash")
    t, hidden = 256, 768
    for frozen in (True, False):
        assert local_attention_branch(t, hidden, 12, n_model, frozen=frozen) == branch
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, t, hidden, generator=g) * 0.3 for _ in range(3))
    mask = torch.ones(2, t)
    mask[1, 200:] = 0
    whole = tattention.attention(q, k, v, mask, None, 12, frozen_fast_path=True, dtype=torch.float32)
    seen = []
    for name, module in (("packed", flash_packed), ("flash", flash)):
        fn = getattr(module, "packed_attention" if name == "packed" else "flash_self_attention")
        monkeypatch.setattr(module, fn.__name__, lambda *a, _fn=fn, _n=name: seen.append(_n) or _fn(*a))
    cols = slice(0, hidden // n_model)
    got = tattention.attention(q[..., cols], k[..., cols], v[..., cols], mask, None, heads, frozen_fast_path=True,
                               dtype=torch.float32)
    assert seen == [branch]
    np.testing.assert_allclose(got[:, :200].numpy(), whole[..., cols][:, :200].numpy(), rtol=1e-5, atol=1e-5)
