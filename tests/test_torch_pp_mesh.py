"""The GPipe schedule and microbatching on the port's process mesh
(``parallel/pp.py:pipeline_apply``, the 'model' axis's ``pipeline`` role,
``parallel/mesh.py:shard_batch``'s microbatch layout) on the CPU: ranks as
subprocesses over gloo (``tests/torch_pp_ranks.py``, which imports no JAX),
a world of two (data=1, model=2) and one of four (data=2, model=2), started
together while the parent compiles the JAX references. The counterparts of
the JAX package's tests/test_pp.py on the mesh:

- ``pipeline_apply``'s forward at n_micro 1, 2 and 4, and 9 chunks on the
  data shards, against the JAX package's ``pipeline_apply`` on a 2 x 2
  device mesh and the port's sequential stack, at 1e-5 (tests/test_pp.py's
  limit); each stage runs its layers once a microbatch (the bubble ticks
  skipped); the gradients through the schedule, of the stacked leaves and
  of the chunks, against JAX's at a relative 1e-4 per leaf, ``k_bias``'s
  below 1e-5; ``model.remat`` in the schedule changes no number;
- the tiny fine-tuned flagship's step under ``train.pipeline_parallel``
  against the JAX single-device global-batch step of the pipeline-layout
  config (the loss, Adam's first moment per leaf), each rank holding its
  stage's slice, the replicated parameters bit-identical across ranks;
  planted faults caught: the pipeline's input without Megatron's *f*, and
  the stage-sharded leaves averaged over the world;
- ``train.microbatch=2`` on data=2 under the chunks role and under tensor
  parallelism against the JAX step with ``train.microbatch=2`` on the
  global batch (the BatchNorm statistics kept are the last global
  microbatch's); local-block microbatches caught;
- ``train_model`` under the pipeline role against one process, a pipeline
  mesh checkpoint resumed in one process and a one-process checkpoint
  loaded onto the pipeline mesh; ``cli train --mesh`` under the pipeline
  role and with microbatching under the route and tensor roles, each
  checkpoint served by ``cli eval`` in one process;
- in one process: the spec, the role's chunk axis, the microbatch rows, the
  refusals.
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
from multimodalrouting_tpu.parallel import pp as jpp
from multimodalrouting_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import train_state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import restore_train_state
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel import mesh as pmesh
from multimodalrouting_tpu_torch.parallel.pp import micro_count, pp_spec_for_name
from multimodalrouting_tpu_torch.train import loop as tloop
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict
from tests import torch_mesh_ranks as mr
from tests import torch_pp_ranks as ranks
from tests.test_torch_cli import _sets
from tests.test_torch_mesh import LOOP_TOL, rank_env, wait_all
from tests.test_torch_mesh import assert_leaves as assert_layered_leaves
from tests.test_torch_tp_ep import jax_case, jax_global_step
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    RTOL,
    assert_close,
    compiled,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
SCHEDULE_TOL = 1e-5  # tests/test_pp.py's forward limit
GRAD_TOL = 1e-4  # its gradients', relative to each leaf's largest
FAULTS = ("missing_f", "world_average")


def spawn(argv):
    import subprocess

    return subprocess.Popen(argv, cwd=ROOT, env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def jax_schedule() -> dict:
    """The JAX package's pipeline_apply on a data=2, model=2 device mesh at
    every case of the ranks' schedule, and its gradients, as one program."""
    mesh = jmake_mesh(n_data=2, n_model=2)
    cases = {name: ranks.schedule_case(seed, n) for name, (seed, n, _) in
             {**ranks.FORWARDS, "grad": ranks.GRAD, "remat": ranks.REMAT}.items()}
    micro = {**{name: k for name, (_, _, k) in ranks.FORWARDS.items()}, "grad": ranks.GRAD[2],
             "remat": ranks.REMAT[2]}

    def run(cases):
        def apply(w, x, c, name):
            return jpp.pipeline_apply(w, x, c["mask"], mesh=mesh, n_micro=micro[name], heads=ranks.HEADS,
                                      dtype=jnp.float32)

        out = {name: apply(c["w"], c["x"], c, name) for name, c in cases.items() if name in ranks.FORWARDS}
        for name in ("grad", "remat"):
            c = cases[name]

            def loss(w, x, c=c, name=name):
                return jnp.sum(jnp.tanh(apply(w, x, c, name) @ c["r"]) ** 2)

            value, (g_w, g_x) = jax.value_and_grad(loss, argnums=(0, 1))(c["w"], c["x"])
            out[name] = {"loss": value, "grads": g_w, "grad_x": g_x}
        return out

    return jax.tree_util.tree_map(np.asarray, compiled(run, jax.tree_util.tree_map(jnp.asarray, cases)))


def one_process_loop(epochs: int, ckpt_dir=None):
    """train_model of the ranks' PP_LOOP config in one process: the
    pipeline layout's sequential loop (torch's seeded init)."""
    cfg = ranks.cfg_of(ranks.PP_LOOP, **{"train.epochs": epochs, "train.num_model_shards": 1})
    torch.manual_seed(0)
    tr, va = mr.loop_cohorts()
    return tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tr, va, log_fn=lambda _: None,
                             ckpt_dir=ckpt_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' scenarios; meanwhile the parent writes the one-process
    checkpoint the world of two loads, compiles the JAX references and
    trains the one-process reference."""
    work = tmp_path_factory.mktemp("pp_mesh")
    pipe = jax_case(ranks.PP_STEP, mr.step_batch())
    pipe_mb = jax_case(ranks.PP_MB_STEP, mr.step_batch())
    micro = jax_case(ranks.MB_STEP, mr.step_batch())
    for name, (_, _, variables) in (("variables_pp", pipe), ("variables_mb", micro)):
        with open(work / f"{name}.pkl", "wb") as f:
            pickle.dump(variables, f)
    with open(work / "cli_sets.json", "w") as f:
        json.dump(_sets(**{"train.ckpt_every": 0}), f)
    procs = []
    for i, world in enumerate(WORLDS):
        port = str(mr.free_port(skip=i))
        procs += [spawn([sys.executable, "-m", "tests.torch_pp_ranks", str(r), str(world), port, str(work)])
                  for r in range(world)]
    try:
        out = {"work": work}
        one_process_loop(1, ckpt_dir=str(work / "one_process_tmp"))
        os.rename(work / "one_process_tmp", work / "one_process")
        out["jax_schedule"] = jax_schedule()
        out["jax_pp"] = jax_global_step(*pipe, mr.step_batch())
        out["jax_mb"] = jax_global_step(*micro, mr.step_batch())
        out["jax_pp_mb"] = jax_global_step(*pipe_mb[:2], pipe[2], mr.step_batch())  # the ranks' variables
        out["one_loop"] = one_process_loop(2)
    finally:
        wait_all(procs)
    for f in os.listdir(work):
        if f.endswith(".pt"):
            out[f[:-3]] = torch.load(work / f, weights_only=False)
    return out


def jax_reference(runs, key: str, base: dict) -> dict:
    return train_state_dict_from_jax(runs[key]["state"], build_model(ranks.cfg_of(base), device="cpu"))


# the stacked attention key biases: softmax is invariant to them, so their
# gradient is rounding noise (tests/test_torch_mesh.py's NOISE_ONLY, in the
# pipeline layout)
PP_NOISE_ONLY = "pp_layers.k_bias"


def assert_leaves(got, ref, tol, what="", noise_abs=None):
    """tests/test_torch_mesh.py's assert_leaves with the stacked key biases
    among the noise-only leaves."""
    noise = [k for k in ref if k.endswith(PP_NOISE_ONLY)]
    assert_layered_leaves({k: v for k, v in got.items() if k not in noise},
                          {k: v for k, v in ref.items() if k not in noise}, tol, what, noise_abs)
    if noise_abs is not None:
        for k in noise:
            assert float((got[k].float() - ref[k].float()).abs().max()) <= noise_abs, (what, k)


def rel_max(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


# --- the schedule -------------------------------------------------------------


@pytest.mark.parametrize("case", list(ranks.FORWARDS))
@pytest.mark.parametrize("world", WORLDS)
def test_the_schedule_s_forward_matches_jax_and_the_sequential_stack(runs, world, case):
    """tests/test_pp.py's forwards on the mesh: n_micro 1, 2 and 4 over 16
    chunks, and 9 chunks padded to split over the data shards, against the
    JAX package's schedule and the port's sequential stack, every rank
    holding the same output. Each stage runs its 2 layers once a
    microbatch: the bubble ticks are skipped."""
    seed, n, k = ranks.FORWARDS[case]
    ref = runs["jax_schedule"][case]
    n_data = world // 2
    m = micro_count(-(-n // n_data), k)
    for r in range(world):
        got = runs[f"schedule.w{world}.rank{r}"][case]
        assert got["out"].shape == ref.shape == (n, ranks.SEQ, ranks.HID)
        assert_close(got["out"], ref, rtol=SCHEDULE_TOL, atol=SCHEDULE_TOL, err_msg=f"rank {r} against JAX")
        assert_close(got["out"], got["scan"].numpy(), rtol=SCHEDULE_TOL, atol=SCHEDULE_TOL, err_msg=f"rank {r}")
        assert got["layer_calls"] == m * ranks.L_LAYERS // 2, (r, got["layer_calls"], m)


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_through_the_schedule_match_jax(runs, world):
    """tests/test_pp.py's gradient test: d loss / d leaves through the port's
    schedule against through JAX's, per leaf relative to its largest
    element; k_bias's gradient is exactly zero (softmax is invariant to a
    shift of the keys), so both sides give noise below 1e-5. The chunks'
    gradient too, on every rank: Megatron's *f* hands each stage the whole
    of it, which only stage 0 computes."""
    ref = runs["jax_schedule"]["grad"]
    for r in range(world):
        got = runs[f"schedule.w{world}.rank{r}"]["grad"]
        assert got["loss"] == pytest.approx(float(ref["loss"]), rel=1e-5)
        for name, g in got["grads"].items():
            if name == "k_bias":
                assert float(g.abs().max()) < 1e-5
                continue
            assert rel_max(g.numpy(), ref["grads"][name]) < GRAD_TOL, (r, name)
        assert rel_max(got["grad_x"].numpy(), ref["grad_x"]) < GRAD_TOL, r


@pytest.mark.parametrize("world", WORLDS)
def test_remat_in_the_schedule_changes_no_number(runs, world):
    """tests/test_pp.py:test_remat_scan_matches_plain on the mesh: each
    stage's layers recomputed in the backward give the plain schedule's loss
    and gradients, and JAX's."""
    ref = runs["jax_schedule"]["remat"]
    for r in range(world):
        plain, remat = (runs[f"schedule.w{world}.rank{r}"][k] for k in ("plain", "remat"))
        assert remat["loss"] == pytest.approx(plain["loss"], rel=1e-6)
        for name, g in remat["grads"].items():
            np.testing.assert_allclose(g.numpy(), plain["grads"][name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
            if name != "k_bias":
                assert rel_max(g.numpy(), ref["grads"][name]) < GRAD_TOL, (r, name)
        assert remat["loss"] == pytest.approx(float(ref["loss"]), rel=1e-5)


# --- the flagship's step under the pipeline role --------------------------------


def assert_matches_jax(got: dict, j: dict, ref: dict, what: str):
    assert got["finite"] and got["step"] == 1 and got.get("placed_ok", True), what
    assert_close(got["loss"], j["loss"], err_msg=what)
    assert_close(got["reg"], j["reg"], err_msg=what)
    assert sorted(got["mu"]) == sorted(ref["mu"])
    assert_leaves(got["mu"], ref["mu"], RTOL, f"{what}: Adam's first moment")


@pytest.mark.parametrize("world", WORLDS)
def test_the_pipeline_step_matches_the_jax_global_batch_step(runs, world):
    """The fine-tuned flagship's step with its BERT layers as two stages,
    against the JAX global-batch step of the pipeline-layout config; each
    rank holds its stage's slice of every stacked leaf (placed as the bridge
    slices the JAX variables, half the bytes), and the replicated
    parameters are bit-identical across ranks."""
    ref = jax_reference(runs, "jax_pp", ranks.PP_STEP)
    rs = [runs[f"pp_step.w{world}.rank{r}"] for r in range(world)]
    assert_matches_jax(rs[0], runs["jax_pp"], ref, f"pipeline world {world}")
    n_stage = ranks.PP_STEP["encoder.bert_layers"] // 2
    for r, got in enumerate(rs):
        assert got["finite"] and got["placed_ok"] and got["loss"] == rs[0]["loss"], r
        assert (got["model_sha"], got["mu_sha"], got["replicated_sha"]) == (
            rs[0]["model_sha"], rs[0]["mu_sha"], rs[0]["replicated_sha"]), r
        assert len(got["sharded"]) == 16 and all(".bert.pp_layers." in n for n in got["sharded"])
        assert all(shape[0] == n_stage for shape in got["local_shapes"].values()), got["local_shapes"]
        assert got["sharded_bytes"] * 2 == got["sharded_bytes_whole"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("world", WORLDS)
def test_a_planted_pipeline_fault_is_caught(runs, world, fault):
    """Without *f* on the pipeline's input only stage 0's rank gets the
    embedded chunks' gradient, and the world average leaves the embedding
    tables M times too small; with the stage-sharded leaves averaged over
    the world, each stage's gradient is mixed with the other's. Adam's first
    moment leaves the tolerance the real step holds."""
    got = runs[f"fault_{fault}.w{world}.rank0"]
    ref = jax_reference(runs, "jax_pp", ranks.PP_STEP)["mu"]
    with pytest.raises(AssertionError):
        assert_leaves(got["mu"], ref, RTOL, fault)
    if fault == "missing_f":  # against a leaf downstream of BERT, as the clip scales both alike
        emb, proj = "encoders.bbert.bert.word_embeddings.weight", "encoders.bbert.proj.weight"

        def share(mu):
            return float(mu[emb].norm() / mu[proj].norm())

        assert share(ref) / share(got["mu"]) == pytest.approx(2.0, rel=1e-3)


# --- microbatching on a data mesh ----------------------------------------------------


MB_CASES = [(2, "chunks"), (4, "chunks"), (4, "tensor"), (4, "pipeline")]


@pytest.mark.parametrize("world, role", MB_CASES)
def test_microbatching_on_a_data_mesh_matches_the_jax_microbatch_step(runs, world, role):
    """train.microbatch=2 on data=2 (world 2: model=1; world 4: model=2
    with the chunks sharded, the BERT layers under tensor parallelism, or
    the GPipe schedule inside each step microbatch) against the JAX step
    with train.microbatch=2 on the global batch of 8 (of the pipeline-layout
    config under the pipeline role): each rank's local microbatch i is its
    half of the global microbatch i, so the BatchNorm statistics kept are
    the last global microbatch's."""
    key, base = ("jax_pp_mb", ranks.PP_MB_STEP) if role == "pipeline" else ("jax_mb", ranks.MB_STEP)
    ref = jax_reference(runs, key, base)
    got = runs[f"mb_{role}.w{world}.rank0"]
    assert got["rows"] == 4
    assert_matches_jax(got, runs[key], ref, f"microbatch {role} world {world}")
    stats = [k for k in ref["model"] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert_close(got["model"][k], ref["model"][k].numpy(), err_msg=k)
    shas = {runs[f"mb_{role}.w{world}.rank{r}"]["model_sha"] for r in range(world)}
    assert len(shas) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_local_block_microbatches_are_caught(runs, world):
    """The same step with each rank's contiguous block of rows cut into the
    microbatches: the microbatches are other rows of the global batch, and
    the BatchNorm statistics and loss leave the JAX step's tolerance."""
    got = runs[f"fault_local_block.w{world}.rank0"]
    ref = jax_reference(runs, "jax_mb", ranks.MB_STEP)["model"]
    with pytest.raises(AssertionError):
        assert_close(got["loss"], runs["jax_mb"]["loss"])
    with pytest.raises(AssertionError):
        for k in (k for k in ref if k.endswith("running_mean")):
            assert_close(got["model"][k], ref[k].numpy(), err_msg=k)


# --- the loop, checkpoints, the CLI ------------------------------------------------


def test_train_model_under_the_pipeline_role_matches_one_process(runs):
    got, ref = runs["pp_loop.w2.rank0"], runs["one_loop"]
    assert any(line.startswith("[pp] stage 0 of 2: BERT layers [0, 1) of 2") for line in got["logs"])
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in ref.history], rtol=LOOP_TOL)
    np.testing.assert_allclose([h["val_auroc"] for h in got["history"]], [h["val_auroc"] for h in ref.history])
    noise = 2 * len(ref.history) * tc.Config().train.lr
    assert_leaves(got["model"], ref.state.model.state_dict(), LOOP_TOL, "PP params", noise_abs=noise)
    assert_leaves(got["serving"], serving_state_dict(ref.state), LOOP_TOL, "PP EMA", noise_abs=noise)
    assert got["model_sha"] == runs["pp_loop.w2.rank1"]["model_sha"]


def test_a_pipeline_checkpoint_resumes_in_one_process(runs):
    """One epoch on the pipeline mesh, its checkpoint (whole stacked
    leaves, written by rank 0) resumed for the second epoch in one process,
    against the mesh's two epochs without a break."""
    ckpt = runs["work"] / "pp_ckpt"
    assert sorted(p.name for p in ckpt.iterdir() if p.is_dir()) == ["final"]
    cfg = ranks.cfg_of(ranks.PP_LOOP, **{"train.num_model_shards": 1})
    model = build_model(cfg, device="cpu", train=True)
    state = restore_train_state(str(ckpt), create_train_state(cfg, model), name="final")
    assert state.step == 2 and model.state_dict()["encoders.bbert.bert.pp_layers.q_kernel"].shape[0] == 2
    tr, va = mr.loop_cohorts()
    res = tloop.train_model(cfg, model, tr, va, state=state, log_fn=lambda _: None)
    mesh = runs["pp_loop.w2.rank0"]
    np.testing.assert_allclose([h["train_loss"] for h in res.history], [mesh["history"][1]["train_loss"]],
                               rtol=LOOP_TOL)
    assert_leaves(mesh["model"], model.state_dict(), LOOP_TOL, "resumed params", noise_abs=4 * cfg.train.lr)


def test_a_one_process_checkpoint_loads_onto_the_pipeline_mesh(runs):
    got, ref = runs["pp_from_one.w2.rank0"], runs["one_loop"]
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]], [ref.history[1]["train_loss"]],
                               rtol=LOOP_TOL)
    assert_leaves(got["model"], ref.state.model.state_dict(), LOOP_TOL, "params", noise_abs=4 * tc.Config().train.lr)


@pytest.mark.parametrize("case", list(ranks.CLI_CASES))
def test_cli_train_on_a_mesh_then_eval_in_one_process(runs, case):
    """The three `cli train --mesh` configurations the port refused before
    the GPipe schedule and microbatching on a mesh ran: each trains one
    epoch on its ranks, and `cli eval` serves the checkpoint in one
    process."""
    world = ranks.CLI_CASES[case][0]
    outs = [runs[f"cli_{case}.w{world}.rank{r}"] for r in range(world)]
    assert all(o["rc"] == 0 for o in outs), [o["stdout"][-2000:] for o in outs]
    if case == "pipeline":
        for r, o in enumerate(outs):
            assert f"[pp] stage {r} of 2: BERT layers [{r}, {r + 1}) of 2" in o["stdout"]
    out = runs["work"] / f"cli_{case}"
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == ["final"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["eval", "--ckpt", str(out), "--device", "cpu"]) == 0
    assert '"auroc"' in buf.getvalue()
    shutil.rmtree(out)  # ~0.2 GB of train state


# --- in one process -----------------------------------------------------------


def test_pp_spec_shards_the_stacked_layers_only():
    """The JAX package's pp_spec_for_path on the port's names: dimension 0
    (the layer axis) of the 16 stacked leaves, nothing else; the same count
    as the JAX package's specs on its paths."""
    names = list(build_model(ranks.cfg_of(ranks.PP_STEP), device="cpu").state_dict())
    sharded = [n for n in names if pp_spec_for_name(n) is not None]
    assert len(sharded) == 16 and all(n.startswith("encoders.bbert.bert.pp_layers.") for n in sharded)
    assert {pp_spec_for_name(n) for n in sharded} == {0}
    jcfg = jc.apply_overrides(jc.Config(), ranks.PP_STEP)
    shapes = jax.eval_shape(lambda b: jbuild_model(jcfg, "capsule").init(jax.random.PRNGKey(0), b, train=False),
                            jax.tree_util.tree_map(jnp.asarray, mr.step_batch()))["params"]
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert sum(jpp.pp_spec_for_path(p) != jax.sharding.PartitionSpec() for p in paths) == len(sharded)


def test_the_pipeline_role_takes_the_chunk_axis_off_model():
    """Under train.pipeline_parallel the mesh's role is the pipeline, and
    the chunks take 'data' only (the JAX package's clinbert.py:318-322)."""
    cfg = ranks.cfg_of(ranks.PP_STEP, **{"train.num_model_shards": 2})
    assert pmesh.mesh_role(cfg) == "pipeline"
    assert not pmesh.chunk_sharding(pmesh.Mesh(1, 2, role="pipeline"))
    assert pmesh.chunk_sharding(pmesh.Mesh(1, 2, role="chunks"))


@pytest.mark.parametrize("n, n_data, k", [(8, 2, 2), (16, 2, 4), (12, 3, 2), (10, 2, 4)])
def test_microbatch_rows_are_each_microbatch_s_slice(n, n_data, k):
    """shard_batch under train.microbatch=k: the step's local microbatch i
    (rows [i·mb/N, (i+1)·mb/N) of the local batch) is the d-th of the N
    slices of the JAX step's microbatch i (rows [i·mb, (i+1)·mb) of the
    global batch, the rows past k·mb unused); without microbatching the
    contiguous block."""
    batch = make_synthetic_cohort(n, t=8, f=2, s=1, l=8, image_size=8, vocab_size=16, seed=0)
    batch = batch._replace(y=np.arange(n, dtype=np.float32))
    mb = n // k
    per = mb // n_data
    for d in range(n_data):
        mesh = pmesh.Mesh(n_data, 1, rank=d)
        local = pmesh.shard_batch(batch, mesh, k)
        assert local.batch_size == k * per
        for i in range(k):
            want = np.arange(i * mb, (i + 1) * mb)[d * per : (d + 1) * per]
            np.testing.assert_array_equal(np.asarray(local.y)[i * per : (i + 1) * per], want)
        if n % n_data == 0:
            np.testing.assert_array_equal(np.asarray(pmesh.shard_batch(batch, mesh).y),
                                          np.arange(n)[d * (n // n_data) : (d + 1) * (n // n_data)])


def test_a_microbatch_that_does_not_split_over_the_data_shards_raises():
    """A microbatch of 3 rows on 2 data shards: the JAX step reshards it,
    the port refuses, in shard_batch and in train_model's checks before any
    mesh is set."""
    batch = make_synthetic_cohort(6, t=8, f=2, s=1, l=8, image_size=8, vocab_size=16, seed=0)
    with pytest.raises(ValueError, match="do not split over 2 data shards"):
        pmesh.shard_batch(batch, pmesh.Mesh(2, 1), 2)
    cfg = ranks.cfg_of(mr.LOOP, **{"train.batch_size": 6, "train.microbatch": 2, "train.num_data_shards": 2})
    with pytest.raises(ValueError, match="train.microbatch=2 cuts train.batch_size=6 into microbatches of 3 rows"):
        tloop.validate_mesh_config(cfg)


@pytest.mark.parametrize("n, k, m", [(16, 4, 4), (9, 4, 3), (5, 4, 1), (8, 2, 2), (3, 8, 3), (96, 2, 2)])
def test_micro_count_is_the_jax_rule(n, k, m):
    """pipeline_apply's microbatches: n_micro at most, lowered until it
    divides the data shard's chunks (multimodalrouting_tpu/parallel/pp.py:231-234)."""
    assert micro_count(n, k) == m


def test_the_text_cache_under_the_pipeline_role_on_a_mesh_raises():
    """The JAX package's cache encoder cannot read the stacked layers (flax
    raises); on the pipeline mesh each stage holds a slice of them: the
    port refuses before any mesh is set."""
    cfg = ranks.cfg_of(mr.LOOP, **{"train.pipeline_parallel": True, "train.num_model_shards": 2,
                                   "encoder.text_embedding_cache": True})
    with pytest.raises(ValueError, match="text_embedding_cache does not run under train.pipeline_parallel"):
        tloop.validate_mesh_config(cfg)
    assert pmesh.get_active_mesh() is None
