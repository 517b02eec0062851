"""The port's process mesh (``parallel/``: distributed.py, mesh.py, zero.py)
on the CPU: two ranks as subprocesses over gloo (``tests/torch_mesh_ranks.py``,
which imports no JAX), held against one process.

- one data=2 step of the tiny flagship against the JAX package's
  ``make_train_step`` on the global batch of 8: the loss and the committed
  BatchNorm statistics at 2e-4 / 2e-5 (tests/test_pallas.py's tolerance),
  the gradient, as Adam's first moment, at 2e-4 per leaf in relative norm.
  The JAX reference is the single-device step: GSPMD makes the 2-device
  mesh's step value-identical to it (the JAX package's own `slow`
  tests/test_zero.py and tests/test_multihost.py pin that), and it compiles
  in about half the time. The batch's halves differ in positives, images
  present and valid chunks, so a per-rank BatchNorm or pos_weight shows: two
  tests plant each and see the step leave the tolerance;
- BatchNorm's statistics on the mesh at channels with a large mean and a
  small spread against float64;
- the fairness penalties of the halves against the whole batch's;
- data=1, model=2 with fine-tuned notes: each rank's BERT on half of the
  note pack, one step's loss and gradients (the BERT body's included)
  against the one-process step; the loss-based fame family trained there
  at the default dropouts, its ranks' route-loss EMA and history equal;
- ``train_model`` at data=2, replicated and ZeRO-1, against one process
  over 2 epochs (losses and every leaf within 1e-5), a ZeRO mesh
  checkpoint resumed in one process, ``MIN_SHARD_SIZE``'s leaf rule;
- ``init_multihost``'s resolution order and refusals, ``cli train --mesh
  data=2`` as two processes with the JAX package's variables, and ``cli
  eval`` of its checkpoint in one process.
"""
import contextlib
import io
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train.loop import note_pack_bucket as jnote_pack_bucket
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu.train.steps import make_train_step as jmake_train_step
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import train_state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import restore_train_state
from multimodalrouting_tpu_torch.models.clinbert import slice_generator
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel import distributed as tdist
from multimodalrouting_tpu_torch.parallel.mesh import Mesh
from multimodalrouting_tpu_torch.parallel.zero import MIN_SHARD_SIZE, is_sharded, shard_optimizer_state, zero_slices
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket, train_model
from multimodalrouting_tpu_torch.train.state import (
    create_train_state,
    load_train_state_dict,
    serving_state_dict,
    train_state_dict,
)
from tests import torch_mesh_ranks as ranks
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    ATOL,
    O0,
    RTOL,
    assert_close,
    compiled,
    one_torch_thread,
    relative_errors,
    seeded_variables,
    to_numpy,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_TOL = 1e-5  # a mesh run against one process: summation order only
RANK_TIMEOUT = 600


def rank_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "MASTER_", "WORLD_", "RANK", "LOCAL_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)
    return env


def wait_all(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def jax_setup():
    """(config, model, variables) of the tiny flagship in the JAX package:
    seeded weights (``seeded_like``), BatchNorm at flax's init (scale 1,
    bias 0). Seeded BatchNorm biases leave channels of the 1 x 1 layer4
    maps with a large mean and a small spread over 8 stays, where flax's
    E[x^2] - E[x]^2 cancels: the JAX reference's own gradient then moves by
    1% with the order of the batch's rows. The mesh's BatchNorm at such
    channels is held against float64 instead
    (test_batch_norm_on_a_data_mesh_is_the_global_batch_s)."""
    jcfg = jc.apply_overrides(jc.Config(), ranks.TINY)
    jmodel = jbuild_model(jcfg, "capsule")
    variables = seeded_variables(jmodel, ranks.step_batch(), seed=5)

    def at_init(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        if any("bn" in k for k in keys[:-1]) and keys[-1] in ("scale", "bias"):
            return np.full_like(x, 1.0 if keys[-1] == "scale" else 0.0)
        return x

    return jcfg, jmodel, jax.tree_util.tree_map_with_path(at_init, variables)


@pytest.fixture(scope="module")
def jax_variables():
    return jax_setup()[2]


# `cli train --mesh data=2` of two families, as two processes each
CLI_FAMILIES = {"capsule": ["--family", "capsule"], "fame_tri": ["--family", "fame", "--stage", "tri"]}


def spawn(argv, **env):
    return subprocess.Popen(argv, cwd=ROOT, env=rank_env(**env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every process pair of the module, started together: the two ranks of
    tests/torch_mesh_ranks.py and a `cli train --mesh data=2` pair per
    family of CLI_FAMILIES, each world on its own port."""
    from tests.test_torch_cli import _sets

    work = tmp_path_factory.mktemp("mesh")
    with open(work / "variables.pkl", "wb") as f:
        pickle.dump(jax_setup()[2], f)
    port = str(ranks.free_port())
    procs = {"ranks": [spawn([sys.executable, "-m", "tests.torch_mesh_ranks", str(r), "2", port, str(work)])
                       for r in range(2)]}
    for i, (key, family) in enumerate(CLI_FAMILIES.items(), start=1):
        port = str(ranks.free_port(skip=i))
        argv = [sys.executable, "-m", "multimodalrouting_tpu_torch.cli", "train", *family, "--mesh", "data=2",
                "--device", "cpu", "--out", str(work / key), "--epochs", "1", *_sets(**{"train.ckpt_every": 0})]
        procs[key] = [spawn(argv, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                            JAX_PROCESS_ID=str(r)) for r in range(2)]
    try:
        yield work, procs
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def mesh_runs(launched):
    """The two ranks' scenarios and, meanwhile, the JAX global-batch step
    from the same initial state."""
    work, procs = launched
    jcfg, jmodel, variables = jax_setup()
    batch = ranks.step_batch()
    state = compiled(lambda v: jcreate_train_state(jcfg, jmodel, v), variables)
    try:
        step = jmake_train_step(jcfg, jmodel, "capsule")
        args = (state, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0),
                jnp.asarray(ranks.STEP_LR), jnp.asarray(ranks.STEP_LR / 2))
        new_state, metrics = step.lower(*args, note_pack=jnote_pack_bucket(jcfg, batch)).compile(
            compiler_options=O0)(*args)
        jax_out = {"loss": float(metrics.loss), "reg": float(metrics.reg_loss), "state": to_numpy({
            "params": new_state.params, "batch_stats": new_state.batch_stats, "ema_params": new_state.ema_params,
            "opt_state": new_state.opt_state, "step": new_state.step})}
    finally:
        wait_all(procs["ranks"])
    out = {"jax": jax_out, "work": work}
    for f in os.listdir(work):
        if f.endswith(".pt"):
            out[f[:-3]] = torch.load(work / f, weights_only=False)
    return out


def assert_same_ranks(runs, name):
    """The replicated parameters and buffers bit-identical on both ranks."""
    a, b = runs[f"{name}.rank0"], runs[f"{name}.rank1"]
    for key in ("model", "serving"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), (name, key)


# attention key biases: softmax is invariant to them, so their gradient is
# rounding noise in both runs, which Adam's normalisation turns into steps of
# about lr either way
NOISE_ONLY = "k_proj.bias"


def assert_leaves(got, ref, tol, what="", noise_abs=None):
    """Every leaf of `got` within `tol` of `ref` in relative norm; the
    noise-only leaves within `noise_abs` elementwise where given."""
    errors = relative_errors(got, ref)
    noise = [k for k in errors if k.endswith(NOISE_ONLY)]
    errors = {k: v for k, v in errors.items() if k not in noise}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= tol, f"{what}: {worst} off by {errors[worst]:.3e} in relative norm"
    if noise_abs is not None:
        for k in noise:
            assert float((got[k].float() - ref[k].float()).abs().max()) <= noise_abs, (what, k)


def jax_reference(runs) -> dict:
    """The JAX state after its step in the port's train-state form."""
    cfg = tc.apply_overrides(tc.Config(), ranks.TINY)
    return train_state_dict_from_jax(runs["jax"]["state"], build_model(cfg, device="cpu"))


def test_data_parallel_step_matches_the_jax_global_batch_step(mesh_runs):
    """The loss, the committed BatchNorm statistics and the gradient (as
    Adam's first moment after one step, (1 - b1) times the clipped gradient)
    against the JAX step; not the parameters, which Adam's first step moves
    by about lr * sign(g), so an element whose gradient is summation noise
    moves either way (tests/test_torch_train.py)."""
    got, j = mesh_runs["data_step.rank0"], mesh_runs["jax"]
    assert got["finite"] and got["step"] == 1
    assert_close(got["loss"], j["loss"])
    assert_close(got["reg"], j["reg"])
    ref = jax_reference(mesh_runs)
    stats = [k for k in ref["model"] if k.endswith(("running_mean", "running_var"))]
    assert stats  # the ResNet's BatchNorms commit the global batch's statistics
    for k in stats:
        assert_close(got["model"][k], ref["model"][k].numpy(), err_msg=k)
    assert sorted(got["mu"]) == sorted(ref["mu"])
    assert_leaves(got["mu"], ref["mu"], RTOL, "Adam's first moment")
    assert_same_ranks(mesh_runs, "data_step")


@pytest.mark.parametrize("kind", ["bn", "pos_weight"])
def test_a_per_rank_statistic_is_caught(mesh_runs, kind):
    """The same step with a per-rank BatchNorm moment or pos_weight planted:
    the loss leaves the tolerance the real step holds."""
    got, j = mesh_runs[f"fault_{kind}.rank0"], mesh_runs["jax"]
    with pytest.raises(AssertionError):
        assert_close(got["loss"], j["loss"])
    if kind == "bn":  # and the committed variances with it
        ref = jax_reference(mesh_runs)["model"]
        with pytest.raises(AssertionError):
            for k in (k for k in ref if k.endswith("running_var")):
                assert_close(got["model"][k], ref[k].numpy(), err_msg=k)


def test_fairness_penalties_are_the_global_batch_s(mesh_runs):
    ref = ranks.fairness(slice(0, 8))
    for name, (value, grad) in ref.items():
        halves = [mesh_runs[f"fairness.rank{r}"][name] for r in range(2)]
        for pen, _ in halves:
            np.testing.assert_allclose(pen, value, rtol=1e-6)
        # each rank backpropagates the replicated penalty: its rows' gradient
        # is the world's sum, which the world average divides by 2
        got = torch.cat([g for _, g in halves]) / 2
        np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-5, atol=1e-7)


def batch_norm_reference():
    """The training BatchNorm of ranks.bn_inputs() on all 8 rows in float64,
    two-pass: (output, the input's gradient, mean, variance)."""
    x, scale, bias, w = (v.double() for v in ranks.bn_inputs())
    x.requires_grad_()
    mean = x.mean(dim=(0, 2, 3))
    var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    out = (x - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * scale)[:, None, None] + bias[:, None, None]
    (out * w).sum().backward()
    return out.detach(), x.grad, mean.detach(), var.detach()


def test_batch_norm_on_a_data_mesh_is_the_global_batch_s(mesh_runs):
    """BatchNorm's training statistics on a data=2 mesh, at channels with a
    large mean and a small spread (seeded BatchNorm biases leave such
    channels in the tiny ResNet), against float64 on all 8 rows: the
    output, the input's gradient and the statistics, each rank its rows.
    The one-process forward on the same rows, flax's E[x^2] - E[x]^2 in
    fp32, misses the variance by far more: the inputs do stress the
    cancellation that the mesh's two passes avoid."""
    out, grad, mean, var = batch_norm_reference()
    ranks_ = [mesh_runs[f"batch_norm.rank{r}"] for r in range(2)]
    # the fp32 x - mean is exact but for the fp32 mean's rounding, at most
    # 2 ulps of x, which the normalisation multiplies by up to gain
    x, scale = ranks.bn_inputs()[:2]
    gain = float((scale.double() * torch.rsqrt(var + 1e-5)).abs().max())
    assert_close(torch.cat([r["out"] for r in ranks_]), out.numpy(),
                 atol=2 * float(np.spacing(x.abs().max().numpy())) * gain)
    assert_close(torch.cat([r["grad"] for r in ranks_]), grad.numpy(), atol=ATOL * float(grad.abs().max()))
    for r in ranks_:
        np.testing.assert_allclose(r["mean"].double().numpy(), mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(r["var"].double().numpy(), var.numpy(), rtol=RTOL)
    one = ranks.batch_norm_rows(slice(0, 8))
    assert float(((one["var"].double() - var).abs() / var).max()) > 100 * RTOL


def test_chunks_sharded_over_model_match_one_process(mesh_runs, jax_variables):
    """One data=1, model=2 fine-tuned step against the one-process step:
    each rank's BERT ran on half of the note pack (rounded up), and the
    loss, the gradients and the parameters are the one-process step's."""
    cfg = ranks.cfg_of(**{"encoder.finetune_text": True})
    model = ranks.seeded_model(cfg, jax_variables)
    state = create_train_state(cfg, model)
    grads: dict = {}
    rows = ranks.chunk_rows(model)
    metrics = ranks.one_step(cfg, model, state, ranks.step_batch(), record=grads)
    got = mesh_runs["model_sharded.rank0"]
    assert rows == [note_pack_bucket(cfg, ranks.step_batch())]
    for r in range(2):
        assert mesh_runs[f"model_sharded.rank{r}"]["chunk_rows"] == [-(-rows[0] // 2)]
    np.testing.assert_allclose(got["loss"], float(metrics.loss), rtol=1e-6)
    bert = [n for n in grads if ".bert." in n]
    assert bert and all(float(grads[n].norm()) > 0 for n in bert)
    assert_leaves(got["grads"], grads, LOOP_TOL, "gradients")
    assert_leaves(got["model"], model.state_dict(), LOOP_TOL, "params", noise_abs=2 * ranks.STEP_LR)
    assert_same_ranks(mesh_runs, "model_sharded")


def test_a_model_group_shares_its_dropout_masks(mesh_runs):
    """The loss-based fame family on data=1, model=2 at the default
    dropouts for 2 epochs: both ranks hold the same rows, draw the same
    masks for the replicated encoders and heads, and so keep the same
    route-loss EMA (which the gate's evaluation reads), history and
    parameters."""
    cfg = ranks.loss_based_cfg()
    assert cfg.model.attn_dropout > 0 and cfg.model.smro_dropout > 0 and cfg.encoder.dropout > 0
    a, b = (mesh_runs[f"loss_based.rank{r}"] for r in range(2))
    assert torch.equal(a["route_loss_ema"], b["route_loss_ema"]) and float(a["route_loss_ema"].abs().min()) > 0
    untimed = [[{k: v for k, v in h.items() if k != "sec"} for h in run["history"]] for run in (a, b)]
    assert untimed[0] == untimed[1] and len(untimed[0]) == 2
    assert_same_ranks(mesh_runs, "loss_based")


def test_each_chunk_slice_draws_its_own_dropout_masks():
    """`slice_generator` on the model group's ranks, whose shared generators
    are in one state: each slice's masks differ from the others', the same
    rank draws the same ones again, and the shared generator advances alike
    on every rank."""
    shared = [torch.Generator().manual_seed(3) for _ in range(3)]
    draws = [torch.rand(64, generator=slice_generator(g, j)) for g, j in zip(shared, (0, 1, 0))]
    assert not torch.equal(draws[0], draws[1]) and torch.equal(draws[0], draws[2])
    assert all(torch.equal(g.get_state(), shared[0].get_state()) for g in shared)
    assert not torch.equal(shared[0].get_state(), torch.Generator().manual_seed(3).get_state())
    assert slice_generator(None, 1) is None


@pytest.fixture(scope="module")
def one_process_loop(jax_variables):
    cfg = tc.apply_overrides(tc.Config(), ranks.LOOP)
    tr, va = ranks.loop_cohorts()
    return train_model(cfg, ranks.seeded_model(cfg, jax_variables), tr, va, log_fn=lambda _: None)


@pytest.mark.parametrize("name", ["loop", "loop_zero"])
def test_train_model_on_a_data_mesh_matches_one_process(mesh_runs, one_process_loop, name):
    got = mesh_runs[f"{name}.rank0"]
    ref = one_process_loop
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in ref.history], rtol=LOOP_TOL)
    np.testing.assert_allclose([h["val_auroc"] for h in got["history"]], [h["val_auroc"] for h in ref.history])
    noise = 2 * len(ref.history) * tc.Config().train.lr  # two steps an epoch
    assert_leaves(got["model"], ref.state.model.state_dict(), LOOP_TOL, f"{name} params", noise_abs=noise)
    assert_leaves(got["serving"], serving_state_dict(ref.state), LOOP_TOL, f"{name} EMA", noise_abs=noise)
    assert_same_ranks(mesh_runs, name)
    if name == "loop_zero":  # each rank holds about half of the moments
        full = sum(v.numel() * v.element_size() for d in (ref.state.mu, ref.state.nu) for v in d.values())
        for r in range(2):
            assert mesh_runs[f"loop_zero.rank{r}"]["adam_bytes"] <= 0.55 * full


def test_zero_mesh_checkpoint_resumes_in_one_process(mesh_runs, jax_variables):
    """One ZeRO epoch on the mesh, its checkpoint (full moments, written by
    rank 0) resumed for the second epoch in one process, against the mesh's
    two epochs without a break."""
    ckpt = mesh_runs["work"] / "ckpt_zero"
    assert sorted(p.name for p in ckpt.iterdir() if p.is_dir()) == ["final"]
    cfg = tc.apply_overrides(tc.Config(), ranks.LOOP)
    model = ranks.seeded_model(cfg, jax_variables)
    state = restore_train_state(str(ckpt), create_train_state(cfg, model), name="final")
    assert state.step == 2
    tr, va = ranks.loop_cohorts()
    res = train_model(cfg, model, tr, va, state=state, log_fn=lambda _: None)
    mesh = mesh_runs["loop_zero.rank0"]
    np.testing.assert_allclose([h["train_loss"] for h in res.history], [mesh["history"][1]["train_loss"]],
                               rtol=LOOP_TOL)
    assert_leaves(mesh["model"], model.state_dict(), LOOP_TOL, "resumed params",
                  noise_abs=4 * cfg.train.lr)


def test_a_one_process_checkpoint_loads_into_zero_slices(jax_variables):
    """A full train state (a one-process checkpoint's) restored into a ZeRO
    state: each sharded leaf's moments as this rank's rows, the rest
    whole."""
    cfg = ranks.cfg_of()
    state = create_train_state(cfg, ranks.seeded_model(cfg, jax_variables))
    saved = train_state_dict(state)
    g = torch.Generator().manual_seed(0)
    for moments in (saved["mu"], saved["nu"]):
        for n, v in moments.items():
            moments[n] = torch.randn(v.shape, generator=g)
    shard_optimizer_state(state, Mesh(n_data=2, rank=1))
    load_train_state_dict(state, saved)
    rows = state.zero.slices
    assert rows and len(rows) < len(state.names)
    for n in state.names:
        for got, full in ((state.mu[n], saved["mu"][n]), (state.nu[n], saved["nu"][n])):
            assert torch.equal(got, full[rows[n]] if n in rows else full), n


def test_zero_spec_rules():
    """tests/test_zero.py's leaf rule: leading-dim-divisible big tensors
    shard; scalars, small and indivisible leaves stay replicated."""
    shapes = {"mu": (1024, 8), "small_bias": (64,), "odd": (1023, 8), "count": ()}
    assert [n for n, s in shapes.items() if is_sharded(s, 4)] == ["mu"]
    assert MIN_SHARD_SIZE == 2048 and not is_sharded((2047,), 1) and is_sharded((2048,), 1)
    assert zero_slices(shapes, 4, 3) == {"mu": slice(768, 1024)}


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, backend, init_method, world_size, rank):
        self.calls.append((backend, init_method, world_size, rank))


@pytest.mark.parametrize("env, args, want", [
    ({}, {}, None),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2",
      "MASTER_ADDR": "m", "MASTER_PORT": "2", "WORLD_SIZE": "8", "RANK": "5"}, {}, ("gloo", "tcp://h:1", 4, 2)),
    ({"MASTER_ADDR": "m", "MASTER_PORT": "2", "WORLD_SIZE": "8", "RANK": "5"}, {}, ("gloo", "tcp://m:2", 8, 5)),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"},
     {"coordinator_address": "x:9", "num_processes": 3, "process_id": 1}, ("gloo", "tcp://x:9", 3, 1)),
])
def test_init_multihost_resolution_order(monkeypatch, env, args, want):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK", "LOCAL_RANK", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rec = _Recorder()
    monkeypatch.setattr(tdist.dist, "init_process_group", rec)
    monkeypatch.setattr(tdist, "_warmup_world", lambda device: None)
    assert tdist.init_multihost(device="cpu", **args) is (want is not None)
    assert rec.calls == ([want] if want else [])


def test_init_multihost_refusals(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tdist.dist, "init_process_group", _Recorder())
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "t0,t1")
    with pytest.raises(ValueError, match="TPU pod auto-detect has no counterpart"):
        tdist.init_multihost(device="cpu")
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES")
    explicit = dict(coordinator_address="h:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="only gloo runs there"):
        tdist.init_multihost(backend="nccl", device="cpu", **explicit)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdist.init_multihost(device="cuda", **explicit)


@pytest.mark.parametrize("key", list(CLI_FAMILIES))
def test_cli_train_on_a_data_mesh_then_eval_in_one_process(launched, key):
    """`cli train --mesh data=2` as two processes with the JAX package's
    variables: one epoch, one checkpoint written by rank 0, which `cli eval`
    serves in one process."""
    work, procs = launched
    out, family = work / key, CLI_FAMILIES[key]
    outs = wait_all(procs[key])
    for r, text in enumerate(outs):
        assert f"[distributed] process {r}/2: 1 local / 2 global devices (cpu)" in text
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == ["final"]
    assert (out / "history.json").exists()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["eval", "--ckpt", str(out), "--device", "cpu", *family[:2]]) == 0
    assert '"auroc"' in buf.getvalue()
