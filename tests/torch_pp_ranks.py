"""The ranks of tests/test_torch_pp_mesh.py: a process of a gloo world on the
CPU that runs the port's GPipe schedule (the 'model' axis's ``pipeline``
role) and microbatching on a mesh, and writes what it saw for the test to
compare with the JAX package and one process. It imports neither JAX nor
the JAX package.

    python -m tests.torch_pp_ranks RANK WORLD PORT WORKDIR

A world of 2 is the mesh data=1, model=2 (and, for microbatching, data=2,
model=1); a world of 4 is data=2, model=2. The models start from
``WORKDIR/variables_pp.pkl`` (the tiny fine-tuned flagship in the pipeline
layout, seeded JAX variables) and ``WORKDIR/variables_mb.pkl`` (the layered
one), which the test writes first; each scenario writes
``WORKDIR/<scenario>.w<world>.rank<r>.pt``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import torch

from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import rank_state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import restore_train_state
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel import mesh as pmesh
from multimodalrouting_tpu_torch.parallel import pp
from multimodalrouting_tpu_torch.parallel.tp import tp_spec_for_name
from multimodalrouting_tpu_torch.train import steps as tsteps
from multimodalrouting_tpu_torch.train.loop import train_model
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict
from tests import torch_mesh_ranks as mr
from tests.torch_tp_ep_ranks import digest, wait_for

# the schedule's cases: tests/test_pp.py's stack (4 layers of 32 features, 4
# heads, FFN 64) over chunks of 12 tokens
L_LAYERS, HID, HEADS, INTER = 4, 32, 4, 64
N_CHUNKS, SEQ = 16, 12
N_MICRO = (1, 2, 4)
# the tiny fine-tuned flagship (2 BERT layers: one a stage) with a clip that
# binds, in the pipeline layout
PP_STEP = {**mr.TINY, "encoder.finetune_text": True, "train.grad_clip": 0.05, "train.pipeline_parallel": True}
# the same, layered, with train.microbatch=2 on the global batch of 8
MB_STEP = {**mr.TINY, "encoder.finetune_text": True, "train.grad_clip": 0.05, "train.microbatch": 2}
# the pipeline layout with train.microbatch=2: the GPipe schedule inside each step microbatch
PP_MB_STEP = {**PP_STEP, "train.microbatch": 2}
SPECS = {"pipeline": pp.pp_spec_for_name, "tensor": tp_spec_for_name}
FLAG = {"pipeline": "train.pipeline_parallel", "tensor": "train.tensor_parallel"}
# train_model on data=1, model=2 under the pipeline role
PP_LOOP = {**mr.LOOP, "encoder.finetune_text": True, "train.pipeline_parallel": True, "train.num_model_shards": 2}
# the refusals of the GPipe schedule and of microbatching on a mesh, now
# `cli train` runs: (world, --mesh and --set arguments after the tiny ones)
CLI_CASES = {
    "pipeline": (2, ["--mesh", "data=1,model=2", "--set", "train.pipeline_parallel=true",
                     "--set", "encoder.bert_layers=2"]),
    "route_microbatch": (2, ["--mesh", "data=1,model=2", "--set", "train.route_parallel=true",
                             "--set", "train.microbatch=2"]),
    "tensor_microbatch": (4, ["--mesh", "data=2,model=2", "--set", "train.tensor_parallel=true",
                              "--set", "train.microbatch=2"]),
}


def cfg_of(base: dict, **over):
    return tc.apply_overrides(tc.Config(), {**base, **over})


def schedule_case(seed: int, n: int = N_CHUNKS) -> dict:
    """Seeded stacked leaves, chunks [n, SEQ, HID], their key mask (the
    first token always valid) and a readout vector, as numpy (the JAX
    package's tests/test_pp.py draws)."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape, scale=0.1).astype(np.float32)

    lay, h, i = L_LAYERS, HID, INTER
    w = {"q_kernel": mk(lay, h, h), "q_bias": mk(lay, h), "k_kernel": mk(lay, h, h), "k_bias": mk(lay, h),
         "v_kernel": mk(lay, h, h), "v_bias": mk(lay, h), "o_kernel": mk(lay, h, h), "o_bias": mk(lay, h),
         "attn_ln_scale": np.ones((lay, h), np.float32), "attn_ln_bias": np.zeros((lay, h), np.float32),
         "i_kernel": mk(lay, h, i), "i_bias": mk(lay, i), "f_kernel": mk(lay, i, h), "f_bias": mk(lay, h),
         "ln_scale": np.ones((lay, h), np.float32), "ln_bias": np.zeros((lay, h), np.float32)}
    x = rng.normal(size=(n, SEQ, h)).astype(np.float32)
    mask = (rng.random((n, SEQ)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    return {"w": w, "x": x, "mask": mask, "r": rng.normal(size=(h,)).astype(np.float32)}


# the schedule's scenarios: (case seed, chunks, n_micro)
FORWARDS = {f"fwd{k}": (2, N_CHUNKS, k) for k in N_MICRO}
FORWARDS["fwd9"] = (5, 9, 4)  # 9 chunks: padded to split over 2 data shards
GRAD = (3, N_CHUNKS, 4)
REMAT = (6, 8, 2)


def data_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data shard's rows of the global chunk axis, padded with zeros to
    a multiple of the data shards first (the JAX package's pad before its
    ``shard_map`` over 'data')."""
    n = x.shape[0]
    x = torch.cat([x, x.new_zeros(((-n) % mesh.n_data,) + tuple(x.shape[1:]))])
    per = x.shape[0] // mesh.n_data
    return x[mesh.data_index * per : (mesh.data_index + 1) * per]


def gather_data(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """Every data shard's rows in order, the padding cut off."""
    return torch.cat(pmesh.all_gather(x.contiguous(), mesh.data))[:n]


def run_schedule(mesh, seed: int, n: int, n_micro: int, grad: bool = False, remat: bool = False) -> dict:
    """The schedule on the data shard's rows of a case's chunks, this
    stage's leaves; -> the global output, the layer calls of this rank and,
    with `grad`, the loss sum(tanh(out @ r)^2) over the global chunks and
    the whole gradients of the leaves and of the chunks."""
    case = schedule_case(seed, n)
    w = {k: pmesh.local_slice(torch.from_numpy(v), 0, mesh).clone().requires_grad_(grad)
         for k, v in case["w"].items()}
    x = data_shard(torch.from_numpy(case["x"]), mesh).requires_grad_(grad)
    mask = data_shard(torch.from_numpy(case["mask"]), mesh)
    calls, real = [], pp.bert_layer_fwd

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    pp.bert_layer_fwd = counted
    try:
        with torch.set_grad_enabled(grad):
            out = pp.pipeline_apply(w, x, mask, mesh=mesh, n_micro=n_micro, heads=HEADS, dtype=torch.float32,
                                    remat=remat)
            rows = min(out.shape[0], max(n - mesh.data_index * out.shape[0], 0))  # the real chunks
            loss = (torch.tanh(out[:rows] @ torch.from_numpy(case["r"])) ** 2).sum() if grad else None
            res = {"out": gather_data(out.detach(), n, mesh), "layer_calls": len(calls)}
            if grad:
                g = torch.autograd.grad(loss, [x, *w.values()])
                # the data shards' sums of this stage's leaves, then the stages' slices whole
                res["grads"] = {k: torch.cat(pmesh.all_gather(pmesh.all_reduce_(v.clone(), mesh.data), mesh.model))
                                for k, v in zip(w, g[1:])}
                res["grad_x"] = gather_data(g[0], n, mesh)
                res["loss"] = float(pmesh.all_reduce_(loss.detach().clone(), mesh.data))
    finally:
        pp.bert_layer_fwd = real
    return res


def schedule(mesh) -> dict:
    """Every case of the schedule, and the sequential stack on the whole
    chunks for the forwards."""
    out = {}
    for name, (seed, n, k) in FORWARDS.items():
        out[name] = run_schedule(mesh, seed, n, k)
        case = schedule_case(seed, n)
        with torch.no_grad():
            out[name]["scan"] = pp._scan_layers({k: torch.from_numpy(v) for k, v in case["w"].items()},
                                                torch.from_numpy(case["x"]), torch.from_numpy(case["mask"]),
                                                heads=HEADS, dtype=torch.float32)
    out["grad"] = run_schedule(mesh, *GRAD, grad=True)
    out["plain"] = run_schedule(mesh, *REMAT, grad=True)
    out["remat"] = run_schedule(mesh, *REMAT, grad=True, remat=True)
    return out


def bytes_of(model, keep) -> int:
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters() if keep(n))


def mesh_step(variables, mesh, base: dict, role: str, layout: int = 0, fault=None) -> dict:
    """One step of the tiny flagship on `mesh` under `role` from the seeded
    variables: the placed state's slices against the bridge's slicing of the
    same variables, then the step on this rank's rows, laid out for
    ``train.microbatch`` = `layout` (0: the config's); -> the loss, the
    whole moments, parameters and buffers, and each rank's placement.
    `fault` plants a defect: ``missing_f`` feeds the pipeline its input
    without Megatron's *f*, ``world_average`` averages the stage-sharded
    leaves over the world."""
    over = {"train.num_data_shards": mesh.n_data, "train.num_model_shards": mesh.n_model}
    if role in FLAG:
        over[FLAG[role]] = True
    cfg = cfg_of(base, **over)
    model = mr.seeded_model(cfg, variables)
    state = create_train_state(cfg, model)
    out = {}
    if role in SPECS:
        whole = {n: p.numel() * p.element_size() for n, p in model.named_parameters()}
        shards = pmesh.place_state(state, mesh, SPECS[role])
        ref = rank_state_dict_from_jax(variables, build_model(cfg, device="cpu", train=True), mesh, SPECS[role])
        out.update(placed_ok=all(torch.equal(v, ref[k]) for k, v in model.state_dict().items()),
                   sharded=sorted(shards.dims), sharded_bytes=bytes_of(model, lambda n: n in shards.dims),
                   sharded_bytes_whole=sum(v for n, v in whole.items() if n in shards.dims))
    undo = []
    if fault == "missing_f":
        real_f = pp.copy_to_model_group
        pp.copy_to_model_group = lambda x: x
        undo.append(lambda: setattr(pp, "copy_to_model_group", real_f))
    if fault == "world_average":
        real_avg = tsteps.average_gradients
        tsteps.average_gradients = lambda g, sharded=(): real_avg(g)
        undo.append(lambda: setattr(tsteps, "average_gradients", real_avg))
    batch = mr.step_batch()
    local = pmesh.shard_batch(batch, mesh, layout or cfg.train.microbatch) if mesh.n_data > 1 else batch
    try:
        metrics = mr.one_step(cfg, model, state, local)
    finally:
        for u in undo:
            u()
    full = state.shards.full_dict if state.shards is not None else (lambda d: d)
    replicated = {n: p.detach() for n, p in model.named_parameters()
                  if state.shards is None or n not in state.shards.dims}
    out.update(loss=float(metrics.loss), reg=float(metrics.reg_loss), finite=bool(metrics.grad_finite),
               step=state.step, mu=full(state.mu), model=full(model.state_dict()), serving=serving_state_dict(state),
               replicated_sha=digest(replicated), rows=local.batch_size,
               local_shapes={n: tuple(p.shape) for n, p in model.named_parameters() if "pp_layers" in n})
    return out


def pp_loop(work: str, name: str, epochs: int, state_from=None) -> dict:
    """train_model under the pipeline role on data=1, model=2 (torch's
    seeded init); with `state_from`, from that one-process checkpoint's
    train state (loaded whole, then sliced onto the mesh)."""
    cfg = cfg_of(PP_LOOP, **{"train.epochs": epochs})
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", train=True)
    state = None
    if state_from is not None:
        wait_for(state_from)
        state = restore_train_state(state_from, create_train_state(cfg, model), name="final")
    tr, va = mr.loop_cohorts()
    ckpt = os.path.join(work, name) if state_from is None and epochs == 1 else None
    logs = []
    res = train_model(cfg, model, tr, va, state=state, log_fn=logs.append, ckpt_dir=ckpt)
    shards = res.state.shards
    return {"history": res.history, "model": shards.full_dict(res.state.model.state_dict()),
            "serving": serving_state_dict(res.state), "logs": logs}


def run_cli(work: str, case: str) -> dict:
    """`cli train` of a CLI_CASES case for one epoch in this process of the
    world, with the test's tiny ``--set`` pairs (``WORKDIR/cli_sets.json``)
    first; -> its exit code and output."""
    with open(os.path.join(work, "cli_sets.json")) as f:
        sets = json.load(f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(["train", *sets, *CLI_CASES[case][1], "--device", "cpu", "--out",
                        os.path.join(work, f"cli_{case}"), "--epochs", "1"])
    return {"rc": rc, "stdout": buf.getvalue()}


def main(rank: int, world: int, port: str, work: str) -> None:
    from multimodalrouting_tpu_torch.parallel.distributed import init_multihost

    torch.set_num_threads(1)
    assert init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu")

    def save(name, value):
        # every rank's scalars and digests; rank 0 alone writes the whole dicts
        for key in ("model", "serving", "mu"):
            if key in value:
                value[f"{key}_sha"] = digest(value[key])
                if rank != 0:
                    del value[key]
        torch.save(value, os.path.join(work, f"{name}.w{world}.rank{rank}.pt"))

    def load(name):
        with open(os.path.join(work, name), "rb") as f:
            return pickle.load(f)

    variables_pp, variables_mb = load("variables_pp.pkl"), load("variables_mb.pkl")
    pipe = pmesh.make_mesh(world // 2, 2, role="pipeline")
    pmesh.warmup_collectives(pipe, "cpu")
    pmesh.set_active_mesh(pipe)
    try:
        save("schedule", schedule(pipe))
        save("pp_step", mesh_step(variables_pp, pipe, PP_STEP, "pipeline"))
        for fault in ("missing_f", "world_average"):
            save(f"fault_{fault}", mesh_step(variables_pp, pipe, PP_STEP, "pipeline", fault=fault))
        if world == 4:  # microbatching on data=2 under the pipeline role
            save("mb_pipeline", mesh_step(variables_pp, pipe, PP_MB_STEP, "pipeline"))
    finally:
        pmesh.set_active_mesh(None)
    # microbatching on data=2: the chunks role (and, at world 4, tensor
    # parallelism over the model group), then local-block microbatches
    roles = ("chunks",) if world == 2 else ("chunks", "tensor")
    for role in roles:
        mesh = pmesh.make_mesh(2, world // 2, role=role)
        pmesh.set_active_mesh(mesh)
        try:
            save(f"mb_{role}", mesh_step(variables_mb, mesh, MB_STEP, role))
            if role == "chunks":
                save("fault_local_block", mesh_step(variables_mb, mesh, MB_STEP, role, layout=1))
        finally:
            pmesh.set_active_mesh(None)
    if world == 2:
        save("pp_loop", pp_loop(work, "pp_loop", 2))
        save("pp_ckpt", pp_loop(work, "pp_ckpt", 1))
        save("pp_from_one", pp_loop(work, "pp_from_one", 2, state_from=os.path.join(work, "one_process")))
    for case, (case_world, _) in CLI_CASES.items():
        if case_world == world:
            save(f"cli_{case}", run_cli(work, case))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
