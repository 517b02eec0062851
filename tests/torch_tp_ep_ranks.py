"""The ranks of tests/test_torch_tp_ep.py: a process of a gloo world on the
CPU that runs the port's tensor- and route-parallel paths (the 'model'
axis's ``tensor`` and ``route`` roles) and writes what it saw for the test to
compare with the JAX package and one process. It imports neither JAX nor the
JAX package.

    python -m tests.torch_tp_ep_ranks RANK WORLD PORT WORKDIR

A world of 2 is the mesh data=1, model=2; a world of 4 is data=2, model=2.
Every model starts from ``WORKDIR/variables.pkl`` (the tiny fine-tuned
flagship's seeded JAX variables) or ``WORKDIR/variables_mult.pkl`` (the
per-route MulT family's), which the test writes first, and each scenario
writes ``WORKDIR/<scenario>.w<world>.rank<r>.pt``.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import time

import numpy as np
import torch

from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import rank_state_dict_from_jax, train_state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import restore_train_state
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops.quant import QuantDense
from multimodalrouting_tpu_torch.parallel import mesh as pmesh
from multimodalrouting_tpu_torch.parallel.ep import ep_spec_for_name
from multimodalrouting_tpu_torch.parallel.tp import _quant_row_parallel, tp_spec_for_name
from multimodalrouting_tpu_torch.parallel.zero import shard_optimizer_state
from multimodalrouting_tpu_torch.train import steps as tsteps
from multimodalrouting_tpu_torch.train.loop import train_model
from multimodalrouting_tpu_torch.train.state import create_train_state, load_train_state_dict, serving_state_dict
from tests import torch_mesh_ranks as mr

# tests/torch_mesh_ranks.py's tiny flagship with fine-tuned notes and a clip
# that binds, so that the clip norm shows in Adam's first moment
TP_EP = {**mr.TINY, "encoder.finetune_text": True, "train.grad_clip": 0.05}
# configs/pheno_atten_mult.yaml's model section at those widths
MULT = {**mr.TINY, "model.task": "pheno", "model.num_classes": 25, "model.bi_fusion_mode": "mult",
        "model.cross_attn_layers": 1, "model.cross_attn_mask": True, "model.capsule_act_type": "sigmoid_gate",
        "train.grad_clip": 0.05}
SPECS = {"tensor": tp_spec_for_name, "route": ep_spec_for_name}
FLAG = {"tensor": "train.tensor_parallel", "route": "train.route_parallel"}
# train_model runs on data=1, model=2 under tensor parallelism
TP_LOOP = {**mr.LOOP, "encoder.finetune_text": True, "train.tensor_parallel": True, "train.num_model_shards": 2}


def cfg_of(base: dict, **over):
    return tc.apply_overrides(tc.Config(), {**base, **over})


def pheno_batch():
    """The step batch's notes and images with 25 synthetic phenotype labels."""
    y = make_synthetic_cohort(8, t=8, f=8, s=5, l=32, image_size=32, vocab_size=256, seed=8, task="pheno").y
    return mr.step_batch()._replace(y=np.asarray(y, np.float32))


def mesh_of(world: int, role: str) -> pmesh.Mesh:
    return pmesh.make_mesh(world // 2, 2, role=role)


def role_step(variables, mesh, role: str, base: dict, batch, *, zero: bool = False, fault=None) -> dict:
    """One step on `mesh` under `role` from the seeded variables: the placed
    state's slices against the bridge's slicing of the same variables, then
    the step; -> the loss, the whole gradients and moments (gathered over
    the model group), the whole parameters and each rank's parameter bytes.
    `fault` plants a defect: ``world_average`` averages the sharded slices
    over the world, ``local_norm`` counts each rank's slice alone in the
    clip norm."""
    cfg = cfg_of(base, **{FLAG[role]: True, "train.num_data_shards": mesh.n_data, "train.num_model_shards": 2,
                          "train.zero_sharded_opt": zero})
    model = mr.seeded_model(cfg, variables)
    whole = {n: p.numel() * p.element_size() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model)
    shards = pmesh.place_state(state, mesh, SPECS[role])
    ref = rank_state_dict_from_jax(variables, build_model(cfg, device="cpu", train=True), mesh, SPECS[role])
    placed_ok = all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())
    if zero:
        shard_optimizer_state(state, mesh)
    grads: dict = {}
    undo = []
    if fault == "world_average":
        real = tsteps.average_gradients
        tsteps.average_gradients = lambda g, sharded=(): real(g)
        undo.append(lambda: setattr(tsteps, "average_gradients", real))
    # the clip norm apply_gradients takes: the square root of the per-leaf
    # sums of squares summed over the model group
    real_sq, norms = pmesh.ModelShards.sum_squares, []

    def sum_squares(self, sq, names):
        out = sq if fault == "local_norm" else real_sq(self, sq, names)
        norms.append(float(out.sum().sqrt()))
        return out

    pmesh.ModelShards.sum_squares = sum_squares
    undo.append(lambda: setattr(pmesh.ModelShards, "sum_squares", real_sq))
    local = pmesh.shard_batch(batch, mesh) if mesh.n_data > 1 else batch
    try:
        metrics = mr.one_step(cfg, model, state, local, record=grads)
    finally:
        for u in undo:
            u()
    from multimodalrouting_tpu_torch.parallel.zero import gather_moments

    mu = gather_moments(state)[0] if state.zero is not None else state.mu
    return {
        "loss": float(metrics.loss), "reg": float(metrics.reg_loss), "finite": bool(metrics.grad_finite),
        "placed_ok": placed_ok, "sharded": sorted(shards.dims), "step": state.step, "clip_norm": norms[0],
        "grad_norm": float(torch.linalg.vector_norm(torch.stack(
            [v.float().norm() for v in shards.full_dict(grads).values()]))),
        "mu": shards.full_dict(mu),
        "model": shards.full_dict(model.state_dict()), "serving": serving_state_dict(state),
        "sharded_bytes": sum(p.numel() * p.element_size() for n, p in model.named_parameters() if n in shards.dims),
        "sharded_bytes_whole": sum(v for n, v in whole.items() if n in shards.dims),
    }


def fused_qkv_step(variables, mesh) -> dict:
    """``role_step`` under tensor parallelism with ``MMR_FUSED_QKV=1``: each
    rank's BERT attention projects its q/k/v column slices as one product
    (the calls counted)."""
    from multimodalrouting_tpu_torch.parallel import tp

    calls, real = [], tp.fused_qkv
    tp.fused_qkv = lambda *a: calls.append(1) or real(*a)
    os.environ["MMR_FUSED_QKV"] = "1"
    try:
        out = role_step(variables, mesh, "tensor", TP_EP, mr.step_batch())
    finally:
        del os.environ["MMR_FUSED_QKV"]
        tp.fused_qkv = real
    out["fused_calls"] = len(calls)
    return out


def int8_row_parallel(mesh) -> dict:
    """A row-parallel QuantDense from this rank's input columns against the
    whole QuantDense on the whole input."""
    g = torch.Generator().manual_seed(4)
    full = QuantDense(64, 24)
    with torch.no_grad():
        full.weight.copy_(torch.randn(24, 64, generator=g))
        full.bias.copy_(torch.randn(24, generator=g))
    x = torch.randn(5, 7, 64, generator=g) * torch.linspace(0.1, 3.0, 64)
    part = QuantDense(32, 24)
    with torch.no_grad():
        part.weight.copy_(pmesh.local_slice(full.weight, 1, mesh))
        part.bias.copy_(full.bias)
    got = _quant_row_parallel(part, pmesh.local_slice(x, 2, mesh).contiguous(), mesh)
    return {"got": got, "want": full(x)}


def tp_loop(work: str, name: str, epochs: int, state_from=None) -> dict:
    """train_model under tensor parallelism on data=1, model=2 (torch's
    seeded init); with `state_from`, from that one-process checkpoint's
    train state (loaded whole, then sliced onto the mesh)."""
    cfg = cfg_of(TP_LOOP, **{"train.epochs": epochs})
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", train=True)
    state = None
    if state_from is not None:
        wait_for(state_from)
        state = restore_train_state(state_from, create_train_state(cfg, model), name="final")
    tr, va = mr.loop_cohorts()
    ckpt = os.path.join(work, name) if state_from is None and epochs == 1 else None
    res = train_model(cfg, model, tr, va, state=state, log_fn=lambda _: None, ckpt_dir=ckpt)
    shards = res.state.shards
    return {"history": res.history, "model": shards.full_dict(res.state.model.state_dict()),
            "serving": serving_state_dict(res.state)}


def wait_for(path: str, timeout: float = 600.0) -> str:
    """`path` once the test has written it (it renames it into place)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout:.0f}s")
        time.sleep(0.2)
    return path


def jax_state_onto_mesh(work: str, mesh) -> dict:
    """The JAX train state after its step (as ``ckpt.py`` reads a JAX
    checkpoint, in memory) loaded into a tensor-parallel state: this
    rank's slices of its parameters, moments and EMA."""
    with open(wait_for(os.path.join(work, "jax_state.pkl")), "rb") as f:
        jstate = pickle.load(f)
    cfg = cfg_of(TP_EP, **{"train.tensor_parallel": True, "train.num_model_shards": 2})
    model = build_model(cfg, device="cpu", train=True)
    saved = train_state_dict_from_jax(jstate, model)
    state = create_train_state(cfg, model)
    shards = pmesh.place_state(state, mesh, tp_spec_for_name)
    load_train_state_dict(state, saved)
    ok = all(torch.equal(state.mu[n], shards.local(n, saved["mu"][n].float())) for n in state.names)
    ok = ok and all(torch.equal(v, shards.local(k, saved["model"][k])) for k, v in model.state_dict().items())
    ok = ok and all(torch.equal(state.ema[n], shards.local(n, saved["ema"][n])) for n in state.names)
    return {"ok": ok, "sharded": len(shards.dims), "step": state.step}


def run_cli(work: str, role: str) -> dict:
    """`cli train --mesh data=1,model=2` under `role` for one epoch, in this
    process of the world, with the test's tiny ``--set`` pairs
    (``WORKDIR/cli_sets.json``)."""
    with open(os.path.join(work, "cli_sets.json")) as f:
        sets = json.load(f)
    out = os.path.join(work, f"cli_{role}")
    rc = tcli.main(["train", "--mesh", "data=1,model=2", "--set", f"{FLAG[role]}=true", "--device", "cpu",
                    "--out", out, "--epochs", "1", *sets])
    return {"rc": rc}


def digest(tensors: dict) -> str:
    """A hash of a state dict's tensors, to hold ranks bit-identical without
    writing each rank's copy (a tiny train state is ~45 MB a dict)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode() + tensors[k].detach().float().numpy().tobytes())
    return h.hexdigest()


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

    variables, variables_mult = load("variables.pkl"), load("variables_mult.pkl")
    for role in ("tensor", "route"):
        mesh = mesh_of(world, role)
        pmesh.warmup_collectives(mesh, "cpu")
        pmesh.set_active_mesh(mesh)
        try:
            save(f"{role}_step", role_step(variables, mesh, role, TP_EP, mr.step_batch()))
            if world == 2 and role == "route":
                save("route_mult_step", role_step(variables_mult, mesh, role, MULT, pheno_batch()))
            if world == 2 and role == "tensor":
                for fault in ("world_average", "local_norm"):
                    save(f"fault_{fault}", role_step(variables, mesh, role, TP_EP, mr.step_batch(), fault=fault))
                save("int8_row", int8_row_parallel(mesh))
                save("tensor_fused_qkv_step", fused_qkv_step(variables, mesh))
                save("jax_state", jax_state_onto_mesh(work, mesh))
            if world == 4 and role == "tensor":
                save("tensor_zero_step", role_step(variables, mesh, role, TP_EP, mr.step_batch(), zero=True))
        finally:
            pmesh.set_active_mesh(None)
    if world == 2:
        save("tp_loop", tp_loop(work, "tp_loop", 2))
        save("tp_ckpt", tp_loop(work, "tp_ckpt", 1))
        save("tp_from_one", tp_loop(work, "tp_from_one", 2, state_from=os.path.join(work, "one_process")))
        for role in ("tensor", "route"):
            save(f"cli_{role}", run_cli(work, role))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
