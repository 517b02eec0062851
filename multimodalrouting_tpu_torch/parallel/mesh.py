"""The ('data', 'model') process mesh and its collectives (counterpart of
multimodalrouting_tpu/parallel/mesh.py).

The JAX package builds its mesh from one process's devices and lets GSPMD
insert the collectives. Here one process drives one device, so the N·M
ranks of ``make_mesh(N, M)`` are the N·M processes of the world, rank r at
grid position (r // M, r % M): the data shard first, the model shard second,
as the JAX package reshapes its devices to [n_data, n_model]. Each rank
belongs to two groups:

- its **data group**: the N ranks that share its model position (they hold
  different rows of the global batch);
- its **model group**: the M ranks that share its data shard (the same rows;
  under the default 'model' role each runs BERT on its slice of the
  flattened note chunks, ``models/clinbert.py``).

What GSPMD computes on the global batch the ranks compute through a few
autograd-aware collectives, each the identity without an active mesh (as
the JAX package's ``constrain`` is a no-op without one):

- ``global_sum`` / ``global_mean`` over the data group: a sum of per-rank
  statistics whose backward is again a sum over the group;
- ``gather_chunks`` over the model group: the rank's slice of chunk
  embeddings gathered in rank order, whose backward is the reduce-scatter
  of the replicated downstream gradient (a sum over the group, then the
  rank's slice).

With that, each rank backpropagates its own loss and ``average_gradients``
averages the gradients over the whole world: a replicated global term (a
pos_weight-ed loss, a fairness ratio) and a chunk gather both come out as
the JAX global-batch gradient.

Transport: NCCL carries CUDA tensors, and gloo carries CPU tensors and,
for the all-reduce and all-gather the port uses, CUDA tensors too (how
several ranks share one card). A collective the backend refuses raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from multimodalrouting_tpu_torch.data.batches import Batch, take_batch

_ACTIVE_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_model grid of processes, with its
    groups (None outside a process group: a mesh for slicing only)."""

    n_data: int
    n_model: int = 1
    rank: int = 0
    world: Any = None
    data: Any = None
    model: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def chunk_sharding(mesh: Optional[Mesh]) -> bool:
    """Whether the note chunks are sharded over 'model', the axis's one
    role so far (tensor, GPipe and route parallelism on a mesh refuse:
    ``check_mesh_roles``)."""
    return mesh is not None and mesh.n_model > 1


def check_mesh_roles(cfg) -> None:
    """Refuse what a mesh cannot run yet: the 'model' axis's tensor, GPipe
    and route-parallel roles (ROADMAP.md §1 items 12b, 12c), and
    microbatching, whose microbatches are rows of the global batch."""
    t = cfg.train
    for flag, what in (("tensor_parallel", "tensor parallelism"), ("pipeline_parallel", "the GPipe schedule"),
                       ("route_parallel", "route parallelism")):
        if getattr(t, flag):
            raise NotImplementedError(f"{what} on a mesh (train.{flag}) is not ported yet (ROADMAP.md §1 item 12)")
    if t.microbatch > 1:
        raise NotImplementedError("train.microbatch > 1 on a mesh is not ported yet (ROADMAP.md §1 item 12)")


def launch_hint(n: int) -> str:
    return (f"launch {n} processes, one per rank: torchrun --nproc-per-node {n} -m multimodalrouting_tpu_torch.cli "
            "train ..., or set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID in each")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, batch_size: Optional[int] = None) -> Mesh:
    """The mesh over the world's processes (``init_multihost`` first), with
    its data and model groups; every rank must call it, in the same order.
    `batch_size`, where given, must split evenly over the data shards."""
    if batch_size is not None and n_data and batch_size % n_data != 0:
        raise ValueError(f"train.batch_size={batch_size} must be divisible by train.num_data_shards={n_data}")
    if not dist.is_initialized():
        raise RuntimeError(f"a {n_data or '?'}x{n_model} mesh needs a process group: "
                           f"{launch_hint((n_data or 1) * n_model)}")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} processes; the world has {world}")
    data, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + j for d in range(n_data)] for j in range(n_model)])
    model, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + j for j in range(n_model)] for d in range(n_data)])
    return Mesh(n_data, n_model, dist.get_rank(), dist.group.WORLD, data, model)


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


# --- collectives -------------------------------------------------------------


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of a contiguous tensor over `group`."""
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` (same shape on all), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def all_gather_into(out: List[torch.Tensor], x: torch.Tensor, group) -> None:
    """`out[i]` = rank i's `x`: `out` may be views of one tensor (row chunks)."""
    dist.all_gather(out, x.contiguous(), group=group)


def warmup_collectives(mesh: Mesh, device, log_fn: Callable[[str], None] = print) -> None:
    """Create the world, data and model communicators while the ranks are
    in lockstep: each collective the port uses runs once on each group, on
    `device`, the world's all-reduce first."""
    device = torch.device(device)
    for group in (mesh.world, mesh.data, mesh.model):
        all_reduce_(torch.ones(2, device=device), group)
        all_gather(torch.ones(2, device=device), group)
    if device.type == "cuda":
        log_fn(f"[mesh] {dist.get_backend()} on {device}: all_reduce and all_gather on CUDA tensors, "
               f"{mesh.n_data}x{mesh.n_model}")


# --- autograd-aware collectives -------------------------------------------------


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        return torch.cat(all_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[ctx.index * ctx.rows : (ctx.index + 1) * ctx.rows], None, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data group (the identity without a mesh); its backward
    sums the gradient over the group."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    return _GroupSum.apply(x, mesh.data)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the data group of equal-size shards' statistics: the
    global-batch value of a per-shard mean."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    return global_sum(x) / mesh.n_data


def gather_chunks(x: torch.Tensor) -> torch.Tensor:
    """Every model-group rank's rows of `x` (equal counts), concatenated in
    rank order; the backward hands each rank its rows of the summed
    gradient."""
    mesh = _ACTIVE_MESH
    return _GatherRows.apply(x, mesh.model, mesh.model_index)


def average_gradients(grads: List[torch.Tensor]) -> None:
    """Average `grads` over the whole world in place: one all-reduce per
    dtype over a flat buffer."""
    mesh = _ACTIVE_MESH
    if mesh is None or not grads:
        return
    world = dist.get_world_size(mesh.world)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in same]), mesh.world)
        flat.div_(world)
        for f, g in zip(flat.split([g.numel() for g in same]), same):
            g.copy_(f.view_as(g))


def data_rows(b: int) -> tuple:
    """(global rows, this rank's first row) of a local batch of `b` rows."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return b, 0
    return b * mesh.n_data, b * mesh.data_index


# --- batches ------------------------------------------------------------------


def shard_batch(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's rows of a global host `batch`: the data shard's
    contiguous block, as the JAX package's batch sharding over 'data' lays
    rows out."""
    n = batch.batch_size
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.n_data} data shards")
    per = n // mesh.n_data
    return take_batch(batch, slice(mesh.data_index * per, (mesh.data_index + 1) * per))


def host_gather(x: Optional[torch.Tensor], mesh: Optional[Mesh]) -> Optional[np.ndarray]:
    """`x` on the host; on a mesh every data shard's rows, in order, so that
    every rank holds the global tensor."""
    if x is None:
        return None
    if mesh is not None:
        x = torch.cat(all_gather(x, mesh.data), dim=0)
    return x.detach().cpu().numpy()
