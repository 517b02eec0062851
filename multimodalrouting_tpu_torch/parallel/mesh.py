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
- its **model group**: the M ranks that share its data shard (the same rows).

The 'model' axis has one of four roles (``Mesh.role``, from the config by
``mesh_role``; each excludes the others, as in the JAX package):

- ``chunks`` (the default): each rank of a model group runs BERT on its
  slice of the flattened note chunks (``models/clinbert.py``);
- ``tensor`` (``train.tensor_parallel``, ``parallel/tp.py``): the BERT
  layers' weights are split Megatron-style over the model group;
- ``route`` (``train.route_parallel``, ``parallel/ep.py``): the stacked
  6-stream MulT cross programs are split on their stream axis;
- ``pipeline`` (``train.pipeline_parallel``, ``parallel/pp.py``): rank j
  holds stage j, a contiguous slice of the stacked BERT layers, and the
  note chunks flow through the stages as GPipe microbatches.

Under ``tensor``, ``route`` and ``pipeline`` the chunk axis takes 'data'
only, and ``place_state`` (the counterpart of the JAX package's
``param_state_shardings``) keeps this rank's slice of each parameter a
role's ``spec_for_name`` shards, and of its moments and EMA
(``ModelShards``).

What GSPMD computes on the global batch the ranks compute through a few
autograd-aware collectives, each the identity without an active mesh (as
the JAX package's ``constrain`` is a no-op without one):

- ``global_sum`` / ``global_mean`` over the data group: a sum of per-rank
  statistics whose backward is again a sum over the group;
- ``gather_chunks`` over the model group: the rank's slice of chunk
  embeddings gathered in rank order, whose backward is the reduce-scatter
  of the replicated downstream gradient (a sum over the group, then the
  rank's slice);
- ``copy_to_model_group`` (Megatron's *f*: identity forward, sum over the
  model group backward), ``reduce_from_model_group`` (Megatron's *g*: sum
  forward, identity backward) and ``gather_streams`` (the model group's
  stream slices gathered forward; this rank's slice of the gradient
  backward), the collectives of the ``tensor`` and ``route`` roles; the
  ``pipeline`` role's schedule uses *f* and *g* too, and ``exchange``, the
  point-to-point hop between neighbouring stages.

With that, each rank backpropagates its own loss and ``average_gradients``
averages the gradients over the whole world, but for the model-sharded
slices, which it averages over the data group: a replicated global term (a
pos_weight-ed loss, a fairness ratio), a chunk gather and a model-sharded
layer all come out as the JAX global-batch gradient.

Transport: NCCL carries CUDA tensors, and gloo carries CPU tensors and,
for the all-reduce and all-gather the port uses, CUDA tensors too (how
several ranks share one card). Gloo's point-to-point send and receive hand
a tensor's pointer to its TCP transport, so ``exchange`` stages a CUDA
tensor through host memory under gloo. A collective the backend refuses
raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodalrouting_tpu_torch.data.batches import Batch, take_batch

_ACTIVE_MESH: Optional["Mesh"] = None

ROLES = ("chunks", "tensor", "route", "pipeline")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_model grid of processes, with its
    groups (None outside a process group: a mesh for slicing only) and the
    'model' axis's role (``ROLES``)."""

    n_data: int
    n_model: int = 1
    rank: int = 0
    world: Any = None
    data: Any = None
    model: Any = None
    role: str = "chunks"

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def mesh_role(cfg) -> str:
    """The 'model' axis's role a config asks for: ``tensor`` under
    ``train.tensor_parallel``, ``route`` under ``train.route_parallel``,
    ``pipeline`` under ``train.pipeline_parallel``, else ``chunks`` (the
    JAX package's ``set_tp_mode`` / ``set_ep_mode`` / ``set_pp_mode``, kept
    on the mesh instead of in module globals)."""
    t = cfg.train
    if t.tensor_parallel:
        return "tensor"
    if t.route_parallel:
        return "route"
    return "pipeline" if t.pipeline_parallel else "chunks"


def chunk_sharding(mesh: Optional[Mesh]) -> bool:
    """Whether the note chunks are sharded over 'model': more than one model
    shard under the ``chunks`` role (the other roles use the axis for
    weights, and their chunks take 'data' only)."""
    return mesh is not None and mesh.n_model > 1 and mesh.role == "chunks"


def role_mesh(role: str) -> Optional[Mesh]:
    """The active mesh where its 'model' axis has `role`, else None."""
    mesh = _ACTIVE_MESH
    return mesh if mesh is not None and mesh.role == role else None


def launch_hint(n: int) -> str:
    return (f"launch {n} processes, one per rank: torchrun --nproc-per-node {n} -m multimodalrouting_tpu_torch.cli "
            "train ..., or set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID in each")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, batch_size: Optional[int] = None,
              role: str = "chunks") -> Mesh:
    """The mesh over the world's processes (``init_multihost`` first), with
    its data and model groups and the 'model' axis's `role`; every rank must
    call it, in the same order. `batch_size`, where given, must split evenly
    over the data shards."""
    if role not in ROLES:
        raise ValueError(f"mesh role {role!r}: one of {ROLES}")
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
    return Mesh(n_data, n_model, dist.get_rank(), dist.group.WORLD, data, model, role)


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


# --- collectives -------------------------------------------------------------


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place sum (or `op`) of a contiguous tensor over `group`."""
    dist.all_reduce(x, op=op, group=group)
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


def exchange(send: Optional[torch.Tensor], dst: Optional[int], recv: Optional[torch.Tensor],
             src: Optional[int]) -> None:
    """Point-to-point on the world: `send` to world rank `dst` and `recv`
    (filled in place) from world rank `src`, either of them None, posted
    together and both waited on. Under gloo a CUDA tensor goes through a
    host copy each way (gloo's transport reads host memory); NCCL moves
    CUDA tensors as they are."""
    staged = dist.get_backend() == "gloo"
    ops, host = [], None
    if recv is not None:
        host = torch.empty(recv.shape, dtype=recv.dtype) if staged and recv.is_cuda else recv
        ops.append(dist.P2POp(dist.irecv, host, src))
    if send is not None:
        out = send.detach().to("cpu") if staged and send.is_cuda else send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, out, dst))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    if host is not None and host is not recv:
        recv.copy_(host)


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


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.rows = index, x.shape[0]
        return torch.cat(all_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
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
    gradient. The chunks feed replicated parameters (BERT under the
    ``chunks`` role): each rank's BERT gradient is then M times its slice's,
    and the world average in ``average_gradients`` divides the M out."""
    mesh = _ACTIVE_MESH
    return _GatherRows.apply(x, mesh.model, mesh.model_index)


def copy_to_model_group(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f* on the active mesh's model group: the identity
    forward; the backward sums the gradient over the group. `x` is
    replicated over the group (the same value on every rank) and feeds this
    rank's slice of a model-sharded computation, so each rank's gradient of
    `x` covers its slice only; their sum is the whole gradient, the same on
    every rank, as the replicated parameters upstream need for the world
    average of ``average_gradients``."""
    mesh = _ACTIVE_MESH
    return _CopyToGroup.apply(x, mesh.model)


def reduce_from_model_group(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g* on the active mesh's model group: the sum of the
    ranks' partial results forward (a row-parallel product), the identity
    backward. The sum is replicated and so is the loss downstream: every
    rank receives the whole gradient of the sum, which is the gradient of
    its partial result, so this rank's weight slice gets its own gradient
    (averaged over the data group only by ``average_gradients``)."""
    mesh = _ACTIVE_MESH
    return _ReduceFromGroup.apply(x, mesh.model)


def gather_streams(x: torch.Tensor) -> torch.Tensor:
    """Every model-group rank's leading-axis slice of `x` (a stack of MulT
    streams, equal counts), concatenated in rank order; the backward hands
    this rank its slice of the gradient, unsummed: the gathered streams feed
    replicated computation, so every rank holds the same whole gradient and
    its slice is its streams' own (their parameters are averaged over the
    data group only by ``average_gradients``)."""
    mesh = _ACTIVE_MESH
    return _GatherSlices.apply(x, mesh.model, mesh.model_index)


def stream_slice(g: int, mesh: Mesh) -> slice:
    """Model-group rank's share of `g` stacked streams: a contiguous slice
    of g / n_model (``parallel/ep.py:validate_ep`` checks the division)."""
    per = g // mesh.n_model
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def slice_generator(generator: Optional[torch.Generator], index: int) -> Optional[torch.Generator]:
    """The dropout generator of model-group rank `index`'s slice (its chunks,
    heads or streams): seeded from the state of the group's shared
    `generator` and `index`, so that each slice draws its own masks; the
    shared generator then advances alike on every rank of the group."""
    if generator is None:
        return None
    state = generator.get_state().numpy().tobytes() + index.to_bytes(4, "little")
    seed = int.from_bytes(hashlib.blake2b(state, digest_size=8).digest(), "little")
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _average(grads: List[torch.Tensor], group, n: int) -> None:
    """Sum `grads` over `group` and divide by `n`, in place: one all-reduce
    per dtype over a flat buffer."""
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in same]), group)
        flat.div_(n)
        for f, g in zip(flat.split([g.numel() for g in same]), same):
            g.copy_(f.view_as(g))


def average_gradients(grads: List[torch.Tensor], model_sharded: Sequence[bool] = ()) -> None:
    """Average `grads` in place: over the whole world, but for those that
    `model_sharded` marks (this rank's slices of model-sharded leaves,
    ``ModelShards``), which are averaged over the data group only: the
    model group's ranks hold different slices, and a sum over it would add
    the gradients of different parameters."""
    mesh = _ACTIVE_MESH
    if mesh is None or not grads:
        return
    flags = list(model_sharded) or [False] * len(grads)
    replicated = [g for g, s in zip(grads, flags) if not s]
    if replicated:
        _average(replicated, mesh.world, dist.get_world_size(mesh.world))
    sharded = [g for g, s in zip(grads, flags) if s]
    if sharded:
        _average(sharded, mesh.data, mesh.n_data)


# --- placement of model-sharded parameters --------------------------------------


def local_slice(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Model-group rank's contiguous slice of `x` along `dim`."""
    per = x.shape[dim] // mesh.n_model
    return x.narrow(dim, mesh.model_index * per, per)


@dataclasses.dataclass
class ModelShards:
    """The parameters sharded over the model group (name -> the dimension
    split), and the mesh. A state that holds one keeps this rank's slice of
    each such parameter, of its moments and of its EMA."""

    mesh: Mesh
    dims: Dict[str, int]

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor of parameter `name`."""
        d = self.dims.get(name)
        return full if d is None else local_slice(full, d, self.mesh).contiguous()

    def full(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The full tensor of `name` from the model group's slices; every
        rank of the group must call it."""
        d = self.dims.get(name)
        return part if d is None else torch.cat(all_gather(part, self.mesh.model), dim=d)

    def full_dict(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self.full(n, v) for n, v in tensors.items()}

    def sum_squares(self, sq: torch.Tensor, names: Iterable[str]) -> torch.Tensor:
        """Per-leaf sums of squares `sq` of this rank's slices, each sharded
        leaf's summed over the model group (its slices counted once each),
        the replicated ones as they are."""
        sharded = torch.tensor([n in self.dims for n in names], device=sq.device)
        return torch.where(sharded, all_reduce_(sq.contiguous().clone(), self.mesh.model), sq)


def shard_dims(names: Iterable[str], shapes: Dict[str, Sequence[int]], spec_for_name: Callable,
               n_model: int) -> Dict[str, int]:
    """{name: dimension} of the parameters `spec_for_name` shards."""
    dims = {}
    for name in names:
        d = spec_for_name(name)
        if d is not None:
            if shapes[name][d] % n_model:
                raise ValueError(f"{name} {tuple(shapes[name])} does not split over {n_model} model shards "
                                 f"on dimension {d}")
            dims[name] = d
    return dims


def local_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh, spec_for_name: Callable) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full state_dict `sd`: the keys `spec_for_name`
    shards sliced, the rest as they are."""
    shards = ModelShards(mesh, shard_dims(sd, {k: v.shape for k, v in sd.items()}, spec_for_name, mesh.n_model))
    return {k: shards.local(k, v) for k, v in sd.items()}


def place_state(state, mesh: Mesh, spec_for_name: Callable) -> ModelShards:
    """Keep only this rank's slices of the parameters `spec_for_name` shards
    (the JAX package's ``param_state_shardings``): the model's parameters,
    their moments and their EMA, in place, from the full ones (as created or
    restored); the rest stays replicated. Sets and returns ``state.shards``.
    ZeRO-1 (``parallel/zero.py``) composes after it, on the local leaves."""
    named = dict(state.model.named_parameters())
    shards = ModelShards(mesh, shard_dims(named, {n: p.shape for n, p in named.items()}, spec_for_name,
                                          mesh.n_model))
    with torch.no_grad():
        for n, d in shards.dims.items():
            named[n].data = shards.local(n, named[n].data)
            for moments in (state.mu, state.nu, state.ema or {}):
                if n in moments:
                    moments[n] = shards.local(n, moments[n])
    state.shards = shards
    return shards


def data_rows(b: int) -> tuple:
    """(global rows, this rank's first row) of a local batch of `b` rows."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return b, 0
    return b * mesh.n_data, b * mesh.data_index


# --- batches ------------------------------------------------------------------


def shard_batch(batch: Batch, mesh: Mesh, microbatch: int = 1) -> Batch:
    """This rank's rows of a global host `batch`. The JAX step's microbatch
    i of ``train.microbatch`` = k is rows [i·mb, (i+1)·mb) of the global
    batch, mb = n // k (the rows past k·mb unused); the local batch is, for
    each i in turn, the data shard's slice of the N equal slices of that
    microbatch, so that the step's local microbatch i (``train/steps.py``)
    is global microbatch i's d-th slice and the data group's global
    statistics are its. At k = 1 that is the data shard's contiguous block,
    as the JAX package's batch sharding over 'data' lays rows out."""
    n, n_data, d = batch.batch_size, mesh.n_data, mesh.data_index
    k = max(microbatch, 1)
    mb = n // k
    if mb % n_data:
        raise ValueError(f"microbatches of {mb} rows (a batch of {n} rows in {k}) do not split over "
                         f"{n_data} data shards")
    per = mb // n_data
    rows = (np.arange(k)[:, None] * mb + d * per + np.arange(per)[None, :]).reshape(-1)
    return take_batch(batch, rows)


def host_gather(x: Optional[torch.Tensor], mesh: Optional[Mesh]) -> Optional[np.ndarray]:
    """`x` on the host; on a mesh every data shard's rows, in order, so that
    every rank holds the global tensor."""
    if x is None:
        return None
    if mesh is not None:
        x = torch.cat(all_gather(x, mesh.data), dim=0)
    return x.detach().cpu().numpy()
