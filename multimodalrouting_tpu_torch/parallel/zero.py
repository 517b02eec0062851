"""ZeRO-1 optimizer-state sharding over the data group (counterpart of
multimodalrouting_tpu/parallel/zero.py).

Data-parallel ranks would all hold the same Adam moments. Under
``train.zero_sharded_opt=true`` each rank of a data group holds only its row
slice of ``mu`` / ``nu`` for every leaf the JAX package shards: leading
dimension divisible by the data-shard count and at least ``MIN_SHARD_SIZE``
elements. ``train/state.py:apply_gradients`` then takes that slice of the
averaged gradient, updates that slice of the parameter and all-gathers the
updated slices; the EMA stays replicated. The update arithmetic and its
``torch._foreach_*`` order are unchanged, only the placement: the
trajectory equals the replicated one to fp32 rounding (the gradient norm's
sum runs in another order).

A checkpoint holds the full moments (``gather_moments`` before a save), so a
mesh checkpoint resumes in one process and a one-process one on a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from multimodalrouting_tpu_torch.parallel.mesh import Mesh, all_gather, all_gather_into, all_reduce_

# Don't split tiny tensors (biases, LayerNorm scales): the collective costs
# more than the few KB saved. Threshold in elements.
MIN_SHARD_SIZE = 2048


def is_sharded(shape: Tuple[int, ...], n_data: int, min_size: int = MIN_SHARD_SIZE) -> bool:
    """The JAX package's rule (``zero_opt_shardings``) for one leaf."""
    return len(shape) >= 1 and shape[0] > 0 and shape[0] % n_data == 0 and math.prod(shape) >= min_size


@dataclasses.dataclass
class ZeroShards:
    """This rank's row slice of each sharded leaf, and the data group."""

    mesh: Mesh
    slices: Dict[str, slice]

    def all_finite(self, finite: bool, device) -> bool:
        """Whether every rank of the data group saw a finite slice."""
        bad = all_reduce_(torch.tensor([0.0 if finite else 1.0], device=device), self.mesh.data)
        return bool(bad.item() == 0.0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x.contiguous().clone(), self.mesh.data)

    def gather_param_(self, p: torch.Tensor, name: str) -> None:
        """Fill every rank's rows of `p` from its owner."""
        s = self.slices[name]
        all_gather_into(list(p.data.chunk(self.mesh.n_data, dim=0)), p.data[s].clone(), self.mesh.data)

    def full(self, name: str, part: torch.Tensor) -> torch.Tensor:
        return torch.cat(all_gather(part, self.mesh.data), dim=0) if name in self.slices else part


def zero_slices(shapes: Dict[str, Tuple[int, ...]], n_data: int, index: int,
                min_size: int = MIN_SHARD_SIZE) -> Dict[str, slice]:
    """Rank `index`'s row slice of every leaf that shards over `n_data`."""
    out = {}
    for name, shape in shapes.items():
        if is_sharded(tuple(shape), n_data, min_size):
            per = shape[0] // n_data
            out[name] = slice(index * per, (index + 1) * per)
    return out


def shard_optimizer_state(state, mesh: Mesh) -> None:
    """Keep only this rank's slices of the moments of `state` (full moments
    in, as created or restored), in place."""
    slices = zero_slices({n: tuple(state.mu[n].shape) for n in state.names}, mesh.n_data, mesh.data_index)
    for n, s in slices.items():
        state.mu[n] = state.mu[n][s].clone()
        state.nu[n] = state.nu[n][s].clone()
    state.zero = ZeroShards(mesh, slices)


def gather_moments(state) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The full (mu, nu) of a sharded `state`; every rank of the data group
    must call it."""
    z = state.zero
    return ({n: z.full(n, state.mu[n]) for n in state.names}, {n: z.full(n, state.nu[n]) for n in state.names})
