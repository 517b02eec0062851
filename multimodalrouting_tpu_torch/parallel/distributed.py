"""Multi-process initialisation (counterpart of
multimodalrouting_tpu/parallel/distributed.py).

One process drives one device, as torch does: the N·M ranks of a
``data=N,model=M`` mesh (``parallel/mesh.py``) are N·M processes. A process
joins the run through ``init_multihost``, which reads the same variables as
the JAX package, so that one job script serves both packages, and then
torchrun's:

1. explicit arguments;
2. ``JAX_COORDINATOR_ADDRESS`` (host:port), ``JAX_NUM_PROCESSES`` and
   ``JAX_PROCESS_ID``;
3. ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (with
   ``LOCAL_RANK``), as ``torchrun --nproc-per-node`` sets them.

The JAX package's TPU pod auto-detect (``TPU_WORKER_HOSTNAMES``) has no
counterpart and raises.

The backend: NCCL on ``cuda:LOCAL_RANK`` where each rank has a card of its
own; gloo on the CPU. Several ranks share one card only when the caller
passes ``backend="gloo"`` (gloo carries CUDA tensors; NCCL refuses two ranks
on one device). No path moves a rank to the CPU or to another backend.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
) -> bool:
    """Join the process group of a multi-process run; a no-op (False) in a
    single process. `device` is the ranks' device type (``cuda`` where a
    card is present, else ``cpu``); on ``cuda`` the rank's card becomes the
    current device, so that ``"cuda"`` means it. Returns True once the group
    is up and every rank has passed a first collective."""
    if dist.is_initialized():
        return True
    coord = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else _int_env("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    local_rank = _int_env("LOCAL_RANK")
    if not (coord and nproc and pid is not None):
        if os.environ.get("MASTER_ADDR") and _int_env("WORLD_SIZE") and _int_env("RANK") is not None:
            coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
            nproc, pid = _int_env("WORLD_SIZE"), _int_env("RANK")
        elif os.environ.get("TPU_WORKER_HOSTNAMES"):
            raise ValueError(
                "TPU_WORKER_HOSTNAMES is set: TPU pod auto-detect has no counterpart on GPUs; launch with "
                "torchrun --nproc-per-node, or set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID"
            )
        else:
            return False
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
    where = "cpu"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested, but torch sees no CUDA card")
        cards = torch.cuda.device_count()
        if local_rank is None:
            local_rank = pid % cards
        if backend == "nccl" and local_rank >= cards:
            raise ValueError(
                f"local rank {local_rank} has no card of its own ({cards} cards): NCCL needs one card per "
                "rank; pass backend='gloo' to share a card"
            )
        card = local_rank % cards
        torch.cuda.set_device(card)
        where = f"cuda:{card}"
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
    if backend == "gloo" and device == "cuda":
        local_world = _int_env("LOCAL_WORLD_SIZE") or nproc
        sharing = sum(1 for r in range(local_world) if r % torch.cuda.device_count() == card)
        log_fn(f"[distributed] backend gloo, {sharing} ranks on {where}")
    _warmup_world(torch.device(where))
    return True


def _warmup_world(device: torch.device) -> None:
    """One all-reduce over the world while the processes are in lockstep
    from the rendezvous (the JAX package's ``_warmup_world``): it creates
    the world's communicator before any rank starts its long first step."""
    x = torch.ones(1, device=device)
    dist.all_reduce(x)
    if int(x.item()) != dist.get_world_size():
        raise RuntimeError(f"world all-reduce gave {x.item()}, expected {dist.get_world_size()}")


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None

