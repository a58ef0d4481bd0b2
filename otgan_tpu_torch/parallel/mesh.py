"""Process groups for data-parallel training (counterpart of
``otgan_tpu/parallel/mesh.py``).

One process per GPU. Where the JAX package builds a 1-D device mesh, shards
the batch along it and replicates the state, the port has

* :func:`init_from_env`: join the process group. Under ``torchrun``
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL on ``cuda:LOCAL_RANK``,
  gloo when the caller asks for the CPU. A manual multi-host launch (the
  JAX flags ``--coordinator_address host:port --num_processes P
  --process_id i``, no torchrun) joins ``tcp://host:port`` as rank ``i`` of
  ``P``, one card a process;
* :func:`process_index` / :func:`process_count`: the JAX package's
  processes, which hold disjoint data shards under ``--multihost``: under
  ``torchrun`` a node (``WORLD_SIZE / LOCAL_WORLD_SIZE`` of them, ranks
  numbered node by node), in a manual launch each process;
* :func:`local_rows`, the counterpart of ``shard_batch``: a rank keeps its
  contiguous rows ``[k B/K, (k+1) B/K)`` of a batch. Under one process
  every rank holds the GLOBAL batch (drawn from the same seeded
  generators), so a K-rank run sees the data of a 1-device run; under
  ``--multihost`` the ranks of a process share its batch and keep their
  rows of it, which are their rows of the global batch;
* :func:`replicate`: rank 0's tensors broadcast to every rank, with the
  largest difference any rank had from them before.

The collectives on row blocks use ``all_gather_into_tensor`` and
``reduce_scatter_tensor``: newer PyTorch names them ``*_single`` and warns,
but the older releases on the GPU machines have only these names. Every
collective here is synchronous (``async_op=False``), ordered on the current
stream, and allocates its output on it, so a CUDA graph of a cycle captures
the step's collectives as they stand (``--fused_cycle`` on K ranks);
``replicate`` runs at init, eagerly.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

ProcessGroup = Optional[dist.ProcessGroup]  # None = the default group


def init_from_env(device="cuda", coordinator_address: str = "", num_processes: int = 0,
                  process_id: int = -1) -> torch.device:
    """This process's device, after joining the process group: torchrun's
    when ``WORLD_SIZE`` is set, else the manual launch's when
    ``coordinator_address`` is given (``num_processes`` ranks, this one
    ``process_id``, on ``cuda:process_id % cards``); a plain run has no
    group and keeps ``device``. ``--num_devices`` is checked against the
    group by the engine."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    backend = "nccl" if kind == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if coordinator_address:
            raise ValueError("--coordinator_address is for a launch without torchrun; under "
                             "torchrun the group comes from its environment")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        group_rank = os.environ.get("GROUP_RANK")
        if world % local_world or (group_rank is not None
                                   and rank // local_world != int(group_rank)):
            raise ValueError(f"rank {rank} of {world} is not rank {rank % local_world} of node "
                             f"{group_rank} ({local_world} a node): nodes must have equal "
                             "--nproc_per_node")
        local = int(os.environ["LOCAL_RANK"])
        init = {}
    elif coordinator_address:
        if num_processes < 1 or not 0 <= process_id < num_processes:
            raise ValueError(f"a manual launch needs --num_processes P >= 1 and --process_id in "
                             f"[0, P); got {num_processes} and {process_id}")
        rank, world = process_id, num_processes
        local = process_id % torch.cuda.device_count() if kind == "cuda" else 0
        init = {"init_method": f"tcp://{coordinator_address}"}
    else:
        return torch.device(device)
    dev = torch.device("cpu")
    if kind == "cuda":
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world, **init)
    return dev


def _local_world_size() -> int:
    """Ranks a process: torchrun's ``LOCAL_WORLD_SIZE``, else 1."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def process_count() -> int:
    """The run's processes in the JAX package's sense (its hosts): torchrun's
    nodes, or the processes of a manual launch; 1 without a group."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size() // _local_world_size()


def process_index() -> int:
    """This process's index among :func:`process_count` (its node under
    torchrun); 0 without a group."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank() // _local_world_size()


def rank_and_size(group: ProcessGroup = None) -> Tuple[int, int]:
    """``(rank, world size)`` in ``group``; ``(0, 1)`` without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_rows(x, rank: int, size: int):
    """Rank ``rank``'s contiguous block of the global batch ``x`` (any array
    or tensor with the batch first)."""
    n = x.shape[0]
    if n % size != 0:
        raise ValueError(
            f"global batch {n} must be divisible by the {size} ranks"
        )
    b = n // size
    return x[rank * b:(rank + 1) * b]


def all_gather_rows(t: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0, in rank order."""
    size = dist.get_world_size(group)
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter_rows(t: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Sum ``t`` over the ranks and keep this rank's block of dim 0."""
    size = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] // size,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def all_reduce_sum(tensors: Iterable[torch.Tensor], group: ProcessGroup) -> None:
    """Sum each tensor over the ranks in place, in one collective."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], group: ProcessGroup) -> float:
    """Overwrite every rank's ``tensors`` with rank 0's (in place). Returns
    the largest absolute difference any rank had from rank 0 before."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    src = flat.clone()
    dist.broadcast(src, dist.get_global_rank(group, 0) if group else 0, group=group)
    diff = (flat - src).abs().max().reshape(1)
    dist.all_reduce(diff, op=dist.ReduceOp.MAX, group=group)
    offset = 0
    for t in tensors:
        t.copy_(src[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return float(diff)
