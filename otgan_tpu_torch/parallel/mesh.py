"""Process groups for data-parallel training (counterpart of
``otgan_tpu/parallel/mesh.py``).

One process per GPU, launched by ``torchrun --nproc_per_node K``. Where the
JAX package builds a 1-D device mesh, shards the batch along it and
replicates the state, the port has

* :func:`init_from_env`: join torchrun's group (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``): NCCL on ``cuda:LOCAL_RANK``, gloo when the caller asks
  for the CPU;
* :func:`local_rows`, the counterpart of ``shard_batch``: every rank holds
  the GLOBAL batch (drawn from the same seeded generators) and keeps its
  contiguous rows ``[k B/K, (k+1) B/K)``, so a K-rank run sees the data of
  a 1-device run;
* :func:`replicate`: rank 0's tensors broadcast to every rank, with the
  largest difference any rank had from them before.

The collectives on row blocks use ``all_gather_into_tensor`` and
``reduce_scatter_tensor``: newer PyTorch names them ``*_single`` and warns,
but the older releases on the GPU machines have only these names.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

ProcessGroup = Optional[dist.ProcessGroup]  # None = the default group


def init_from_env(device="cuda") -> torch.device:
    """This process's device, after joining torchrun's process group when
    ``WORLD_SIZE`` is set (a plain run has no group and keeps ``device``).
    ``--num_devices`` is checked against the group by the engine."""
    kind = torch.device(device).type
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    if kind == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if kind == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
        )
    return dev


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
