"""Whole-loop Sinkhorn on matrices held in shared memory: the small-matrix
tier of ``sinkhorn_assignment(use_pallas=True)``, in a hand-written CUDA
kernel for Hopper.

Replaces ``otgan_tpu/ops/sinkhorn_pallas.py::_sinkhorn_kernel`` (through
``_sinkhorn_pallas_batched``). One launch per match reads the costs once,
runs the whole ``n_iters`` loop with the logits in shared memory, and writes
the row-softmax assignment P and the mean row entropy; the kernel is
``csrc/sinkhorn_resident.cu``, its design and bound in its header. A
thread-block cluster of ``cs`` blocks owns one matrix, each block a band of
whole rows.

:func:`resident_supported` is the counterpart of ``pallas_supported``: the
TPU's ceiling of 768^2 cells, and a band that fits one block's shared memory
with the largest cluster. The TPU's (8, 128) tile alignment has no
counterpart: the kernel masks ragged edges by bounds.

:func:`sinkhorn_resident` takes the plain version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises; a failed build,
launch or cluster-occupancy query is an error, never a move to another path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy
from otgan_tpu_torch.ops.sinkhorn_cuda import col_potential_plain, scaled_logits

# the TPU kernel's residency ceiling (ops/sinkhorn_pallas.py:44)
MAX_CELLS = 768 * 768
# the kernel's constants (csrc/sinkhorn_resident.cu, which checks the plan
# again and refuses what does not fit): threads a block, the largest
# (non-portable) cluster, shared memory a block may use on sm_90
THREADS = 512
MAX_CLUSTER = 16
MAX_SMEM = 232448
# blocks a cluster by matrix height: of every size from 1 to 16, 8 was the
# fastest at 6 x 128^2 and 6 x 256^2, and 16 at 6 x 512^2 and 6 x 768^2 on an
# H100 (measure_resident.py at the repo root; numbers in PERF.md)
CLUSTER_SMALL, CLUSTER_LARGE, SMALL_ROWS = 8, 16, 256

# launches of the CUDA kernel (one per match) and of the plain version;
# chip_smoke.py zeroes them around its paths
launches = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def smem_bytes(band: int, m: int) -> int:
    """Shared memory of one block (``smem_floats`` of the kernel): the band
    of x, v, two parities of (max, sum) partials, u, and the entropy sums."""
    return 4 * (band * m + 5 * m + band + THREADS // 32 + 1)


def resident_plan(n: int, m: int, cluster_size: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """``(cluster size, band rows)`` for an ``(n, m)`` matrix, or ``None``
    when the kernel cannot hold it. The default cluster is 8 blocks up to
    256 rows and 16 above (never more blocks than rows), or the smallest
    that fits shared memory, whichever is larger."""
    if n < 1 or m < 1 or n * m > MAX_CELLS:
        return None
    sizes = [cluster_size] if cluster_size else range(1, MAX_CLUSTER + 1)
    fits = [cs for cs in sizes
            if 1 <= cs <= MAX_CLUSTER and smem_bytes(-(-n // cs), m) <= MAX_SMEM]
    if not fits:
        return None
    cs = fits[0] if cluster_size else max(
        fits[0], min(n, CLUSTER_SMALL if n <= SMALL_ROWS else CLUSTER_LARGE))
    return cs, -(-n // cs)


def resident_supported(n: int, m: int) -> bool:
    """The kernel holds an ``(n, m)`` matrix: at most 768^2 cells, and a
    band of ``ceil(n / 16)`` rows fits one block's shared memory."""
    return resident_plan(n, m) is not None


def sinkhorn_resident_plain(cost: torch.Tensor, lam: float, n_iters: int):
    """Eager-torch version of the kernel: cost ``(b, N, M)`` -> (P, entropy
    ``(b,)``), from the same row-shifted logits."""
    x = scaled_logits(cost, lam)
    v = col_potential_plain(x, n_iters)
    return assignment_and_entropy(x + v[:, None, :])


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("sinkhorn_resident")
    fn = lib.otgan_resident_sinkhorn
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.otgan_resident_error_string.argtypes = [ctypes.c_int]
    lib.otgan_resident_error_string.restype = ctypes.c_char_p
    return lib


def sinkhorn_resident_cuda(cost: torch.Tensor, lam: float, n_iters: int,
                           cluster_size: Optional[int] = None):
    """Launch the kernel on contiguous float32 costs ``(b, N, M)`` on the
    card; returns (P ``(b, N, M)``, entropy ``(b,)``). ``cluster_size``
    overrides the planned cluster (a measurement sweeps it). Raises on a
    shape the kernel cannot hold and on a refused launch."""
    if not (cost.is_cuda and cost.dtype == torch.float32 and cost.dim() == 3
            and cost.is_contiguous()):
        raise ValueError(
            "sinkhorn_resident_cuda needs a contiguous (b, N, M) float32 CUDA "
            f"tensor, got {cost.dtype} {tuple(cost.shape)} on {cost.device}"
        )
    b, n, m = cost.shape
    plan = resident_plan(n, m, cluster_size)
    if plan is None or n_iters < 0 or not 1 <= b <= 65535:
        raise ValueError(f"the resident kernel cannot hold {tuple(cost.shape)} "
                         f"(cluster {cluster_size}, n_iters {n_iters})")
    lib = _bind()
    with torch.cuda.device(cost.device):
        p = torch.empty_like(cost)
        ent = torch.empty((b,), device=cost.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = lib.otgan_resident_sinkhorn(cost.data_ptr(), p.data_ptr(), ent.data_ptr(),
                                          b, n, m, plan[0], lam, n_iters, stream)
    if err != 0:
        msg = lib.otgan_resident_error_string(err).decode()
        raise RuntimeError(f"resident Sinkhorn CUDA kernel failed at {tuple(cost.shape)}, "
                           f"cluster {plan[0]}: {msg} ({err})")
    launches["kernel"] += 1
    return p, ent


@torch.no_grad()
def sinkhorn_resident(cost: torch.Tensor, lam: float, n_iters: int):
    """Cost ``(..., N, M)`` -> (P ``(..., N, M)``, entropy ``(...)``): the
    CUDA kernel for a tensor on the card, the plain version for one on the
    CPU."""
    n, m = cost.shape[-2:]
    batch_shape = cost.shape[:-2]
    c = cost.detach().float().reshape(-1, n, m)
    if c.is_cuda:
        p, ent = sinkhorn_resident_cuda(c.contiguous(), lam, n_iters)
    elif c.device.type == "cpu":
        launches["plain"] += 1
        p, ent = sinkhorn_resident_plain(c, lam, n_iters)
    else:
        raise ValueError(f"no Sinkhorn kernel for device {cost.device}")
    return p.reshape(cost.shape), ent.reshape(batch_shape)
