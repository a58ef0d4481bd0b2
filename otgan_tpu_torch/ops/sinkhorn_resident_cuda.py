"""Whole-loop Sinkhorn on matrices held by one thread-block cluster: the
small-matrix tier of ``sinkhorn_assignment(use_pallas=True)``, in a
hand-written CUDA kernel for Hopper.

Replaces ``otgan_tpu/ops/sinkhorn_pallas.py::_sinkhorn_kernel`` (through
``_sinkhorn_pallas_batched``). One launch per match reads the costs once,
runs the whole ``n_iters`` loop on the cluster's SMs, and writes the
row-softmax assignment P and the mean row entropy; the kernel is
``csrc/sinkhorn_resident.cu``, its design and bound in its header. A
thread-block cluster of ``cs`` blocks owns one matrix, each block a band of
whole rows, each warp of a block whole rows of its band.

:func:`resident_plan` is pure Python, so the CPU tests reach it: cluster
size, band, where x lives (registers or shared memory), threads a column in
the folds, how the column values cross the cluster, and the shared memory
of a block. The kernel computes the same plan and refuses a launch whose
plan differs.

:func:`resident_supported` is the counterpart of ``pallas_supported``: the
TPU's ceiling of 768^2 cells, rows of at most 768 columns, and a plan that
fits one block's shared memory with the largest cluster. The TPU's (8, 128)
tile alignment has no counterpart: the kernel masks ragged edges by bounds.

:func:`sinkhorn_resident` takes the plain version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises; a failed build,
launch or cluster-occupancy query is an error, never a move to another path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy
from otgan_tpu_torch.ops.sinkhorn_cuda import col_potential_plain, scaled_logits

# the TPU kernel's residency ceiling (ops/sinkhorn_pallas.py:44)
MAX_CELLS = 768 * 768
# the kernel's constants (csrc/sinkhorn_resident.cu, which computes the plan
# again and refuses one that differs): warps a block, the largest
# (non-portable) cluster, float4 columns a lane (rows up to 768 columns), x
# in registers up to this many cells a thread, shared memory a block may use
# on sm_90
WARPS = 16
THREADS = 32 * WARPS
MAX_CLUSTER = 16
MAX_QUADS = 6
REG_CELLS = 16
MAX_SMEM = 232448
# blocks a cluster by matrix height: of every size from 1 to 16, 8 was the
# fastest at 6 x 128^2 (0.724 ms, 9 next at 0.759), and 16 at 6 x 256^2
# (1.437; 8 next at 1.508), 6 x 384^2, 6 x 512^2 and 768^2 on an H100 80GB
# HBM3 at 700 W (measure_resident.py at the repo root; PERF.md)
CLUSTER_SMALL, CLUSTER_LARGE, SMALL_ROWS = 8, 16, 128

# launches of the CUDA kernel (one per match) and of the plain version;
# chip_smoke.py zeroes them around its paths
launches = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


class ResidentPlan(NamedTuple):
    """How one cluster holds an ``(n, m)`` matrix: ``cluster`` blocks of
    ``band`` rows; ``quads`` float4 columns a lane; ``reg_rows`` rows a
    warp with x in registers (0: x in shared memory); ``push``: every
    block receives every column's value an iteration (one bulk copy from
    each block, counted on an mbarrier, no cluster barrier), else only its
    slice of columns (two cluster barriers an iteration); ``smem`` bytes of
    shared memory a block."""

    cluster: int
    band: int
    quads: int
    reg_rows: int
    push: bool
    smem: int


def value_stride(m: int, value_bytes: int) -> int:
    """Row stride, in values, of the kernel's per-warp and per-block column
    values: m rounded up to a 128-byte line."""
    line = 128 // value_bytes
    return -(-m // line) * line


def smem_bytes(band: int, m: int, cluster: int, reg_rows: int, push: bool) -> int:
    """Shared memory of one block (``smem_bytes`` of the kernel): x where it
    is not in registers (rows padded to 4 floats), v, the entropy sums and
    two mbarriers, each warp's column values, and the receive buffers (two
    parities of every block's values and of the block's own, or every
    block's values of this block's slice of columns). A value is a (max, sum) pair with x in
    registers, a log-sum-exp float otherwise."""
    ldm = -(-m // 4) * 4
    value = 8 if reg_rows else 4
    stride = value_stride(m, value)
    recv = 2 * (cluster + 1) * stride if push else cluster * -(-m // cluster)
    return 4 * ((0 if reg_rows else band * ldm) + ldm + WARPS + 8) + value * (WARPS * stride + recv)


def _plan(n: int, m: int, cs: int) -> Optional[ResidentPlan]:
    band = -(-n // cs)
    quads = -(-m // 128)
    if quads > MAX_QUADS:
        return None
    rows = -(-band // WARPS)
    reg_rows = rows if quads <= 2 and 4 * quads * rows <= REG_CELLS else 0
    push = smem_bytes(band, m, cs, reg_rows, True) <= MAX_SMEM
    smem = smem_bytes(band, m, cs, reg_rows, push)
    if smem > MAX_SMEM:
        return None
    return ResidentPlan(cs, band, quads, reg_rows, push, smem)


def resident_plan(n: int, m: int, cluster_size: Optional[int] = None) -> Optional[ResidentPlan]:
    """The plan of an ``(n, m)`` matrix, or ``None`` when the kernel cannot
    hold it. The default cluster is ``CLUSTER_SMALL`` blocks up to
    ``SMALL_ROWS`` rows and ``CLUSTER_LARGE`` above (never more blocks than
    rows), or the smallest that fits shared memory, whichever is larger;
    ``cluster_size`` forces it (a measurement sweeps it)."""
    if n < 1 or m < 1 or n * m > MAX_CELLS:
        return None
    if cluster_size is not None:
        return _plan(n, m, cluster_size) if 1 <= cluster_size <= MAX_CLUSTER else None
    fits = [cs for cs in range(1, MAX_CLUSTER + 1) if _plan(n, m, cs) is not None]
    if not fits:
        return None
    return _plan(n, m, max(fits[0], min(n, CLUSTER_SMALL if n <= SMALL_ROWS else CLUSTER_LARGE)))


def resident_supported(n: int, m: int) -> bool:
    """The kernel holds an ``(n, m)`` matrix: at most 768^2 cells, at most
    768 columns, and a cluster whose plan fits one block's shared memory."""
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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.otgan_resident_barrier_loop.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.otgan_resident_barrier_loop.restype = ctypes.c_int
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
        err = lib.otgan_resident_sinkhorn(
            cost.data_ptr(), p.data_ptr(), ent.data_ptr(), b, n, m, plan.cluster, plan.band,
            plan.quads, plan.reg_rows, int(plan.push), lam, n_iters, stream)
    if err != 0:
        msg = lib.otgan_resident_error_string(err).decode()
        raise RuntimeError(f"resident Sinkhorn CUDA kernel failed at {tuple(cost.shape)}, "
                           f"{plan}: {msg} ({err})")
    launches["kernel"] += 1
    return p, ent


def barrier_loop_cuda(cluster: int, b: int, n: int) -> None:
    """``n`` cluster barriers (arrive, then wait) on ``b`` clusters of
    ``cluster`` blocks of the kernel's threads and nothing else, on the
    current stream: the barrier's cost, for measurements."""
    lib = _bind()
    err = lib.otgan_resident_barrier_loop(cluster, b, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster barrier loop failed on {b} clusters of {cluster}: "
                           f"{lib.otgan_resident_error_string(err).decode()} ({err})")


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
