"""Whole-loop Sinkhorn on matrices held in the shared memory of the whole
card: the grid tier of ``sinkhorn_assignment(use_pallas=True)``, in a
hand-written CUDA kernel for Hopper.

Replaces ``otgan_tpu/ops/sinkhorn_pallas_tiled.py::_kernel`` (through
``_col_potential`` and its wrappers ``sinkhorn_assignment_tiled`` and
``sinkhorn_assignment_padded``) for every matrix the card's shared memory
holds. One cooperative launch per match reads the costs once, runs the whole
``n_iters`` loop with the logits in the shared memory of G blocks a matrix
(normally one per SM, each a band of whole rows), and writes the row-softmax
assignment P and the mean row entropy; the kernel is ``csrc/sinkhorn_grid.cu``,
its design and bound in its header.

:func:`grid_plan` is pure Python, so the CPU tests reach it; on the card it
is fed by one C query, ``otgan_grid_device_limits`` (SM count and the shared
memory a block may use), so the plan and the launch see the same card. On an
H100 (132 SMs, 232,448 B a block) the largest square it holds is 2640^2
(bands of 20 rows); 2641^2 needs bands of 21 rows, which do not fit.

:func:`sinkhorn_grid` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises; a failed build, a
refused cooperative launch or too few co-resident blocks is an error, never
a move to another path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from otgan_tpu_torch.ops.sinkhorn_resident_cuda import sinkhorn_resident_plain

# an H100 SXM's SM count and the shared memory a block may use on sm_90:
# grid_plan's default, so a tensor off the card is planned (and counted) as
# on an H100
H100_LIMITS = (132, 232448)
# threads a block (csrc/sinkhorn_grid.cu, which checks the plan again and
# refuses what does not fit)
THREADS = 1024

# launches of the CUDA kernel (one per match) and of the plain version;
# chip_smoke.py zeroes them around its paths
launches = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def smem_bytes(band: int, m: int) -> int:
    """Shared memory of one block (``smem_floats`` of the kernel): the band
    of x with rows padded to a multiple of 4 floats, v, u, the (max, sum)
    per thread of the fold, and the entropy sums."""
    ldm = -(-m // 4) * 4
    return 4 * (band * ldm + ldm + -(-band // 4) * 4 + 2 * THREADS + THREADS // 32 + 4)


def grid_plan(n: int, m: int, sm_count: int = H100_LIMITS[0],
              smem_per_block: int = H100_LIMITS[1], blocks: Optional[int] = None,
              batch: int = 1) -> Optional[Tuple[int, int]]:
    """``(blocks per matrix, band rows)`` for ``batch`` matrices of ``(n, m)``
    on a card of ``sm_count`` SMs whose blocks may use ``smem_per_block``
    bytes, one block per SM, or ``None`` when the card cannot hold one such
    matrix. ``blocks`` forces the count (a measurement sweeps it).

    The default takes the fewest blocks whose bands fit, runs as many
    matrices at once as that leaves SMs for (at most ``batch``), and
    spreads each matrix over its share of the SMs: at 6 x 2500^2, 132
    blocks of 19 rows, one matrix at a time; at 6 x 1000^2, 6 matrices at
    once on 22 blocks of 46 rows each."""
    if n < 1 or m < 1 or sm_count < 1:
        return None
    if blocks is not None:
        band = -(-n // blocks)
        ok = 1 <= blocks <= sm_count and smem_bytes(band, m) <= smem_per_block
        return (blocks, band) if ok else None
    if smem_bytes(1, m) > smem_per_block:
        return None
    lo, hi = 1, n  # the largest band that fits (shared memory grows with it)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, m) <= smem_per_block else (lo, mid - 1)
    fewest = -(-n // lo)
    if fewest > sm_count:
        return None
    band = -(-n // min(n, sm_count // grid_groups(fewest, batch, sm_count)))
    return -(-n // band), band


def grid_groups(blocks: int, batch: int, sm_count: int) -> int:
    """Matrices the launch runs at once: as many as fit beside each other
    on the SMs, at most ``batch``."""
    return max(1, min(batch, sm_count // blocks))


@functools.cache
def _card_limits(index: int) -> Tuple[int, int]:
    lib = _bind()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = lib.otgan_grid_device_limits(ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"otgan_grid_device_limits failed on cuda:{index}: "
                           f"{lib.otgan_grid_error_string(err).decode()} ({err})")
    return sms.value, smem.value


def card_limits(device: torch.device) -> Tuple[int, int]:
    """``(SM count, shared memory a block may use)`` of a CUDA device, from
    the kernel's own query."""
    return _card_limits(torch.cuda.current_device() if device.index is None else device.index)


def grid_supported(n: int, m: int, limits: Tuple[int, int] = H100_LIMITS) -> bool:
    """The kernel holds an ``(n, m)`` matrix on a card of these limits."""
    return grid_plan(n, m, *limits) is not None


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("sinkhorn_grid")
    fn = lib.otgan_grid_sinkhorn
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.otgan_grid_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.otgan_grid_device_limits.restype = ctypes.c_int
    lib.otgan_grid_barrier_loop.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.otgan_grid_barrier_loop.restype = ctypes.c_int
    lib.otgan_grid_error_string.argtypes = [ctypes.c_int]
    lib.otgan_grid_error_string.restype = ctypes.c_char_p
    return lib


def sinkhorn_grid_cuda(cost: torch.Tensor, lam: float, n_iters: int,
                       blocks: Optional[int] = None):
    """Launch the kernel on contiguous float32 costs ``(b, N, M)`` on the
    card; returns (P ``(b, N, M)``, entropy ``(b,)``). ``blocks`` overrides
    the planned blocks per matrix (a measurement sweeps it). Raises on a
    shape the card cannot hold and on a refused launch."""
    if not (cost.is_cuda and cost.dtype == torch.float32 and cost.dim() == 3
            and cost.is_contiguous()):
        raise ValueError(
            "sinkhorn_grid_cuda needs a contiguous (b, N, M) float32 CUDA "
            f"tensor, got {cost.dtype} {tuple(cost.shape)} on {cost.device}"
        )
    b, n, m = cost.shape
    sms, smem = card_limits(cost.device)
    plan = grid_plan(n, m, sms, smem, blocks, batch=b)
    if plan is None or n_iters < 0 or not 1 <= b <= 65535:
        raise ValueError(f"the grid kernel cannot hold {tuple(cost.shape)} on {sms} SMs of "
                         f"{smem} B (blocks {blocks}, n_iters {n_iters})")
    n_blocks, band = plan
    groups = grid_groups(n_blocks, b, sms)
    lib = _bind()
    with torch.cuda.device(cost.device):
        p = torch.empty_like(cost)
        ent = torch.empty((b,), device=cost.device, dtype=torch.float32)
        part = torch.empty((groups, n_blocks, m, 2), device=cost.device, dtype=torch.float32)
        v_glob = torch.empty((groups, -(-m // 4) * 4), device=cost.device, dtype=torch.float32)
        ent_part = torch.empty((b, n_blocks), device=cost.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = lib.otgan_grid_sinkhorn(cost.data_ptr(), p.data_ptr(), ent.data_ptr(),
                                      part.data_ptr(), v_glob.data_ptr(),
                                      ent_part.data_ptr(), b, n, m, n_blocks, groups, lam,
                                      n_iters, stream)
    if err != 0:
        msg = lib.otgan_grid_error_string(err).decode()
        raise RuntimeError(f"grid Sinkhorn CUDA kernel failed at {tuple(cost.shape)}, plan "
                           f"{n_blocks} blocks of {band} rows, {groups} matrices at once: "
                           f"{msg} ({err})")
    launches["kernel"] += 1
    return p, ent


def barrier_loop_cuda(blocks: int, threads: int, n: int) -> None:
    """``n`` grid barriers on ``blocks`` co-resident blocks and nothing
    else, on the current stream: the barrier's cost, for measurements."""
    lib = _bind()
    err = lib.otgan_grid_barrier_loop(blocks, threads, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid barrier loop failed on {blocks} blocks: "
                           f"{lib.otgan_grid_error_string(err).decode()} ({err})")


@torch.no_grad()
def sinkhorn_grid(cost: torch.Tensor, lam: float, n_iters: int):
    """Cost ``(..., N, M)`` -> (P ``(..., N, M)``, entropy ``(...)``): the
    CUDA kernel for a tensor on the card, the plain version for one on the
    CPU (``sinkhorn_resident_plain``: the resident kernel computes the same
    function from the same row-shifted logits)."""
    n, m = cost.shape[-2:]
    batch_shape = cost.shape[:-2]
    c = cost.detach().float().reshape(-1, n, m)
    if c.is_cuda:
        p, ent = sinkhorn_grid_cuda(c.contiguous(), lam, n_iters)
    elif c.device.type == "cpu":
        launches["plain"] += 1
        p, ent = sinkhorn_resident_plain(c, lam, n_iters)
    else:
        raise ValueError(f"no Sinkhorn kernel for device {cost.device}")
    return p.reshape(cost.shape), ent.reshape(batch_shape)
