"""One local Sinkhorn step of the row-sharded matcher, in a hand-written
CUDA kernel for Hopper.

Replaces the two TPU kernels of ``otgan_tpu/ops/sinkhorn_pallas_step.py``:
``_local_step_kernel`` (tier "fused", via ``fused_local_sinkhorn_step``) and
``_streaming_step_kernel`` (tier "stream", via
``streaming_local_sinkhorn_step``). On a rank that owns the row block
``x = -lam * C[rows, :]`` ``(b, n_loc, N)`` of every cost matrix, one step is

    u    = -rowLSE(x + v)                        (rows are whole on the rank)
    m, s = column-LSE partials of x + u          (combined across ranks)

with ``m[j] = max_i(x_ij + u_i)`` the LOCAL column max and
``s[j] = sum_i exp(x_ij + u_i - m[j])``. The kernel is
``csrc/sinkhorn_step.cu``, one cooperative launch per step; its design and
bound are in its header.

:func:`local_step_mode` keeps the JAX package's tier rule. The two TPU
tiers compute one function, so both launch the same kernel, and
``launches`` counts each tier's steps. Unlike the TPU, the stream tier
launches its kernel on the card: the TPU's ``OTGAN_FORCE_STREAM_STEP`` gate
records a TPU measurement and has no counterpart here. The kernel masks
ragged edges by bounds, so the TPU's tile padding (``pad_to_grid``,
``pad_to_stream_grid``) is not ported.

:func:`step_plan` is pure Python, so the CPU tests reach it; on the card it
is fed the SM count and shared memory of ``sinkhorn_grid_cuda.card_limits``.

:func:`make_local_step` takes the plain version for a tensor on the CPU, or
where the caller turns the kernels off (``--no_use_pallas``). Otherwise, for
a CUDA tensor, it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from otgan_tpu_torch.ops.sinkhorn_grid_cuda import H100_LIMITS, card_limits

# tier thresholds of the JAX package (ops/sinkhorn_pallas_step.py:50-110):
# the (8, 128) f32 tile grid, the fused tier's VMEM ceiling in cells, and
# the stream tier's panel heights and double-buffered panel budget
_LANE = 128
_SUBLANE = 8
_MAX_CELLS = 1024 * 1024
_PANELS = (512, 256, 128, 64, 32, 16, 8)
_PANEL_CELLS = 512 * 2560

# the kernel's constants (csrc/sinkhorn_step.cu, which checks the plan
# again and refuses what does not fit)
WARPS = 16
MAX_STAGES = 8
MAX_STAGE_ROWS = 32
BARRIER_FLOATS = 2 * MAX_STAGES
# the ring's stages where one stage does not hold the band (1 where two do
# not fit), each of the most rows that fit: measure_local_step.py's sweep on
# an H100 (PERF.md), and the rows a stage of the direct plan reads in place
DEFAULT_STAGES = 2
DIRECT_STAGE_ROWS = 8

# steps that launched the kernel, by tier, and plain steps; chip_smoke.py
# zeroes them around its paths
launches = {"fused": 0, "stream": 0, "plain": 0}

Step = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def local_step_supported(n_loc: int, n: int) -> bool:
    """The fused tier's ceiling: the block on the TPU's f32 tile grid holds
    at most ``_MAX_CELLS`` cells."""
    return (n_loc + (-n_loc % _SUBLANE)) * (n + (-n % _LANE)) <= _MAX_CELLS


def streaming_panel(n_loc: int, n: int) -> Optional[int]:
    """The TPU stream tier's tallest panel for a block of width ``n``, capped
    at the block height; ``None`` when even the shortest is too wide."""
    n_pad = n + (-n % _LANE)
    cap = n_loc + (-n_loc % _SUBLANE)
    for p in _PANELS:
        if p * n_pad <= _PANEL_CELLS and p <= cap:
            return p
    return None


def local_step_mode(n_loc: int, n: int) -> Optional[str]:
    """Tier for a rank's ``(n_loc, n)`` row block: ``"fused"``, ``"stream"``,
    or ``None`` (a block wider than either tier takes)."""
    if local_step_supported(n_loc, n):
        return "fused"
    if streaming_panel(n_loc, n) is not None:
        return "stream"
    return None


def local_step_plain(x: torch.Tensor, v: torch.Tensor):
    """Eager-torch version of the kernel: ``x`` ``(b, n_loc, N)``, ``v``
    ``(b, N)`` -> ``(m, s)``, each ``(b, N)``."""
    y = x + v[:, None, :]
    rm = torch.amax(y, dim=-1, keepdim=True)
    u = -(rm + torch.log(torch.sum(torch.exp(y - rm), dim=-1, keepdim=True)))
    z = x + u
    m = torch.amax(z, dim=-2)
    s = torch.sum(torch.exp(z - m[:, None, :]), dim=-2)
    return m, s


class StepPlan(NamedTuple):
    """How one launch covers a ``(b, n, m)`` block: ``blocks`` a matrix of
    ``band`` rows each, ``groups`` matrices at once (the rest in rounds),
    stages of ``stage_rows`` rows, ``stages`` of them in the shared-memory
    ring (0: the direct plan, which reads the band in place), and the
    shared memory of a block in bytes."""

    blocks: int
    band: int
    groups: int
    stage_rows: int
    stages: int
    smem: int


def _up(x: int, k: int) -> int:
    return -(-x // k) * k


def smem_bytes(m: int, rows: int, stages: int) -> int:
    """Shared memory of one block (``smem_bytes`` of the kernel): the
    mbarriers, then for a ring the stages (``rows`` rows, the slack of the
    aligned copy, in 128-byte lines), v and the (max, sum) accumulators,
    then u, the row step's warp partials and the fold's (max, sum) per
    thread."""
    f = BARRIER_FLOATS
    if stages > 0:
        f += stages * _up(rows * m + 8, 32) + _up(m, 4) + 2 * m
    f += _up(rows, 4) + 2 * rows * WARPS + 2 * 32 * WARPS
    return 4 * f


def step_plan(b: int, n: int, m: int, sm_count: int = H100_LIMITS[0],
              smem_per_block: int = H100_LIMITS[1], blocks: Optional[int] = None,
              stages: Optional[int] = None) -> Optional[StepPlan]:
    """The plan of one step on a card of ``sm_count`` SMs whose blocks may
    use ``smem_per_block`` bytes, or ``None`` when the card cannot run it.

    Blocks: ``sm_count // b`` a matrix by default (22 at b = 6 on 132 SMs),
    at most one per row, one block an SM, so every matrix runs at once
    where ``b <= sm_count``; ``blocks`` forces the count (a measurement
    sweeps it; blocks past the last row own none). Ring: by default one
    stage that holds the whole band where it fits (one copy; the small
    blocks of the fused tier), else ``DEFAULT_STAGES`` stages, then 1, of
    the most rows, up to ``MAX_STAGE_ROWS`` and the band, that fit beside v
    and the accumulators; a forced ``stages`` the same way, and never more
    stages than the band fills. Where not even one
    stage of one row fits (m above 14,254 on an H100), or where
    ``stages`` is 0, the direct plan: stages of ``DIRECT_STAGE_ROWS`` rows
    read in place."""
    if min(b, n, m, sm_count) < 1:
        return None
    if blocks is None:
        band = -(-n // max(1, min(n, sm_count // b)))
        blocks = -(-n // band)
    elif 1 <= blocks <= sm_count:
        band = -(-n // blocks)
    else:
        return None
    groups = max(1, min(b, sm_count // blocks))
    if stages is not None and not 0 <= stages <= MAX_STAGES:
        return None
    if stages is None and band <= MAX_STAGE_ROWS and smem_bytes(m, band, 1) <= smem_per_block:
        return StepPlan(blocks, band, groups, band, 1, smem_bytes(m, band, 1))
    rings = (DEFAULT_STAGES, 1) if stages is None else (stages,) if stages else ()
    for s in rings:
        rows = next((r for r in range(min(MAX_STAGE_ROWS, band), 0, -1)
                     if smem_bytes(m, r, s) <= smem_per_block), 0)
        if rows:
            s = min(s, -(-band // rows))
            return StepPlan(blocks, band, groups, rows, s, smem_bytes(m, rows, s))
    if stages:
        return None
    rows = min(DIRECT_STAGE_ROWS, band)
    return StepPlan(blocks, band, groups, rows, 0, smem_bytes(m, rows, 0))


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("sinkhorn_step")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.otgan_local_step_prepare.argtypes = [i32] * 8
    lib.otgan_local_step_prepare.restype = i32
    lib.otgan_local_step.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.otgan_local_step.restype = i32
    lib.otgan_step_error_string.argtypes = [i32]
    lib.otgan_step_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_step(x: torch.Tensor, mode: str, n_ctas: Optional[int],
               stages: Optional[int]) -> Step:
    if not (x.dtype == torch.float32 and x.dim() == 3 and x.is_contiguous()):
        raise ValueError(
            "the local-step kernel needs a contiguous (b, n_loc, N) float32 "
            f"tensor, got {x.dtype} {tuple(x.shape)}"
        )
    b, n, m = x.shape
    if b == 0 or n == 0 or m == 0:
        raise ValueError(f"empty row block {tuple(x.shape)}")
    if max(b, n, m) >= 2**31 or b * n * m >= 2**62:
        raise ValueError(f"row block {tuple(x.shape)} exceeds the kernel's indexing")
    if n_ctas is not None and (mode != "stream" or n_ctas < 1):
        raise ValueError(f"n_ctas={n_ctas} is for the stream tier, at least 1")
    if mode not in ("fused", "stream"):
        raise ValueError(f"no local-step kernel for tier {mode!r} at {tuple(x.shape)}")
    sms, smem = card_limits(x.device)
    plan = step_plan(b, n, m, sms, smem, blocks=n_ctas, stages=stages)
    if plan is None:
        raise ValueError(f"no local-step plan for {tuple(x.shape)} on {sms} SMs of {smem} B "
                         f"(blocks {n_ctas}, stages {stages})")
    lib = _bind()
    dims = (b, n, m, plan.blocks, plan.groups, plan.band, plan.stage_rows, plan.stages)
    with torch.cuda.device(x.device):
        err = lib.otgan_local_step_prepare(*dims)
        m_out = torch.empty((b, m), device=x.device, dtype=torch.float32)
        s_out = torch.empty_like(m_out)
        part = torch.empty((b, plan.blocks, m, 2), device=x.device, dtype=torch.float32)
    if err != 0:
        raise RuntimeError(f"local Sinkhorn step kernel ({mode}) cannot run {plan} at "
                           f"{tuple(x.shape)}: {lib.otgan_step_error_string(err).decode()} "
                           f"({err})")

    def step(v: torch.Tensor):
        if v.shape != (b, m) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"v must be ({b}, {m}) float32 on {x.device}")
        v = v.contiguous()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.otgan_local_step(x.data_ptr(), v.data_ptr(), m_out.data_ptr(),
                                       s_out.data_ptr(), part.data_ptr(), *dims, stream)
        if err != 0:
            msg = lib.otgan_step_error_string(err).decode()
            raise RuntimeError(f"local Sinkhorn step kernel ({mode}) failed: {msg} ({err})")
        launches[mode] += 1
        return m_out, s_out

    step.plan = plan
    return step


def _plain_step(v: torch.Tensor, x: torch.Tensor):
    launches["plain"] += 1
    return local_step_plain(x, v)


def make_local_step(x: torch.Tensor, use_kernel: bool = True, mode: Optional[str] = None,
                    n_ctas: Optional[int] = None, stages: Optional[int] = None) -> Step:
    """The local step on the row block ``x`` ``(b, n_loc, N)`` as a function
    ``v (b, N) -> (m, s)``. For a tensor on the card and ``use_kernel``, the
    kernel, counted under the tier ``mode`` (default :func:`local_step_mode`),
    on :func:`step_plan`'s plan; a measurement may force ``n_ctas`` blocks a
    matrix (stream tier) and the ring's ``stages``. Otherwise the plain
    version, counted as such. The kernel's outputs and scratch are allocated
    once and reused: the ``(m, s)`` of a call are overwritten by the next."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no local-step kernel for device {x.device}")
    if use_kernel and x.is_cuda:
        return _cuda_step(x, mode or local_step_mode(x.shape[1], x.shape[2]), n_ctas, stages)
    return functools.partial(_plain_step, x=x)
