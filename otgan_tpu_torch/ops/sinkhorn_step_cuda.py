"""One local Sinkhorn step of the row-sharded matcher, in hand-written CUDA
kernels for Hopper.

Replaces the two TPU kernels of ``otgan_tpu/ops/sinkhorn_pallas_step.py``:
``_local_step_kernel`` (tier "fused", via ``fused_local_sinkhorn_step``) and
``_streaming_step_kernel`` (tier "stream", via
``streaming_local_sinkhorn_step``). On a rank that owns the row block
``x = -lam * C[rows, :]`` ``(b, n_loc, N)`` of every cost matrix, one step is

    u    = -rowLSE(x + v)                        (rows are whole on the rank)
    m, s = column-LSE partials of x + u          (combined across ranks)

with ``m[j] = max_i(x_ij + u_i)`` the LOCAL column max and
``s[j] = sum_i exp(x_ij + u_i - m[j])``. The kernels are
``csrc/sinkhorn_step.cu``; their design and bound are in its header.

:func:`local_step_mode` keeps the JAX package's tier rule, so the fused
kernel runs where the TPU kept the whole block in VMEM and the stream
kernel (online column accumulation across panels) where it streamed. Unlike
the TPU, the stream tier launches its kernel on the card: the TPU's
``OTGAN_FORCE_STREAM_STEP`` gate records a TPU measurement and has no
counterpart here. The kernels mask ragged edges by bounds, so the TPU's tile
padding (``pad_to_grid``, ``pad_to_stream_grid``) is not ported.

:func:`make_local_step` takes the plain version for a tensor on the CPU, or
where the caller turns the kernels off (``--no_use_pallas``). Otherwise, for
a CUDA tensor, it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

# tier thresholds of the JAX package (ops/sinkhorn_pallas_step.py:50-110):
# the (8, 128) f32 tile grid, the fused tier's VMEM ceiling in cells, and
# the stream tier's panel heights and double-buffered panel budget
_LANE = 128
_SUBLANE = 8
_MAX_CELLS = 1024 * 1024
_PANELS = (512, 256, 128, 64, 32, 16, 8)
_PANEL_CELLS = 512 * 2560
# blocks per SM that the stream tier's grid aims for: of 1, 2, 4, 8 and 16,
# 8 was fastest at (6, 4000, 4000) and tied at (6, 1000, 4000) on an H100
# (measure_local_step.py at the repo root; numbers in PERF.md)
STREAM_CTAS_PER_SM = 8

# calls that launched a kernel (one per step: the partials launch and its
# combine) and plain steps; chip_smoke.py zeroes them around its paths
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
    """Eager-torch version of the kernels: ``x`` ``(b, n_loc, N)``, ``v``
    ``(b, N)`` -> ``(m, s)``, each ``(b, N)``."""
    y = x + v[:, None, :]
    rm = torch.amax(y, dim=-1, keepdim=True)
    u = -(rm + torch.log(torch.sum(torch.exp(y - rm), dim=-1, keepdim=True)))
    z = x + u
    m = torch.amax(z, dim=-2)
    s = torch.sum(torch.exp(z - m[:, None, :]), dim=-2)
    return m, s


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("sinkhorn_step")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.otgan_local_step_fused.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.otgan_local_step_fused.restype = i32
    lib.otgan_local_step_stream.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.otgan_local_step_stream.restype = i32
    for name in ("otgan_step_rows_per_panel", "otgan_step_stream_max_cols"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.otgan_step_error_string.argtypes = [i32]
    lib.otgan_step_error_string.restype = ctypes.c_char_p
    return lib


def stream_ctas(b: int, n_loc: int, sm_count: int, per_sm: int = STREAM_CTAS_PER_SM) -> int:
    """Blocks per matrix of the stream tier: enough to give every SM
    ``per_sm`` blocks, each walking the same number of panels."""
    rows = _bind().otgan_step_rows_per_panel()
    n_panels = -(-n_loc // rows)
    target = max(1, -(-per_sm * sm_count // b))
    per_cta = -(-n_panels // target)
    return -(-n_panels // per_cta)


def _cuda_step(x: torch.Tensor, mode: str, n_ctas: Optional[int]) -> Step:
    if not (x.dtype == torch.float32 and x.dim() == 3 and x.is_contiguous()):
        raise ValueError(
            "the local-step kernels need a contiguous (b, n_loc, N) float32 "
            f"tensor, got {x.dtype} {tuple(x.shape)}"
        )
    b, n, m = x.shape
    if b == 0 or n == 0 or m == 0:
        raise ValueError(f"empty row block {tuple(x.shape)}")
    if max(b, n, m) >= 2**31 or b > 65535:
        raise ValueError(f"row block {tuple(x.shape)} exceeds the kernels' grid")
    lib = _bind()
    if n_ctas is not None and (mode != "stream" or n_ctas < 1):
        raise ValueError(f"n_ctas={n_ctas} is for the stream tier, at least 1")
    if mode == "fused":
        n_parts = -(-n // lib.otgan_step_rows_per_panel())
    elif mode == "stream":
        if m > lib.otgan_step_stream_max_cols():
            raise ValueError(
                f"{m} columns exceed the stream tier's shared memory "
                f"({lib.otgan_step_stream_max_cols()} columns)"
            )
        sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
        n_parts = n_ctas or stream_ctas(b, n, sm_count)
    else:
        raise ValueError(f"no local-step kernel for tier {mode!r} at {tuple(x.shape)}")
    with torch.cuda.device(x.device):
        m_out = torch.empty((b, m), device=x.device, dtype=torch.float32)
        s_out = torch.empty_like(m_out)
        m_part = torch.empty((b, n_parts, m), device=x.device, dtype=torch.float32)
        s_part = torch.empty_like(m_part)

    def step(v: torch.Tensor):
        if v.shape != (b, m) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"v must be ({b}, {m}) float32 on {x.device}")
        v = v.contiguous()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            args = (x.data_ptr(), v.data_ptr(), m_out.data_ptr(), s_out.data_ptr(),
                    m_part.data_ptr(), s_part.data_ptr(), b, n, m)
            if mode == "fused":
                err = lib.otgan_local_step_fused(*args, stream)
            else:
                err = lib.otgan_local_step_stream(*args, n_parts, stream)
        if err != 0:
            msg = lib.otgan_step_error_string(err).decode()
            raise RuntimeError(f"local Sinkhorn step kernel ({mode}) failed: {msg} ({err})")
        launches[mode] += 1
        return m_out, s_out

    return step


def _plain_step(v: torch.Tensor, x: torch.Tensor):
    launches["plain"] += 1
    return local_step_plain(x, v)


def make_local_step(x: torch.Tensor, use_kernel: bool = True, mode: Optional[str] = None,
                    n_ctas: Optional[int] = None) -> Step:
    """The local step on the row block ``x`` ``(b, n_loc, N)`` as a function
    ``v (b, N) -> (m, s)``. For a tensor on the card and ``use_kernel``, a
    kernel of the tier ``mode`` (default :func:`local_step_mode`); the
    stream tier runs ``n_ctas`` blocks per matrix (default
    :func:`stream_ctas`). Otherwise the plain version, counted as such. The
    kernel's outputs and scratch are allocated once and reused: the
    ``(m, s)`` of a call are overwritten by the next."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no local-step kernel for device {x.device}")
    if use_kernel and x.is_cuda:
        return _cuda_step(x, mode or local_step_mode(x.shape[1], x.shape[2]), n_ctas)
    return functools.partial(_plain_step, x=x)
