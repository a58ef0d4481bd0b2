"""Sinkhorn column potential in a hand-written CUDA kernel for Hopper.

Replaces ``otgan_tpu/ops/sinkhorn_pallas_tiled.py::_kernel`` (through
``_col_potential``) and its wrappers ``sinkhorn_assignment_tiled`` and
``sinkhorn_assignment_padded``. The kernel is ``csrc/sinkhorn.cu``: per
iteration one launch over (row panel, matrix) blocks folds each panel into
column (max, rescaled sum) partials, and a second launch combines them into
the new column potential. The host side of its C entry point runs the whole
``n_iters`` loop, so one match is one ctypes call.

What bounds it on an H100: at the reference batch 5000 a match is
6 x 2500^2 f32 = 150 MB, three times the 50 MB L2, so every iteration
streams the logits from device memory; 500 iterations read at least 75 GB,
about 22 ms at 3.35 TB/s. At batch 256 (6 x 128^2) the 2 x n_iters launches
set its time. This first version is simple and right: it reads each panel
four times (only the first from device memory), and leaves TMA,
shared-memory panels and CUDA graphs to a later change. Times are in PERF.md.

The TPU wrappers block-pad misaligned shapes to reach the (8, 128) tile
grid; the CUDA kernel masks its ragged edges instead, so any (N, M) runs
unpadded.

``col_potential`` takes the plain version only for a tensor on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy

# launches of the CUDA kernel (one per ctypes call, i.e. per match) and of
# the plain version; chip_smoke.py zeroes them around the main path
launches = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def col_potential_plain(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Eager-torch version of the kernel: ``(b, N, M)`` logits -> ``(b, M)``
    final column potential."""
    v = x.new_zeros((x.shape[0], x.shape[2]))
    for _ in range(n_iters):
        u = -torch.logsumexp(x + v[:, None, :], dim=2)
        v = -torch.logsumexp(x + u[:, :, None], dim=1)
    return v


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("sinkhorn")
    fn = lib.otgan_sinkhorn_col_potential
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.otgan_sinkhorn_rows_per_panel.argtypes = []
    lib.otgan_sinkhorn_rows_per_panel.restype = ctypes.c_int
    lib.otgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def col_potential_cuda(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` ``(b, N, M)`` f32 contiguous on the
    card; returns ``v`` ``(b, M)``. Raises on a refused launch."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 3
            and x.is_contiguous()):
        raise ValueError(
            "col_potential_cuda needs a contiguous (b, N, M) float32 CUDA "
            f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    b, n, m = x.shape
    if b == 0 or n == 0 or m == 0 or n_iters < 0:
        raise ValueError(f"empty shape {tuple(x.shape)} or n_iters {n_iters}")
    if max(b, n, m) >= 2**31 or b > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    lib = _bind()
    rows = lib.otgan_sinkhorn_rows_per_panel()
    n_panels = -(-n // rows)
    with torch.cuda.device(x.device):
        v = torch.empty((b, m), device=x.device, dtype=torch.float32)
        m_part = torch.empty((b, n_panels, m), device=x.device, dtype=torch.float32)
        s_part = torch.empty_like(m_part)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otgan_sinkhorn_col_potential(
            x.data_ptr(), v.data_ptr(), m_part.data_ptr(), s_part.data_ptr(),
            b, n, m, n_iters, stream,
        )
    if err != 0:
        msg = lib.otgan_cuda_error_string(err).decode()
        raise RuntimeError(f"sinkhorn CUDA kernel failed: {msg} ({err})")
    launches["kernel"] += 1
    return v


def col_potential(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Final column potential of ``n_iters`` Sinkhorn iterations on
    ``x = -lam * C`` ``(b, N, M)``: the CUDA kernel for a tensor on the
    card, the plain version for one on the CPU."""
    if x.is_cuda:
        return col_potential_cuda(x, n_iters)
    if x.device.type != "cpu":
        raise ValueError(f"no Sinkhorn kernel for device {x.device}")
    launches["plain"] += 1
    return col_potential_plain(x, n_iters)


@torch.no_grad()
def scaled_logits(cost: torch.Tensor, lam: float) -> torch.Tensor:
    """The kernel's input for costs ``(..., N, M)``: ``x = -lam * C`` as a
    contiguous ``(b, N, M)`` float32 stack, each row shifted by its max.

    The shift is absorbed by the row potential, so v and P are unchanged in
    exact arithmetic; in float32 it moves the loop from magnitudes near
    ``lam`` (spacing 3e-5 at 500) to near 0, which keeps P within 5e-6 of
    the float64 oracle at lam = 500 where the unshifted loop strays 1e-5
    (tests/test_torch_sinkhorn.py)."""
    n, m = cost.shape[-2:]
    x = (-lam * cost.detach().float()).reshape(-1, n, m)
    return (x - x.amax(dim=-1, keepdim=True)).contiguous()


@torch.no_grad()
def sinkhorn_assignment_kernel(cost: torch.Tensor, lam: float, n_iters: int):
    """``sinkhorn_assignment(use_pallas=True)``: cost ``(..., N, M)`` ->
    (P ``(..., N, M)``, entropy ``(...)``). The row potential is irrelevant
    to a row softmax, so P is ``softmax_rows(x + v)``."""
    batch_shape = cost.shape[:-2]
    x = scaled_logits(cost, lam)
    v = col_potential(x, n_iters)
    p, ent = assignment_and_entropy(x + v[:, None, :])
    return p.reshape(cost.shape), ent.reshape(batch_shape)
