"""Sinkhorn column potential above the grid kernel's ceiling, on the
local-step kernel's v mode (hand-written CUDA for Hopper).

Replaces ``otgan_tpu/ops/sinkhorn_pallas_tiled.py::_kernel`` (through
``_col_potential``) and its wrappers ``sinkhorn_assignment_tiled`` and
``sinkhorn_assignment_padded`` for the matrices the grid kernel
(``ops/sinkhorn_grid_cuda.py``) cannot hold, e.g. batch 8000's 6 x 4000^2.
On a whole matrix one local step of the row-sharded matcher is one Sinkhorn
iteration, so the kernel is ``csrc/sinkhorn_step.cu`` in its v mode: the
fold writes the new column potential instead of the (max, sum) partials.
Its C entry ``otgan_col_potential`` runs the whole ``n_iters`` loop, one
cooperative launch an iteration, so a match is one ctypes call; the plan
is ``sinkhorn_step_cuda.step_plan`` on the whole ``(b, N, M)``. The design
and bound are in the kernel's header, the times in PERF.md.

The TPU wrappers block-pad misaligned shapes to reach the (8, 128) tile
grid; the CUDA kernel masks its ragged edges instead, so any (N, M) runs
unpadded.

``col_potential`` takes the plain version only for a tensor on the CPU. For
a CUDA tensor it launches the kernel or raises. Its launches count here
(``launches["kernel"]``, one a match), never as the local-step tiers'.
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

    lib = load("sinkhorn_step")
    fn = lib.otgan_col_potential
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.otgan_step_error_string.argtypes = [ctypes.c_int]
    lib.otgan_step_error_string.restype = ctypes.c_char_p
    return lib


def col_potential_cuda(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Launch the kernel on ``x`` ``(b, N, M)`` f32 contiguous on the
    card, one launch an iteration; returns ``v`` ``(b, M)``. Raises on a
    shape the card cannot plan and on a refused launch."""
    from otgan_tpu_torch.ops.sinkhorn_grid_cuda import card_limits
    from otgan_tpu_torch.ops.sinkhorn_step_cuda import step_plan

    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 3
            and x.is_contiguous()):
        raise ValueError(
            "col_potential_cuda needs a contiguous (b, N, M) float32 CUDA "
            f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    b, n, m = x.shape
    if b == 0 or n == 0 or m == 0 or n_iters < 0:
        raise ValueError(f"empty shape {tuple(x.shape)} or n_iters {n_iters}")
    if max(b, n, m) >= 2**31 or b * n * m >= 2**62:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's indexing")
    sms, smem = card_limits(x.device)
    plan = step_plan(b, n, m, sms, smem)
    if plan is None:
        raise ValueError(f"no local-step plan for {tuple(x.shape)} on {sms} SMs of {smem} B")
    lib = _bind()
    with torch.cuda.device(x.device):
        v = torch.empty((b, m), device=x.device, dtype=torch.float32)
        v_next = torch.empty_like(v)
        part = torch.empty((b, plan.blocks, m, 2), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otgan_col_potential(
            x.data_ptr(), v.data_ptr(), v_next.data_ptr(), part.data_ptr(), b, n, m,
            plan.blocks, plan.groups, plan.band, plan.stage_rows, plan.stages, n_iters, stream)
    if err != 0:
        msg = lib.otgan_step_error_string(err).decode()
        raise RuntimeError(f"column-potential kernel failed at {tuple(x.shape)}, {plan}: "
                           f"{msg} ({err})")
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
