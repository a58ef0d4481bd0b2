"""Log-domain Sinkhorn (counterpart of ``otgan_tpu/ops/sinkhorn.py``).

Starting from ``x = -lam * cost`` the loop carries only the dual potentials,
with ``log_a = x + u[:, None] + v[None, :]``:

    u_i <- -logsumexp_j(x_ij + v_j)        # row step
    v_j <- -logsumexp_i(x_ij + u_i)        # column step, REPLACES v

which is algebraically the reference's full-matrix recursion
(``utils/matching.py:50-57`` in openai/ot-gan). The assignment is the row
softmax of ``log_a`` and the entropy its mean row Shannon entropy. All of it
is float32.

``sinkhorn_assignment(use_pallas=True)`` runs the loop in a hand-written
CUDA kernel, in one of three tiers chosen by :func:`kernel_tier` from the
matrix shape and the card's SM count and shared memory, never by a failed
build or launch:

1. the resident kernel (``ops/sinkhorn_resident_cuda.py``: one thread-block
   cluster a matrix) for matrices of at most ``RESIDENT_TIER_CELLS`` cells
   (512^2);
2. the grid kernel (``ops/sinkhorn_grid_cuda.py``: the matrix held in the
   shared memory of the whole card) for every larger matrix it holds, up to
   2640^2 on an H100 (the reference batch 5000's 2500^2 included);
3. the column-potential loop (``ops/sinkhorn_cuda.py``) above that, e.g.
   batch 8000's 4000^2: the row-sharded matcher's local-step kernel on the
   whole matrix in its v mode, one launch an iteration from one C call a
   match, the softmax and entropy in torch.

The first two are one launch per match, softmax and entropy included. The
boundary between them is measured (``measure_resident.py`` on an H100 80GB
HBM3 at 700 W, 6 x N^2, lam 500, 500 iterations, ms per match, resident /
grid; PERF.md): 0.724 / 2.919 at 128^2, 1.437 / 2.908 at 256^2, 2.631 /
3.329 at 384^2, 3.566 / 3.694 at 512^2, then the grid kernel: 5.757 / 5.700
at 6 x 768^2 and 5.744 / 3.528 at 1 x 768^2.
The name of the flag is kept so that a ``config.json`` reads in both
packages.
"""

from __future__ import annotations

from typing import Tuple

import torch

# matrices of at most this many cells go to the resident tier (see
# kernel_tier); the rest that the grid kernel holds go to it
RESIDENT_TIER_CELLS = 512 * 512


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max-shifted logsumexp, as the JAX package writes it."""
    m = torch.amax(x, dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def sinkhorn_log(neg_lam_cost: torch.Tensor, n_iters: int):
    """Sinkhorn on pre-scaled logits ``(..., N, M)``; leading dims batch.

    Returns ``(log_a, u, v)`` with ``log_a = x + u[..., :, None] + v[..., None, :]``.
    """
    x = neg_lam_cost.float()
    u = x.new_zeros(x.shape[:-1])
    v = x.new_zeros(x.shape[:-2] + x.shape[-1:])
    for _ in range(n_iters):
        u = -_lse(x + v.unsqueeze(-2), dim=-1)
        v = -_lse(x + u.unsqueeze(-1), dim=-2)
    return x + u.unsqueeze(-1) + v.unsqueeze(-2), u, v


def assignment_and_entropy(log_a: torch.Tensor):
    """Row-softmax assignment and mean row entropy (reference semantics:
    ``softmax_cross_entropy_with_logits(labels=P, logits=log_a)`` is the row
    Shannon entropy of P)."""
    p = torch.softmax(log_a, dim=-1)
    logp = torch.log_softmax(log_a, dim=-1)
    ent = -torch.sum(p * logp, dim=-1)
    return p, torch.mean(ent, dim=-1)


def sinkhorn_log_tol(neg_lam_cost: torch.Tensor, max_iters: int, tol: float):
    """Early-exit Sinkhorn: each matrix iterates until its column potential
    moves less than ``tol`` (sup-norm) or ``max_iters`` is reached.

    Returns ``(log_a, iterations_used)``; ``iterations_used`` has the batch
    shape. An opt-in deviation from the reference's fixed count.
    """
    x = neg_lam_cost.float()
    batch_shape = x.shape[:-2]
    flat = x.reshape((-1,) + x.shape[-2:])
    logs, iters = [], []
    for x2d in flat:
        u = x2d.new_zeros(x2d.shape[0])
        v = x2d.new_zeros(x2d.shape[1])
        i, delta = 0, float("inf")
        while i < max_iters and delta >= tol:
            v_prev = v
            u = -_lse(x2d + v[None, :], dim=1)
            v = -_lse(x2d + u[:, None], dim=0)
            delta = float(torch.max(torch.abs(v - v_prev)))
            i += 1
        logs.append(x2d + u[:, None] + v[None, :])
        iters.append(i)
    log_a = torch.stack(logs).reshape(x.shape)
    return log_a, torch.tensor(iters, dtype=torch.int32).reshape(batch_shape)


def kernel_tier(n: int, m: int, limits: Tuple[int, int]) -> str:
    """The CUDA kernel that runs an ``(n, m)`` matrix on a card of
    ``limits`` (SM count, shared memory a block may use): ``"resident"``,
    ``"grid"`` or ``"tiled"`` (the column-potential loop on the local-step
    kernel, for what the grid kernel cannot hold). The resident
    kernel's own check stays: a matrix of few cells can still be too wide
    for its band, v and partials, e.g. (4, 16384)."""
    from otgan_tpu_torch.ops.sinkhorn_grid_cuda import grid_supported
    from otgan_tpu_torch.ops.sinkhorn_resident_cuda import resident_supported

    if n * m <= RESIDENT_TIER_CELLS and resident_supported(n, m):
        return "resident"
    if grid_supported(n, m, limits):
        return "grid"
    return "tiled"


@torch.no_grad()
def sinkhorn_assignment(
    cost: torch.Tensor,
    lam: float,
    n_iters: int,
    use_pallas: bool = False,
    tol: float = 0.0,
):
    """Cost ``(..., N, M)`` -> (assignment P, mean row entropy).

    The plan is not differentiated: the reference seeds backprop at the
    feature tensors, so the cost is detached here. ``tol > 0`` takes the
    early-exit loop (a dynamic trip count the fixed-count kernels do not
    run); otherwise ``use_pallas`` selects a CUDA kernel by the matrix
    shape (:func:`kernel_tier`) and the card's limits; for a tensor on the
    CPU each tier runs its plain version, chosen as on an H100.
    """
    cost = cost.detach()
    if tol > 0.0:
        log_a, _ = sinkhorn_log_tol(-lam * cost.float(), n_iters, tol)
        return assignment_and_entropy(log_a)
    if use_pallas:
        from otgan_tpu_torch.ops.sinkhorn_cuda import sinkhorn_assignment_kernel
        from otgan_tpu_torch.ops.sinkhorn_grid_cuda import H100_LIMITS, card_limits, sinkhorn_grid
        from otgan_tpu_torch.ops.sinkhorn_resident_cuda import sinkhorn_resident

        limits = card_limits(cost.device) if cost.is_cuda else H100_LIMITS
        tier = kernel_tier(*cost.shape[-2:], limits)
        if tier == "resident":
            return sinkhorn_resident(cost, lam, n_iters)
        if tier == "grid":
            return sinkhorn_grid(cost, lam, n_iters)
        return sinkhorn_assignment_kernel(cost, lam, n_iters)
    log_a, _, _ = sinkhorn_log(-lam * cost.float(), n_iters)
    return assignment_and_entropy(log_a)
