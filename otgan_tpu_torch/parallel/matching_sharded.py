"""Row-sharded MED matching over a process group (counterpart of
``otgan_tpu/parallel/matching_sharded.py``).

Each rank holds its contiguous rows of the global batch and computes the
row blocks ``(n_mats, n_loc, N)`` of every cost matrix against the gathered
features. Then

* the Sinkhorn row step is local (rows are whole on a rank): one local step
  per iteration, in the CUDA kernels of ``ops/sinkhorn_step_cuda.py`` on
  the card;
* the column step is a logsumexp across ranks: ``all_reduce(MAX)`` of the
  local column maxima, then ``all_reduce(SUM)`` of the rescaled sums, two
  small ``(n_mats, N)`` collectives per iteration and no host sync;
* ``tol > 0`` stops on the sup-norm movement of the column potential,
  which the all-reduces make bitwise identical on every rank, so every rank
  stops at the same iteration (one scalar read back per iteration). Without
  it the loop reads nothing back and its collectives are synchronous on the
  current stream, so a CUDA graph captures the whole match (``--fused_cycle``
  on K ranks; the tol branch stays eager);
* matched features: direct products of local rows, and transposed products
  as partial sums reduce-scattered straight to local rows.

Each row of ``-lam * C`` is shifted by its max before the loop, as
``ops/sinkhorn_cuda.py`` does: the row potential absorbs the shift, and
float32 then iterates near 0 instead of near lam.

Batch halves (two-batch): when ``B/2`` divides over the K ranks, each rank
splits its LOCAL batch in half, the JAX package's convention; outputs equal
the global matcher's after :func:`sharded_permutation`. Otherwise the
halves are zero-padded and interleaved (:func:`_arrange_halves`) with the
``[[C, 999], [999, 0]]`` pad construction, and the outputs come back in the
global matcher's row order: the features are gathered (the matcher needs
them whole anyway), each rank matches its arranged block, and the arranged
outputs are gathered and this rank's contiguous rows kept.

The matchers take ``(features_a, features_b)`` as this rank's rows and
return this rank's rows of the matched features and the global entropy.
``batch`` gives the global batch when it does not divide over the ranks:
rank k then holds rows ``[k b, (k+1) b)`` of the batch zero-padded to
``K b`` rows, and the pad rows of its outputs are to be dropped.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from otgan_tpu_torch.ops.costs import cosine_cost, matmul, resolve_precision
from otgan_tpu_torch.ops.matching import MatchedFeatures, with_precision
from otgan_tpu_torch.ops.sinkhorn_step_cuda import make_local_step
from otgan_tpu_torch.parallel.mesh import (
    ProcessGroup,
    all_gather_rows,
    rank_and_size,
    reduce_scatter_rows,
)

# Pad-block cost of the [[C, M], [M, 0]] construction: exp(-lam * (999 -
# O(1))) underflows to exactly 0.0 in float32 for every lam >= 50, so no
# mass crosses between real and pad rows or columns.
_PAD_COST = 999.0


def _bind_precision(cost_fn: Callable, precision: Optional[str]):
    """``(cost_fn, mm)`` of the matcher makers at ``--matching_precision``
    (``otgan_tpu/parallel/matching_sharded.py::_bind_precision``)."""
    resolve_precision(precision)
    return with_precision(cost_fn, precision), functools.partial(matmul, precision=precision)


@torch.no_grad()
def sharded_sinkhorn_rows(
    x_loc: torch.Tensor,
    n_iters: int,
    group: ProcessGroup,
    tol: float = 0.0,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Sinkhorn on row-sharded logits ``x_loc`` ``(b, n_loc, N)``. Returns
    the log assignment up to per-row constants, ``x + v``, for the row
    softmax that follows."""
    x = x_loc.detach().float()
    x = (x - torch.amax(x, dim=-1, keepdim=True)).contiguous()
    step = make_local_step(x, use_kernel)

    def iterate(v):
        m_loc, s_loc = step(v)
        m_glob = m_loc.clone()
        dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
        s_glob = s_loc * torch.exp(m_loc - m_glob)
        dist.all_reduce(s_glob, group=group)
        return -(m_glob + torch.log(s_glob))

    v = x.new_zeros((x.shape[0], x.shape[2]))
    if tol > 0.0:
        i, delta = 0, float("inf")
        while i < n_iters and delta >= tol:
            v_new = iterate(v)
            delta = float(torch.max(torch.abs(v_new - v)))
            v, i = v_new, i + 1
    else:
        for _ in range(n_iters):
            v = iterate(v)
    return x + v[:, None, :]


def _row_softmax_entropy(
    log_a: torch.Tensor,
    group: ProcessGroup,
    row_ok: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
):
    """Row softmax and the global mean row entropy; with ``row_ok`` and
    ``n_valid`` the pad rows are left out of the mean."""
    p = torch.softmax(log_a, dim=-1)
    ent_rows = -torch.sum(p * torch.log_softmax(log_a, dim=-1), dim=-1)
    size = dist.get_world_size(group)
    if row_ok is None:
        ent = torch.mean(ent_rows)
        dist.all_reduce(ent, group=group)
        return p, ent / size
    ent = torch.sum(torch.where(row_ok[None, :], ent_rows, 0.0))
    dist.all_reduce(ent, group=group)
    return p, ent / (ent_rows.shape[0] * n_valid)


def _mask_pad_costs(costs: torch.Tensor, row_ok: torch.Tensor, col_ok: torch.Tensor):
    """The [[C, M], [M, 0]] pad construction on stacked ``(n_mats, n_loc,
    N)`` cost rows: real-real entries keep C, real-pad crossings cost
    ``_PAD_COST``, the pad-pad block costs 0."""
    both = row_ok[:, None] & col_ok[None, :]
    neither = (~row_ok[:, None]) & (~col_ok[None, :])
    pad = torch.where(neither, 0.0, _PAD_COST).to(costs.dtype)
    return torch.where(both, costs, pad)


def _arrange_halves(f: torch.Tensor, n_dev: int, n_loc: int, n_half: int):
    """Zero-pad each batch half of ``f`` ``(2 n_half, ...)`` to ``n_dev *
    n_loc`` rows and interleave them so that rank k's contiguous block is
    ``[half1 slice; half2 slice]``."""
    rest = tuple(f.shape[1:])
    z = f.new_zeros((n_dev * n_loc - n_half,) + rest)
    h1 = torch.cat([f[:n_half], z]).reshape((n_dev, n_loc) + rest)
    h2 = torch.cat([f[n_half:], z]).reshape((n_dev, n_loc) + rest)
    return torch.cat([h1, h2], dim=1).reshape((2 * n_dev * n_loc,) + rest)


def _unarrange_halves(out: torch.Tensor, n_dev: int, n_loc: int, n_half: int):
    """Inverse of :func:`_arrange_halves`: ``[half1; half2]`` row order,
    pad rows dropped."""
    rest = tuple(out.shape[1:])
    blocks = out.reshape((n_dev, 2, n_loc) + rest)
    h1 = blocks[:, 0].reshape((n_dev * n_loc,) + rest)[:n_half]
    h2 = blocks[:, 1].reshape((n_dev * n_loc,) + rest)[:n_half]
    return torch.cat([h1, h2])


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def _global_batch(b_loc: int, size: int, batch: Optional[int]) -> int:
    B = size * b_loc if batch is None else batch
    if not (size * (b_loc - 1) < B <= size * b_loc):
        raise ValueError(
            f"global batch {B} does not split into {size} blocks of {b_loc} rows"
        )
    return B


def make_sharded_two_batch_matcher(
    group: ProcessGroup,
    lam: float,
    n_iters: int,
    cost_fn: Callable = cosine_cost,
    tol: float = 0.0,
    use_pallas: bool = False,
    precision: Optional[str] = None,
):
    """``(features_a, features_b) -> MatchedFeatures`` on this rank's rows,
    row-sharded over ``group``. Any even global batch."""
    cost_fn, _mm = _bind_precision(cost_fn, precision)

    def local(fa_blk, fb_blk, halves: List[torch.Tensor], rank: int,
              n_valid: Optional[int]):
        """Match this rank's block ``[half1 rows; half2 rows]`` against the
        gathered halves ``(fa1, fa2, fb1, fb2)``; ``n_valid`` = real rows per
        half when the halves are tail-padded."""
        n_loc = fa_blk.shape[0] // 2
        fa1l, fa2l = fa_blk[:n_loc], fa_blk[n_loc:]
        fb1l, fb2l = fb_blk[:n_loc], fb_blk[n_loc:]
        fa1, fa2, fb1, fb2 = halves
        # row blocks of the 6 matrices, reference order (utils/matching.py:41-43)
        costs = torch.stack([
            cost_fn(fa1l, fa2), cost_fn(fb2l, fb1), cost_fn(fa1l, fb1),
            cost_fn(fa1l, fb2), cost_fn(fa2l, fb1), cost_fn(fa2l, fb2),
        ])
        row_ok = None
        if n_valid is not None:
            dev = costs.device
            col_ok = torch.arange(fa1.shape[0], device=dev) < n_valid
            row_ok = rank * n_loc + torch.arange(n_loc, device=dev) < n_valid
            costs = _mask_pad_costs(costs, row_ok, col_ok)
        log_a = sharded_sinkhorn_rows(-lam * costs, n_iters, group, tol, use_pallas)
        del costs
        p, entropy = _row_softmax_entropy(log_a, group, row_ok, n_valid)
        del log_a
        p_a1a2, p_b2b1, p_a1b1, p_a1b2, p_a2b1, p_a2b2 = p
        # direct products: local rows x gathered features
        a1_a = _mm(p_a1a2, fa2)
        b2_b = _mm(p_b2b1, fb1)
        a1_b = 0.5 * (_mm(p_a1b1, fb1) + _mm(p_a1b2, fb2))
        a2_b = 0.5 * (_mm(p_a2b1, fb1) + _mm(p_a2b2, fb2))
        # transposed products: partial sums over local rows, reduce-scattered
        # to local rows (batch first, for the scatter along dim 0)
        partials = torch.stack([
            _mm(p_a1a2.T, fa1l),
            _mm(p_b2b1.T, fb2l),
            _mm(p_a1b1.T, fa1l) + _mm(p_a2b1.T, fa2l),
            _mm(p_a1b2.T, fa1l) + _mm(p_a2b2.T, fa2l),
        ], dim=1)  # (N, 4, d)
        del p
        loc = reduce_scatter_rows(partials, group)  # (n_loc, 4, d)
        return (
            torch.cat([a1_a, loc[:, 0]]),
            torch.cat([loc[:, 1], b2_b]),
            torch.cat([a1_b, a2_b]),
            torch.cat([0.5 * loc[:, 2], 0.5 * loc[:, 3]]),
            entropy,
        )

    @torch.no_grad()
    def matcher(features_a, features_b, batch: Optional[int] = None) -> MatchedFeatures:
        rank, size = rank_and_size(group)
        fa_loc = features_a.detach().float()
        fb_loc = features_b.detach().float()
        b_loc = fa_loc.shape[0]
        B = _global_batch(b_loc, size, batch)
        if B % 2 != 0:
            raise ValueError(
                f"two-batch matching needs an even global batch, got B={B} "
                "(the reference enforces this via `assert nr_gpu % 2 == 0`, "
                "train.py:34)"
            )
        n_half = B // 2
        if B == size * b_loc and n_half % size == 0:
            # whole local halves: rank k's rows [0, b/2) are its "batch 1"
            n_loc = b_loc // 2
            halves = [
                all_gather_rows(t, group)
                for t in (fa_loc[:n_loc], fa_loc[n_loc:], fb_loc[:n_loc], fb_loc[n_loc:])
            ]
            return MatchedFeatures(*local(fa_loc, fb_loc, halves, rank, None))
        # uneven halves: gather, arrange, match this rank's block, gather the
        # arranged outputs and keep this rank's rows in global order
        n_loc = -(-n_half // size)
        blk = slice(rank * 2 * n_loc, (rank + 1) * 2 * n_loc)
        arranged = [
            _arrange_halves(all_gather_rows(f, group)[:B], size, n_loc, n_half)
            for f in (fa_loc, fb_loc)
        ]
        halves = []
        for f in arranged:
            h = f.reshape(size, 2, n_loc, -1)
            halves += [h[:, 0].reshape(size * n_loc, -1), h[:, 1].reshape(size * n_loc, -1)]
        *outs, entropy = local(arranged[0][blk], arranged[1][blk], halves, rank, n_half)
        del arranged, halves
        full = _unarrange_halves(
            all_gather_rows(torch.stack(outs, dim=1), group), size, n_loc, n_half
        )  # (B, 4, d)
        mine = _pad_rows(full, size * b_loc)[rank * b_loc:(rank + 1) * b_loc]
        return MatchedFeatures(mine[:, 0], mine[:, 1], mine[:, 2], mine[:, 3], entropy)

    return matcher


def make_sharded_single_batch_matcher(
    group: ProcessGroup,
    lam: float,
    n_iters: int,
    cost_fn: Callable = cosine_cost,
    tol: float = 0.0,
    use_pallas: bool = False,
    precision: Optional[str] = None,
):
    """Row-sharded single-batch matcher (reference
    ``get_matched_features_single_batch``, ``utils/matching.py:88-136``): 3
    matrices, ``+999`` on the self-match diagonals. Outputs are the global
    ``match_single_batch`` rows, no permutation."""
    cost_fn, _mm = _bind_precision(cost_fn, precision)

    @torch.no_grad()
    def matcher(features_a, features_b, batch: Optional[int] = None) -> MatchedFeatures:
        rank, size = rank_and_size(group)
        fa_loc = features_a.detach().float()
        fb_loc = features_b.detach().float()
        b_loc = fa_loc.shape[0]
        B = _global_batch(b_loc, size, batch)
        fa = all_gather_rows(fa_loc, group)  # (K b, d), pad rows included
        fb = all_gather_rows(fb_loc, group)
        dev = fa.device
        rows = rank * b_loc + torch.arange(b_loc, device=dev)
        cols = torch.arange(fa.shape[0], device=dev)
        eye_blk = torch.where(rows[:, None] == cols[None, :], 999.0, 0.0)
        costs = torch.stack([
            cost_fn(fa_loc, fa) + eye_blk,
            cost_fn(fb_loc, fb) + eye_blk,
            cost_fn(fa_loc, fb),
        ])
        row_ok, n_valid = None, None
        if B != fa.shape[0]:
            row_ok, n_valid = rows < B, B
            costs = _mask_pad_costs(costs, row_ok, cols < B)
        log_a = sharded_sinkhorn_rows(-lam * costs, n_iters, group, tol, use_pallas)
        del costs
        p, entropy = _row_softmax_entropy(log_a, group, row_ok, n_valid)
        p_aa, p_bb, p_ab = p
        b_a = reduce_scatter_rows(_mm(p_ab.T, fa_loc), group)
        return MatchedFeatures(_mm(p_aa, fa), _mm(p_bb, fb), _mm(p_ab, fb), b_a, entropy)

    return matcher


def sharded_permutation(batch: int, n_dev: int):
    """Global-batch permutation mapping the local-half convention onto the
    global matcher's B/2 split: ``permuted[i]`` is the global row whose
    sharded role equals global-matcher row ``i``."""
    b_loc = batch // n_dev
    n_loc = b_loc // 2
    first = [k * b_loc + i for k in range(n_dev) for i in range(n_loc)]
    second = [k * b_loc + n_loc + i for k in range(n_dev) for i in range(n_loc)]
    return first + second
