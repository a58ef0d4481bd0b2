"""Matrix-parallel MED matching: whole cost matrices round-robined over the
ranks (counterpart of ``otgan_tpu/parallel/matching_matrix.py``; the
reference's own layout, ``utils/matching.py:49``).

Rank k owns the matrices ``m = (k + r K) % n_mats`` for ``r < ceil(n_mats /
K)`` and solves each whole through the single-device Sinkhorn path (on the
card the CUDA kernel ``sinkhorn_assignment`` picks by shape: the grid
kernel at the reference batch's 2500^2), with no collective per iteration. Each rank adds its matched-feature products,
weighted by ``1 / count`` for a matrix with several owners, into a
``(B, 4, d)`` accumulator that one reduce-scatter sums and cuts to local
rows; the entropy is one scalar all-reduce. The features are gathered once
per side. Outputs are the global matcher's rows, no permutation.

The matchers take and return this rank's rows, as in
``matching_sharded.py``, ``batch`` included.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from otgan_tpu_torch.ops.costs import cosine_cost, resolve_precision
from otgan_tpu_torch.ops.matching import MatchedFeatures
from otgan_tpu_torch.ops.sinkhorn import sinkhorn_assignment
from otgan_tpu_torch.parallel.matching_sharded import _global_batch, _mm
from otgan_tpu_torch.parallel.mesh import (
    ProcessGroup,
    all_gather_rows,
    rank_and_size,
    reduce_scatter_rows,
)


def _owner_counts(n_mats: int, n_dev: int):
    """Rounds, and how many (rank, round) slots own each matrix under
    ``m = (k + r n_dev) % n_mats``: slot ``j = k + r n_dev`` runs over
    ``range(n_dev * rounds)``, so ``count(m) = |{j : j % n_mats == m}| >= 1``."""
    rounds = max(1, -(-n_mats // n_dev))
    total = n_dev * rounds
    return rounds, [len(range(m, total, n_mats)) for m in range(n_mats)]


def _make_matcher(n_mats: int, solve_into: Callable, group: ProcessGroup,
                  two_batch: bool):
    @torch.no_grad()
    def matcher(features_a, features_b, batch: Optional[int] = None) -> MatchedFeatures:
        rank, size = rank_and_size(group)
        fa_loc = features_a.detach().float()
        fb_loc = features_b.detach().float()
        b_loc, d = fa_loc.shape
        B = _global_batch(b_loc, size, batch)
        if two_batch and B % 2 != 0:
            raise ValueError(f"two-batch matching needs an even global batch, got B={B}")
        fa = all_gather_rows(fa_loc, group)[:B]
        fb = all_gather_rows(fb_loc, group)[:B]
        rounds, counts = _owner_counts(n_mats, size)
        acc = fa.new_zeros((size * b_loc, 4, d))
        ent = fa.new_zeros(())
        for r in range(rounds):
            i = (rank + r * size) % n_mats
            ent += solve_into(i, fa, fb, acc, 1.0 / counts[i])
        loc = reduce_scatter_rows(acc, group)  # (b_loc, 4, d)
        dist.all_reduce(ent, group=group)
        return MatchedFeatures(loc[:, 0], loc[:, 1], loc[:, 2], loc[:, 3], ent / n_mats)

    return matcher


def make_matrix_parallel_two_batch_matcher(
    group: ProcessGroup,
    lam: float,
    n_iters: int,
    cost_fn: Callable = cosine_cost,
    tol: float = 0.0,
    use_pallas: bool = False,
    precision: Optional[str] = None,
):
    """The 6 two-batch matrices (reference order a1a2, b2b1, a1b1, a1b2,
    a2b1, a2b2, ``utils/matching.py:41-43``) solved whole on their owners."""
    resolve_precision(precision)

    def solve_into(i, fa, fb, acc, w):
        """Solve matrix ``i`` and add its weighted products into ``acc``
        (slots a_a, b_b, a_b, b_a; ``ops/matching.py`` recombination)."""
        B = fa.shape[0]
        n = B // 2
        fa1, fa2, fb1, fb2 = fa[:n], fa[n:], fb[:n], fb[n:]
        rows, cols = ((fa1, fa2), (fb2, fb1), (fa1, fb1),
                      (fa1, fb2), (fa2, fb1), (fa2, fb2))[i]
        p, ent = sinkhorn_assignment(cost_fn(rows, cols), lam, n_iters,
                                     use_pallas=use_pallas, tol=tol)
        lo, hi = slice(0, n), slice(n, B)
        h = 0.5 * w
        if i == 0:  # a1a2
            acc[lo, 0] += w * _mm(p, fa2)
            acc[hi, 0] += w * _mm(p.T, fa1)
        elif i == 1:  # b2b1
            acc[hi, 1] += w * _mm(p, fb1)
            acc[lo, 1] += w * _mm(p.T, fb2)
        elif i == 2:  # a1b1
            acc[lo, 2] += h * _mm(p, fb1)
            acc[lo, 3] += h * _mm(p.T, fa1)
        elif i == 3:  # a1b2
            acc[lo, 2] += h * _mm(p, fb2)
            acc[hi, 3] += h * _mm(p.T, fa1)
        elif i == 4:  # a2b1
            acc[hi, 2] += h * _mm(p, fb1)
            acc[lo, 3] += h * _mm(p.T, fa2)
        else:  # a2b2
            acc[hi, 2] += h * _mm(p, fb2)
            acc[hi, 3] += h * _mm(p.T, fa2)
        return w * ent

    return _make_matcher(6, solve_into, group, two_batch=True)


def make_matrix_parallel_single_batch_matcher(
    group: ProcessGroup,
    lam: float,
    n_iters: int,
    cost_fn: Callable = cosine_cost,
    tol: float = 0.0,
    use_pallas: bool = False,
    precision: Optional[str] = None,
):
    """Single-batch variant (reference ``get_matched_features_single_batch``,
    ``utils/matching.py:88-136``): a·a and b·b with the +999 self-match
    diagonal, and a·b, each solved whole on its owners."""
    resolve_precision(precision)

    def solve_into(i, fa, fb, acc, w):
        B = fa.shape[0]
        if i < 2:
            f = fa if i == 0 else fb
            cost = cost_fn(f, f) + 999.0 * torch.eye(B, dtype=torch.float32, device=f.device)
        else:
            cost = cost_fn(fa, fb)
        p, ent = sinkhorn_assignment(cost, lam, n_iters, use_pallas=use_pallas, tol=tol)
        if i == 0:
            acc[:B, 0] += w * _mm(p, fa)
        elif i == 1:
            acc[:B, 1] += w * _mm(p, fb)
        else:
            acc[:B, 2] += w * _mm(p, fb)
            acc[:B, 3] += w * _mm(p.T, fa)
        return w * ent

    return _make_matcher(3, solve_into, group, two_batch=False)
