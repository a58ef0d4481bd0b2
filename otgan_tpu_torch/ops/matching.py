"""Optimal-transport minibatch matching (counterpart of
``otgan_tpu/ops/matching.py``).

Every matcher is a function of the global feature matrices ``(B, d)``:

* ``match_two_batch``: the paper's estimator, 6 cosine-cost matrices, one
  batched Sinkhorn, 12 matched-feature matmuls (``utils/matching.py:11-85``);
* ``match_single_batch``: 3 matrices with ``+999 I`` on the self-match
  diagonals (``utils/matching.py:88-136``);
* ``match_random``: the ``--no_sinkhorn`` ablation, a roll by one shard.

Matched features carry no gradient: the reference seeds backprop at the
feature tensors, so the matchers run under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from otgan_tpu_torch.ops.costs import cosine_cost, resolve_precision, true_f32
from otgan_tpu_torch.ops.sinkhorn import sinkhorn_assignment


class MatchedFeatures(NamedTuple):
    """Reference return order ``(a_a, b_b, a_b, b_a, entropy)``, a =
    generated, b = data (``utils/matching.py:85``)."""

    a_a: torch.Tensor
    b_b: torch.Tensor
    a_b: torch.Tensor
    b_a: torch.Tensor
    entropy: torch.Tensor


def _mm(p: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    true_f32()
    return torch.matmul(p, f)


def two_batch_costs(
    features_a: torch.Tensor,
    features_b: torch.Tensor,
    cost_fn: Callable = cosine_cost,
) -> torch.Tensor:
    """The 6 stacked cost matrices in reference order: a1a2, b2b1, a1b1,
    a1b2, a2b1, a2b2 (``utils/matching.py:41-43``)."""
    n = features_a.shape[0] // 2
    fa1, fa2 = features_a[:n], features_a[n:]
    fb1, fb2 = features_b[:n], features_b[n:]
    return torch.stack(
        [
            cost_fn(fa1, fa2),
            cost_fn(fb2, fb1),
            cost_fn(fa1, fb1),
            cost_fn(fa1, fb2),
            cost_fn(fa2, fb1),
            cost_fn(fa2, fb2),
        ]
    )


@torch.no_grad()
def match_two_batch(
    features_a: torch.Tensor,
    features_b: torch.Tensor,
    lam: float = 500.0,
    n_iters: int = 500,
    cost_fn: Callable = cosine_cost,
    use_pallas: bool = False,
    tol: float = 0.0,
    precision: str | None = None,
) -> MatchedFeatures:
    """Two-batch MED matching (reference ``get_matched_features``)."""
    resolve_precision(precision)
    B = features_a.shape[0]
    if B % 2 != 0:
        raise ValueError(
            f"two-batch matching needs an even global batch, got B={B} "
            "(the reference enforces this via `assert nr_gpu % 2 == 0`, "
            "train.py:34)"
        )
    n = B // 2
    fa = features_a.detach().float()
    fb = features_b.detach().float()
    fa1, fa2 = fa[:n], fa[n:]
    fb1, fb2 = fb[:n], fb[n:]
    costs = two_batch_costs(fa, fb, cost_fn)
    p, ent = sinkhorn_assignment(costs, lam, n_iters, use_pallas=use_pallas, tol=tol)
    p_a1a2, p_b2b1, p_a1b1, p_a1b2, p_a2b1, p_a2b2 = p

    a_a = torch.cat([_mm(p_a1a2, fa2), _mm(p_a1a2.T, fa1)])
    b_b = torch.cat([_mm(p_b2b1.T, fb2), _mm(p_b2b1, fb1)])
    a_b = 0.5 * torch.cat(
        [
            _mm(p_a1b1, fb1) + _mm(p_a1b2, fb2),
            _mm(p_a2b1, fb1) + _mm(p_a2b2, fb2),
        ]
    )
    b_a = 0.5 * torch.cat(
        [
            _mm(p_a1b1.T, fa1) + _mm(p_a2b1.T, fa2),
            _mm(p_a1b2.T, fa1) + _mm(p_a2b2.T, fa2),
        ]
    )
    return MatchedFeatures(a_a, b_b, a_b, b_a, torch.mean(ent))


@torch.no_grad()
def match_single_batch(
    features_a: torch.Tensor,
    features_b: torch.Tensor,
    lam: float = 500.0,
    n_iters: int = 500,
    cost_fn: Callable = cosine_cost,
    use_pallas: bool = False,
    tol: float = 0.0,
    precision: str | None = None,
) -> MatchedFeatures:
    """Single-batch matching (reference ``get_matched_features_single_batch``):
    self-match diagonals get +999 (``utils/matching.py:109-110``)."""
    resolve_precision(precision)
    fa = features_a.detach().float()
    fb = features_b.detach().float()
    B = fa.shape[0]
    eye = 999.0 * torch.eye(B, dtype=torch.float32, device=fa.device)
    costs = torch.stack(
        [cost_fn(fa, fa) + eye, cost_fn(fb, fb) + eye, cost_fn(fa, fb)]
    )
    p, ent = sinkhorn_assignment(costs, lam, n_iters, use_pallas=use_pallas, tol=tol)
    p_aa, p_bb, p_ab = p
    return MatchedFeatures(
        _mm(p_aa, fa), _mm(p_bb, fb), _mm(p_ab, fb), _mm(p_ab.T, fa),
        torch.mean(ent),
    )


@torch.no_grad()
def match_random(
    features_a: torch.Tensor, features_b: torch.Tensor, shard_size: int
) -> MatchedFeatures:
    """``--no_sinkhorn`` ablation (reference ``get_matched_features_random``):
    the per-device list rotated by one is a roll by one shard of rows."""
    fa = features_a.detach()
    fb = features_b.detach()
    return MatchedFeatures(
        torch.roll(fa, -shard_size, dims=0),
        torch.roll(fb, -shard_size, dims=0),
        fb,
        fa,
        torch.zeros((), dtype=torch.float32, device=fa.device),
    )


def calc_distance(
    features_a: torch.Tensor, features_b: torch.Tensor, matched: MatchedFeatures
) -> torch.Tensor:
    """Reported MED distance (``utils/matching.py:139-153``):
    ``(<f_a,f_aa> + <f_b,f_bb> - 2<f_a,f_ab>) / (2 B)``."""
    B = features_a.shape[0]
    nd_aa = torch.sum(features_a * matched.a_a)
    nd_bb = torch.sum(features_b * matched.b_b)
    nd_ab = torch.sum(features_a * matched.a_b)
    return (nd_bb + nd_aa - 2.0 * nd_ab) / (2.0 * B)


def calc_distance_mean(
    features_a: torch.Tensor, features_b: torch.Tensor, matched: MatchedFeatures
) -> torch.Tensor:
    """Toy variant (``toy_example/matching_cpu.py:155-164``): mean-based
    inner products, divided by 2."""
    nd_aa = torch.mean(features_a * matched.a_a)
    nd_bb = torch.mean(features_b * matched.b_b)
    nd_ab = torch.mean(features_a * matched.a_b)
    return (nd_bb + nd_aa - 2.0 * nd_ab) / 2.0
