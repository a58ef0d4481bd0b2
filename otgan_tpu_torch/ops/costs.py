"""Transport cost functions (counterpart of ``otgan_tpu/ops/costs.py``).

* cosine cost ``1 - f_a @ f_b.T`` for row-L2-normalised critic features;
* scaled squared-Euclidean cost ``||a - b||^2 / (2 d)`` for the toy pipeline.

Both run in true float32: lam = 500 amplifies cost error 500x in the
Sinkhorn logits, so TF32 (10-bit mantissa) is switched off for every
matching matmul. ``--matching_precision`` accepts ``highest`` only: the
TPU's ``high`` (bf16 x3, ~1e-6 error) has no measured Hopper equivalent yet.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest",)


def resolve_precision(precision) -> str:
    """Validate a ``--matching_precision`` value; ``None`` means highest."""
    if precision is None or precision == "highest":
        return "highest"
    if precision in ("high", "default"):
        raise NotImplementedError(
            f"matching precision {precision!r} has no measured Hopper "
            "lowering yet (a later slice); use 'highest'"
        )
    raise ValueError(
        f"matching precision must be one of {sorted(PRECISIONS)}, "
        f"got {precision!r}"
    )


def true_f32() -> None:
    """Pin float32 matmuls to full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False


def cosine_cost(f_a: torch.Tensor, f_b: torch.Tensor) -> torch.Tensor:
    """``1 - f_a @ f_b.T`` for row-L2-normalised features. (N,d),(M,d)->(N,M)."""
    true_f32()
    return 1.0 - torch.matmul(f_a.float(), f_b.float().T)


def scaled_sqeuclidean_cost(f_a: torch.Tensor, f_b: torch.Tensor) -> torch.Tensor:
    """Toy-example cost ``||a-b||^2 / (2 d)`` expanded as in the reference."""
    true_f32()
    a = f_a.float()
    b = f_b.float()
    d = a.shape[-1]
    asq = 0.5 * torch.mean(a.square(), dim=-1, keepdim=True)
    bsq = 0.5 * torch.mean(b.square(), dim=-1, keepdim=True).T
    return asq + bsq - torch.matmul(a, b.T) / d
