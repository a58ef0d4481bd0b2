"""Transport cost functions and the matching matmul (counterpart of
``otgan_tpu/ops/costs.py``).

* cosine cost ``1 - f_a @ f_b.T`` for row-L2-normalised critic features;
* scaled squared-Euclidean cost ``||a - b||^2 / (2 d)`` for the toy pipeline.

``--matching_precision`` picks how every matching matmul (cost and
matched-feature) runs, as on the TPU (DESIGN.md section 7):

* ``highest`` (default): true float32, TF32 off. lam = 500 amplifies cost
  error 500x in the Sinkhorn logits, so this is what the invariants assume;
* ``high``: 3xTF32, the counterpart of the TPU's 3-pass bf16. Each operand
  is split into ``hi`` (rounded to TF32's 10 mantissa bits) and ``lo = a -
  hi`` (exact in float32); the product is ``hi@hi + (hi@lo + lo@hi)``,
  three TF32 tensor-core passes, the small terms summed first, each pass
  over K in chunks (``HIGH_K_CHUNK``) added in float32. Each product
  splits its own operands;
* ``default``: one TF32 pass, for measurement only.

:func:`matmul_precision` scopes the card's float32-matmul mode to a block
and gives the caller's setting back after it; cuDNN's flag (the model's
convs) is never touched. On the CPU, where torch has no TF32, the lowering
is emulated: both operands of each pass are rounded to TF32, then
multiplied in float32.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch

PRECISIONS = ("highest", "high", "default")


def resolve_precision(precision) -> str:
    """Validate a ``--matching_precision`` value; ``None`` means highest."""
    if precision is None:
        return "highest"
    if precision in PRECISIONS:
        return precision
    raise ValueError(
        f"matching precision must be one of {sorted(PRECISIONS)}, "
        f"got {precision!r}"
    )


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]) -> Iterator[None]:
    """The card's float32 matmuls in the block: TF32 off for ``highest``,
    on for ``high`` and ``default``; the caller's setting is restored."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = resolve_precision(precision) != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even, by
    integer ops on the bits (the low 13 bits come out zero)."""
    bits = a.float().contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & -8192
    return bits.view(torch.float32)


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: ``hi`` = ``a`` rounded to TF32, ``lo = a - hi`` (exact,
    ``|lo| <= 2^-11 |a|``)."""
    hi = round_tf32(a)
    return hi, a - hi


def _tf32_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: the tensor cores on the card (the caller holds
    TF32 on), both operands rounded to TF32 elsewhere."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(round_tf32(a), round_tf32(b))


# ``high``'s passes sum a long K in chunks of this many terms, the chunks'
# results added in float32: on the card the tensor cores' accumulation over
# K = 32768 loses more than the split gains (a cost's error 2.3e-6 whole,
# 2.0e-7 in chunks of 2048, against true float32's 8.0e-8 at batch 5000 on an
# H100: ``measure_precision.py``)
HIGH_K_CHUNK = 2048


def _chunked_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_tf32_pass` of ``(n, K) @ (K, m)``, K in chunks of at most
    HIGH_K_CHUNK (one batched product, then a float32 sum over the chunks)
    when the chunks' partial outputs are no larger than the operands (the
    costs: 2500^2 outputs of K = 32768); otherwise in one pass (a matched
    feature product's (2500, 32768) outputs of K = 2500)."""
    (n, k), m = a.shape, b.shape[-1]
    c = -(-k // HIGH_K_CHUNK)
    if c <= 1 or c * n * m > (n + m) * k:
        return _tf32_pass(a, b)
    if k % c:
        return sum(_tf32_pass(x, y) for x, y in zip(a.split(HIGH_K_CHUNK, 1),
                                                    b.split(HIGH_K_CHUNK, 0)))
    return _tf32_pass(a.unflatten(1, (c, k // c)).movedim(1, 0),
                      b.unflatten(0, (c, k // c))).sum(0)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: Optional[str] = None) -> torch.Tensor:
    """``a @ b`` of float32 operands at a matching precision."""
    precision = resolve_precision(precision)
    with matmul_precision(precision):
        if precision == "highest":
            return torch.matmul(a, b)
        if precision == "default":
            return _tf32_pass(a, b)
        a_hi, a_lo = tf32_split(a)
        b_hi, b_lo = tf32_split(b)
        return _chunked_pass(a_hi, b_hi) + (_chunked_pass(a_hi, b_lo)
                                            + _chunked_pass(a_lo, b_hi))


def cosine_cost(f_a: torch.Tensor, f_b: torch.Tensor,
                precision: Optional[str] = None) -> torch.Tensor:
    """``1 - f_a @ f_b.T`` for row-L2-normalised features. (N,d),(M,d)->(N,M)."""
    return 1.0 - matmul(f_a.float(), f_b.float().T, precision)


def scaled_sqeuclidean_cost(f_a: torch.Tensor, f_b: torch.Tensor,
                            precision: Optional[str] = None) -> torch.Tensor:
    """Toy-example cost ``||a-b||^2 / (2 d)`` expanded as in the reference."""
    a = f_a.float()
    b = f_b.float()
    d = a.shape[-1]
    asq = 0.5 * torch.mean(a.square(), dim=-1, keepdim=True)
    bsq = 0.5 * torch.mean(b.square(), dim=-1, keepdim=True).T
    return asq + bsq - matmul(a, b.T, precision) / d
