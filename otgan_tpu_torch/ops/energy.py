"""1-D energy distance by per-feature monotone coupling (counterpart of
``otgan_tpu/ops/energy.py``; reference ``utils/nn.py:6-27``, unused by its
training script): samples and data are sorted per feature column and paired by
rank, the exact 1-D optimal-transport coupling in O(N log N). Plain torch.

The sorts are stable (``jnp.argsort`` is, ``torch.argsort`` is not by
default), so tied values pair as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


@torch.no_grad()
def energy_distance(f_sample: torch.Tensor, f_data: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column rank pairing. Returns ``(loss, grads)`` with ``grads[i, j]
    = f_sample[i, j] - f_data[rank_match(i), j]`` (the reference's injected
    gradient) and ``loss = mean(grads ** 2)``."""
    idx_s = torch.argsort(f_sample, dim=0, stable=True)  # (N, d) sample ranks
    sorted_s = torch.take_along_dim(f_sample, idx_s, dim=0)
    sorted_d = torch.sort(f_data, dim=0, stable=True).values
    diff_sorted = sorted_s - sorted_d
    # residuals back to the samples' order
    inv = torch.argsort(idx_s, dim=0, stable=True)
    grads = torch.take_along_dim(diff_sorted, inv, dim=0)
    return torch.mean(grads.square()), grads


def weight_decay(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of squares over the matrix-shaped (ndim >= 2) parameters
    (reference ``utils/nn.py:22-27``), in key order as the JAX package
    walks a dict."""
    leaves = [params[k] for k in sorted(params) if params[k].dim() >= 2]
    return sum(torch.sum(p.square()) for p in leaves)
