"""8-Gaussians 2D toy dataset (counterpart of ``otgan_tpu/data/toy.py``;
reference ``toy_example/med_gan_toy_example2.ipynb``, ``gaussians_8mode``):
8 centers on a radius-2 circle (axes + diagonals), isotropic noise std 0.2.
Pure numpy, drawn in the JAX package's order, so one
``numpy.random.Generator`` gives both packages the same points."""

from __future__ import annotations

import numpy as np

_S = 1.0 / np.sqrt(2.0)
GAUSSIAN_CENTERS = 2.0 * np.asarray(
    [
        (1, 0),
        (-1, 0),
        (0, 1),
        (0, -1),
        (_S, _S),
        (_S, -_S),
        (-_S, _S),
        (-_S, -_S),
    ],
    np.float32,
)


def sample_8gaussians(
    rng: np.random.Generator, n: int, noise_std: float = 0.2
) -> np.ndarray:
    idx = rng.integers(0, len(GAUSSIAN_CENTERS), n)
    return (
        GAUSSIAN_CENTERS[idx]
        + noise_std * rng.standard_normal((n, 2)).astype(np.float32)
    ).astype(np.float32)


def mode_coverage(
    samples: np.ndarray, radius: float = 0.6, min_frac: float = 0.02
) -> int:
    """Number of the 8 modes holding at least ``min_frac`` of the samples
    within ``radius`` — the success criterion of the reference's toy
    notebooks (KDE plots covering all 8 modes)."""
    covered = 0
    for c in GAUSSIAN_CENTERS:
        frac = np.mean(np.linalg.norm(samples - c, axis=1) < radius)
        covered += int(frac >= min_frac)
    return covered
