"""Toy MLP generator and critic for the 8-Gaussians 2D MED-GAN (counterpart
of ``otgan_tpu/models/toy_mlp.py``, after the reference's
``toy_example/med_gan_toy_example2.ipynb``, cells 0-1).

Critic: ``x / 4`` -> 32 -> 32 -> 32 -> 16 features, no normalisation; the
first dense has no pre-activation, the others the configured nonlinearity
(relu). Generator: ``z ~ N(0, 1)^256`` -> 128 -> 128 -> 128 -> 2, no output
nonlinearity (the modes sit at radius 2). Every layer is a plain dense
(``weight_norm=False``): V and b, V drawn at He scale. The toy is matched
with the scaled squared-Euclidean cost (``ops/costs.py``).

The JAX generator draws its latent inside the module from the step's key;
here the latent is an input, as in the DCGAN, and :func:`sample_latent`
draws it from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from otgan_tpu_torch.nn.layers import Dense, run_stages

LATENT_DIM = 256
FEATURE_DIM = 16


def sample_latent(batch_size: int, generator: Optional[torch.Generator] = None,
                  device="cpu", **model_opts) -> torch.Tensor:
    """``N(0, 1)^256`` latents (``otgan_tpu/models/toy_mlp.py:33``); the
    family's constructor options change nothing here."""
    return torch.randn((batch_size, LATENT_DIM), generator=generator, device=device)


def _add_dense_layers(module: nn.Module, widths, nonlinearity: str,
                      compute_dtype: torch.dtype) -> None:
    """Plain dense layers named ``dense_0``, ``dense_1``... as the JAX
    package's scope counters name them; the first has no pre-activation."""
    for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
        module.add_module(f"dense_{i}", Dense(
            w_in, w_out, pre_activation=None if i == 0 else nonlinearity,
            compute_dtype=compute_dtype, weight_norm=False))


class _MLP(nn.Module):
    """Plain dense layers; no save points, so ``--remat`` recomputes the
    whole MLP (``otgan_tpu/models/toy_mlp.py``: the policy is accepted for
    uniformity)."""

    def __init__(self, widths, nonlinearity: str, compute_dtype: torch.dtype,
                 remat: bool, remat_policy: str, scale: float = 1.0):
        super().__init__()
        del remat_policy  # no tagged points
        _add_dense_layers(self, widths, nonlinearity, compute_dtype)
        self.remat, self.scale = remat, scale

    def _layers(self, h: torch.Tensor) -> torch.Tensor:
        h = h / self.scale if self.scale != 1.0 else h
        for layer in self.children():
            h = layer(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_stages([(self._layers, ())], x, self.remat)


class Discriminator(_MLP):
    """Points (B, 2) -> features (B, 16); the notebook's critic scales its
    input by 1/4."""

    def __init__(self, nonlinearity: str = "relu", compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__((2, 32, 32, 32, FEATURE_DIM), nonlinearity, compute_dtype, remat,
                         remat_policy, scale=4.0)


class Generator(_MLP):
    """Latents (B, 256) -> points (B, 2)."""

    def __init__(self, nonlinearity: str = "relu", compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__((LATENT_DIM, 128, 128, 128, 2), nonlinearity, compute_dtype, remat,
                         remat_policy)


def make_discriminator(nonlinearity: str = "relu", compute_dtype=torch.float32,
                       remat: bool = False, remat_policy: str = ""):
    return Discriminator(nonlinearity, compute_dtype, remat, remat_policy)


def make_generator(nonlinearity: str = "relu", compute_dtype=torch.float32,
                   remat: bool = False, remat_policy: str = ""):
    return Generator(nonlinearity, compute_dtype, remat, remat_policy)
