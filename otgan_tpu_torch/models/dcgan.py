"""DCGAN generator and critic (counterpart of ``otgan_tpu/models/dcgan.py``,
after the reference's ``models/dcgan.py``).

Critic: four 5x5 weight-norm convs (128 -> 256 -> 512 -> 1024, stride-2
downsampling, crelu pre-activations), a CReLU concat, an NHWC flatten and a
row L2 normalisation: a unit feature of 4*4*2048 = 32768 values.

Generator: latent ``u ~ U(-1, 1)^100`` -> dense to 2*4*4*1024 with a GLU
gate -> (B, 4, 4, 1024) NHWC -> three (NN upsample, 5x5 conv, GLU) stages to
32x32 -> a 5x5 conv to 3 channels with init_scale 0.1 -> tanh. The latent is
an input, so a test can feed the JAX package's draw; :func:`sample_latent`
draws it from a ``torch.Generator``.

Layer names follow the JAX package's scope counters (``dense_0``,
``conv2d_0``...), so parameter names map one to one. The forwards are
stages tagged with the JAX package's save points (``disc_c2..4``,
``gen_g1..3``) for ``--remat`` / ``--remat_policy`` (``nn/layers.py``).

At bf16 on the card (``layer_boundary.engages``) each boundary between two layers runs
as one operator (``nn/layer_boundary.py``): a layer stops before its bias
(``pre_bias``), and the boundary adds it, applies the next conv's CReLU and
SAME padding or the GLU and the next conv's upsample, and writes the next
conv's input. The carries between stages, and so the save points, are then
the layers' outputs before their bias; values and gradients are the plain
layers'.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from otgan_tpu_torch.nn.layer_boundary import crelu_pad, engages, glu_upsample
from otgan_tpu_torch.nn.layers import (
    Conv2d,
    Dense,
    glu,
    l2_normalize_rows,
    run_stages,
    save_names,
)

LATENT_DIM = 100


def sample_latent(batch_size: int, generator: Optional[torch.Generator] = None,
                  device="cpu", **model_opts) -> torch.Tensor:
    """``U(-1, 1)^100`` latents (reference ``models/dcgan.py:30``); the
    family's constructor options change nothing here."""
    u = torch.rand((batch_size, LATENT_DIM), generator=generator, device=device)
    return u * 2.0 - 1.0


def _head(x: torch.Tensor) -> torch.Tensor:
    """CReLU concat, NHWC flatten, row L2 normalisation."""
    x = torch.relu(torch.cat([x, -x], dim=-1))
    return l2_normalize_rows(x.reshape(x.shape[0], -1))


def _crelu_into(conv: Conv2d, y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``conv`` (pre-activation crelu) before its bias, on ``y``, the
    previous conv's output before its ``bias``."""
    return conv.pre_bias(crelu_pad(y, bias, conv.same_pads(*y.shape[1:3])), padded=True)


def _glu_into(conv: Conv2d, y: torch.Tensor, bias: torch.Tensor, hw=None) -> torch.Tensor:
    """``conv`` before its bias, on the GLU of ``y``, the previous layer's
    output before its ``bias`` (``hw``: a dense layer's, viewed as (H, W, C)
    after the gate), upsampled where ``conv`` upsamples."""
    return conv.pre_bias(glu_upsample(y, bias, 2 if conv.upsample else 1, hw))


class Discriminator(nn.Module):
    def __init__(self, nonlinearity: str = "crelu",
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        self.remat, self.save = remat, save_names(remat_policy)
        if "disc_c2_half" in self.save:
            # the JAX package's save of the first half of disc_c2
            # (otgan_tpu/models/dcgan.py:63-64); accepted, since that
            # package takes it, but a segment boundary keeps whole tensors
            kept = ("recomputed in the backward pass" if remat and "disc_c2" not in self.save
                    else "kept whole")
            warnings.warn("--remat_policy disc_c2_half: the port cannot save half a tensor, "
                          f"so disc_c2 will be {kept}; the numbers do not change, only the "
                          "memory", UserWarning, stacklevel=2)
        cd = compute_dtype
        self.conv2d_0 = Conv2d(3, 128, (5, 5), pre_activation=None, compute_dtype=cd)
        self.conv2d_1 = Conv2d(128, 256, (5, 5), (2, 2), pre_activation=nonlinearity,
                               compute_dtype=cd)
        self.conv2d_2 = Conv2d(256, 512, (5, 5), (2, 2), pre_activation=nonlinearity,
                               compute_dtype=cd)
        self.conv2d_3 = Conv2d(512, 1024, (5, 5), (2, 2), pre_activation=nonlinearity,
                               compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images (B, 32, 32, 3) -> unit features (B, 32768)."""
        c0, c1, c2, c3 = convs = (self.conv2d_0, self.conv2d_1, self.conv2d_2, self.conv2d_3)
        # disc_c2_half marks no boundary (the warning in __init__)
        if engages(x, convs) and all(c.pre_activation == "crelu" for c in convs[1:]):
            return run_stages([
                (lambda x: _crelu_into(c1, c0.pre_bias(x), c0.b), ("disc_c2",)),
                (lambda y: _crelu_into(c2, y, c1.b), ("disc_c3",)),
                (lambda y: _crelu_into(c3, y, c2.b), ("disc_c4",)),
                (lambda y: _head(y.float() + c3.b), ()),
            ], x, self.remat, self.save)
        return run_stages([
            (lambda x: self.conv2d_1(self.conv2d_0(x)), ("disc_c2",)),
            (self.conv2d_2, ("disc_c3",)),
            (self.conv2d_3, ("disc_c4",)),
            (_head, ()),
        ], x, self.remat, self.save)


class Generator(nn.Module):
    def __init__(self, nonlinearity: str = "crelu",
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        del nonlinearity  # the DCGAN generator has no pre-activations
        self.remat, self.save = remat, save_names(remat_policy)
        cd = compute_dtype
        self.dense_0 = Dense(LATENT_DIM, 2 * 4 * 4 * 1024, pre_activation=None,
                             compute_dtype=cd)
        self.conv2d_0 = Conv2d(1024, 2 * 512, (5, 5), upsample=True,
                               pre_activation=None, compute_dtype=cd)
        self.conv2d_1 = Conv2d(512, 2 * 256, (5, 5), upsample=True,
                               pre_activation=None, compute_dtype=cd)
        self.conv2d_2 = Conv2d(256, 2 * 128, (5, 5), upsample=True,
                               pre_activation=None, compute_dtype=cd)
        self.conv2d_3 = Conv2d(128, 3, (5, 5), pre_activation=None, init_scale=0.1,
                               compute_dtype=cd)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """Latents (B, 100) -> NHWC images (B, 32, 32, 3) in [-1, 1]."""
        d0, c0, c1, c2, c3 = layers = (self.dense_0, self.conv2d_0, self.conv2d_1,
                                       self.conv2d_2, self.conv2d_3)
        if engages(u, layers):
            return run_stages([
                (d0.pre_bias, ()),
                (lambda y: _glu_into(c0, y, d0.b, (4, 4)), ("gen_g1",)),
                (lambda y: _glu_into(c1, y, c0.b), ("gen_g2",)),
                (lambda y: _glu_into(c2, y, c1.b), ("gen_g3",)),
                (lambda y: torch.tanh(_glu_into(c3, y, c2.b).float() + c3.b), ()),
            ], u, self.remat, self.save)
        return run_stages([
            (lambda u: glu(self.dense_0(u), dim=1).reshape(u.shape[0], 4, 4, 1024), ()),
            (lambda x: glu(self.conv2d_0(x)), ("gen_g1",)),
            (lambda x: glu(self.conv2d_1(x)), ("gen_g2",)),
            (lambda x: glu(self.conv2d_2(x)), ("gen_g3",)),
            (lambda x: torch.tanh(self.conv2d_3(x)), ()),
        ], u, self.remat, self.save)


def make_discriminator(nonlinearity: str = "crelu", compute_dtype=torch.float32,
                       remat: bool = False, remat_policy: str = ""):
    return Discriminator(nonlinearity, compute_dtype, remat, remat_policy)


def make_generator(nonlinearity: str = "crelu", compute_dtype=torch.float32,
                   remat: bool = False, remat_policy: str = ""):
    return Generator(nonlinearity, compute_dtype, remat, remat_policy)
