"""DenseNet-style generator and critic (counterpart of
``otgan_tpu/models/densenet.py``, after the reference's ``models/densenet.py``).

Critic: a 3x3 conv to ``2F`` channels, then 3 dense blocks of ``L`` convs of
``F`` filters, each taking the list of all previous outputs, separated by
stride-2 downsample convs to half the list's channels (save points
``disc_d1..3``); CReLU, NHWC flatten, row L2 normalisation. At ``L = F = 16``
the features are 4 * 4 * 2 * 228 = 7296 values.

Generator: four ``U(-1, 1)`` noises, (B, 100), (B, 8, 8, F), (B, 16, 16, F)
and (B, 32, 32, F). A dense layer maps the first to 8x8xF; the others join
the feature list at each scale. Dense blocks, NN-upsample convs to half the
channels (save points ``gen_u1``, ``gen_u2``), a last conv to 3 channels
with ``init_scale`` 0.1, tanh. The noise is an input, a tuple of four
tensors, so a test can feed the JAX package's draws (``split(key, 4)``);
:func:`sample_latent` draws them from a ``torch.Generator``.

Layers are registered flat as ``conv2d_<k>`` / ``dense_0`` in the JAX
package's scope order, so parameter names map one to one (``convert.py``,
checkpoints). Eager PyTorch builds each dense layer's concatenated input
anew (XLA fuses it into the conv), so the bytes autograd keeps grow with
``L^2``; ``--grad_accum`` and ``--remat`` bound them.

At bf16 on the card (``dense_boundary.engages``) each dense block runs on
one slab (``nn/dense_boundary.py``): every element is rounded into it once,
each list conv's input is gathered from it, forward and backward, and a
conv stops before its bias (``pre_bias``), which the slab write or the head
adds. The carries between stages, and so the save points, are then the
transition convs' outputs before their bias; values and gradients are the
plain layers'.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from otgan_tpu_torch.nn import dense_boundary
from otgan_tpu_torch.nn.layers import (
    Conv2d,
    Dense,
    l2_normalize_rows,
    run_stages,
    save_names,
    weight_norm_layers,
)

LATENT_DIM = 100


def sample_latent(batch_size: int, generator: Optional[torch.Generator] = None,
                  device="cpu", filters_per_layer: int = 16,
                  **model_opts) -> Tuple[torch.Tensor, ...]:
    """The generator's four ``U(-1, 1)`` noises, in the JAX package's order
    (``otgan_tpu/models/densenet.py:99-104``); of the family's constructor
    options only ``filters_per_layer`` shapes them."""
    f = filters_per_layer
    shapes = ((batch_size, LATENT_DIM), (batch_size, 8, 8, f), (batch_size, 16, 16, f),
              (batch_size, 32, 32, f))
    return tuple(torch.rand(s, generator=generator, device=device) * 2.0 - 1.0 for s in shapes)


class _Flat(nn.Module):
    """Registers conv layers as ``conv2d_0``, ``conv2d_1``... in creation
    order (the JAX scope counter); the forward reaches them through plain
    lists, which register nothing a second time."""

    def __init__(self, nonlinearity: str, compute_dtype: torch.dtype, remat: bool,
                 remat_policy: str):
        super().__init__()
        self.nonlinearity, self.compute_dtype = nonlinearity, compute_dtype
        self.remat, self.save = remat, save_names(remat_policy)
        self._n_convs = 0

    def _conv(self, in_channels: int, num_filters: int, **kw) -> Conv2d:
        kw.setdefault("pre_activation", self.nonlinearity)
        conv = Conv2d(in_channels, num_filters, compute_dtype=self.compute_dtype, **kw)
        self.add_module(f"conv2d_{self._n_convs}", conv)
        self._n_convs += 1
        return conv

    def _block(self, channels: int, layers: int, filters: int) -> Tuple[List[Conv2d], int]:
        convs = []
        for _ in range(layers):
            convs.append(self._conv(channels, filters))
            channels += filters
        return convs, channels

    def _on_slabs(self, inputs, list_convs) -> bool:
        """Whether this forward's dense blocks run on slabs."""
        return dense_boundary.engages(inputs, list(weight_norm_layers(self)), list_convs)


def _head(x: torch.Tensor) -> torch.Tensor:
    """CReLU concat, NHWC flatten, row L2 normalisation."""
    x = torch.relu(torch.cat([x, -x], dim=-1))
    return l2_normalize_rows(x.reshape(x.shape[0], -1))


def _dense_block(convs, xs) -> List[torch.Tensor]:
    """Each conv takes the list of all previous outputs and adds its own."""
    xs = list(xs)
    for conv in convs:
        xs.append(conv(xs))
    return xs


class Discriminator(_Flat):
    def __init__(self, layers_per_block: int = 16, filters_per_layer: int = 16,
                 nonlinearity: str = "crelu", compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__(nonlinearity, compute_dtype, remat, remat_policy)
        L, F = layers_per_block, filters_per_layer
        self._conv(3, 2 * F, pre_activation=None)  # conv2d_0
        channels = 2 * F
        self.blocks, self.downs = [], []
        for _ in range(3):
            convs, channels = self._block(channels, L, F)
            self.blocks.append(convs)
            self.downs.append(self._conv(channels, channels // 2, stride=(2, 2)))
            channels //= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images (B, 32, 32, 3) -> unit features (B, 16 * 2 * C)."""
        if self._on_slabs([x], [c for b in self.blocks for c in b] + self.downs):
            return self._forward_slabs(x)

        def stage(k):
            def fn(x):
                if k == 0:
                    x = self.conv2d_0(x)
                return self.downs[k](_dense_block(self.blocks[k], [x]))
            return fn

        return run_stages([(stage(k), (f"disc_d{k + 1}",)) for k in range(3)] + [(_head, ())],
                          x, self.remat, self.save)

    def _forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` with each block on a slab; a stage carries the
        down conv's output before its bias."""

        def stage(k):
            def fn(y):
                first = self.conv2d_0 if k == 0 else self.downs[k - 1]
                if k == 0:
                    y = first.pre_bias(y)
                return dense_boundary.dense_block(self.blocks[k], [(y, first.b)], self.downs[k],
                                                  y.shape[1:3])
            return fn

        return run_stages([(stage(k), (f"disc_d{k + 1}",)) for k in range(3)]
                          + [(lambda y: _head(y.float() + self.downs[2].b), ())],
                          x, self.remat, self.save)


class Generator(_Flat):
    def __init__(self, layers_per_block: int = 16, filters_per_layer: int = 16,
                 nonlinearity: str = "crelu", compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__(nonlinearity, compute_dtype, remat, remat_policy)
        L, F = layers_per_block, filters_per_layer
        self.filters = F
        self.dense_0 = Dense(LATENT_DIM, 8 * 8 * F, pre_activation=None,
                             compute_dtype=compute_dtype)
        channels = 2 * F
        self.blocks, self.ups = [], []
        for k in range(3):
            convs, channels = self._block(channels, L, F)
            self.blocks.append(convs)
            if k < 2:  # models/densenet.py:67-73: concat -> 2x resize -> conv(ch // 2)
                self.ups.append(self._conv(channels, channels // 2, upsample=True))
                channels = channels // 2 + F
        self.blocks[2].append(self._conv(channels, 3, init_scale=0.1))

    def forward(self, noise) -> torch.Tensor:
        """The four noises of :func:`sample_latent` -> NHWC images (B, 32,
        32, 3) in [-1, 1]."""
        if self._on_slabs(noise, [c for b in self.blocks for c in b] + self.ups):
            return self._forward_slabs(noise)
        u0, u1, u2, u3 = noise
        F = self.filters

        def first(u):
            x = self.dense_0(u).reshape(u.shape[0], 8, 8, F)
            return self.ups[0](_dense_block(self.blocks[0], [x, u1]))

        def second(x):
            return self.ups[1](_dense_block(self.blocks[1], [x, u2]))

        def third(x):
            *block, last = self.blocks[2]
            return torch.tanh(last(_dense_block(block, [x, u3])))

        return run_stages([(first, ("gen_u1",)), (second, ("gen_u2",)), (third, ())],
                          u0, self.remat, self.save)

    def _forward_slabs(self, noise) -> torch.Tensor:
        """:meth:`forward` with each block on a slab; a stage carries the up
        conv's output before its bias."""
        u0, u1, u2, u3 = noise
        block = dense_boundary.dense_block

        def first(u):
            y = self.dense_0.pre_bias(u)
            return block(self.blocks[0], [(y, self.dense_0.b), (u1, None)], self.ups[0],
                         u1.shape[1:3])

        def second(y):
            return block(self.blocks[1], [(y, self.ups[0].b), (u2, None)], self.ups[1],
                         u2.shape[1:3])

        def third(y):
            *convs, last = self.blocks[2]
            y = block(convs, [(y, self.ups[1].b), (u3, None)], last, u3.shape[1:3])
            return torch.tanh(y.float() + last.b)

        return run_stages([(first, ("gen_u1",)), (second, ("gen_u2",)), (third, ())],
                          u0, self.remat, self.save)


def make_discriminator(layers_per_block: int = 16, filters_per_layer: int = 16,
                       nonlinearity: str = "crelu", compute_dtype=torch.float32,
                       remat: bool = False, remat_policy: str = ""):
    return Discriminator(layers_per_block, filters_per_layer, nonlinearity, compute_dtype,
                         remat, remat_policy)


def make_generator(layers_per_block: int = 16, filters_per_layer: int = 16,
                   nonlinearity: str = "crelu", compute_dtype=torch.float32,
                   remat: bool = False, remat_policy: str = ""):
    return Generator(layers_per_block, filters_per_layer, nonlinearity, compute_dtype,
                     remat, remat_policy)
