"""Exponential moving average of the generator's parameters (counterpart of
``otgan_tpu/nn/ema.py``; ``tf.train.ExponentialMovingAverage(0.999)`` at
``train.py:63-64``). The shadow starts as a copy and is updated
``decay * e + (1 - decay) * p`` after each generator step only."""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


@torch.no_grad()
def ema_init(params: Params) -> Params:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float = 0.999) -> Params:
    """In place; returns ``ema``."""
    for k, e in ema.items():
        e.copy_(decay * e + (1.0 - decay) * params[k])
    return ema
