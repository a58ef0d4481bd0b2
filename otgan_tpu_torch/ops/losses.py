"""MED surrogate losses with the reference's gradient semantics
(counterpart of ``otgan_tpu/ops/losses.py``).

The reference injects cotangents into ``tf.gradients`` (``train.py:108-130``)
instead of differentiating a scalar. ``L = sum(f * delta.detach())`` has
exactly that gradient, including the quirk that the cross term enters with
weight 1. Gradients are sums over the batch; the critic ascends through a
negative learning rate in the optimizer.
"""

from __future__ import annotations

import torch

from otgan_tpu_torch.ops.matching import MatchedFeatures


def med_generator_loss(features_gen: torch.Tensor, matched: MatchedFeatures) -> torch.Tensor:
    """Gradient wrt the generator = ``f_aa - f_ab`` (``train.py:111-112``)."""
    return torch.sum(features_gen * (matched.a_a - matched.a_b).detach())


def med_discriminator_loss(
    features_fake: torch.Tensor,
    features_data: torch.Tensor,
    matched: MatchedFeatures,
) -> torch.Tensor:
    """Gradient wrt the critic = the reference's two injected cotangents
    (``train.py:119-128``)."""
    return torch.sum(
        features_data * (matched.b_b - matched.b_a).detach()
    ) + torch.sum(features_fake * (matched.a_a - matched.a_b).detach())
