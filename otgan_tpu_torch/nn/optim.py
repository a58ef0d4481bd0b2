"""The reference's hand-rolled optimizers (counterpart of
``otgan_tpu/nn/optim.py``, after ``utils/nn.py:29-87``).

Kept exactly, unlike textbook Adam:

* epsilon sits INSIDE the sqrt: ``p -= lr * v_hat / sqrt(mg_hat + 1e-8)``;
* one shared step counter ``t`` starting at 1;
* Adamax has no bias correction and ``+1e-8`` inside the max;
* the learning rate may be negative: the critic ascends through ``-lr``.

Parameters and state are dicts of tensors keyed by parameter name. An update
writes the new parameters and moments in place (under ``no_grad``) and
returns the state, so no second copy of the model is ever held. Adam's step
count ``t`` is a float32 tensor on the parameters' device, updated in place
and read there: an update makes no host sync, so a CUDA graph of a cycle
replays the right bias corrections, and they are float32 as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


@dataclass
class AdamState:
    t: torch.Tensor  # shared step, float32 on the device, starts at 1 (utils/nn.py:56)
    v: Params  # first moment
    mg: Params  # second moment


def step_count(value: float, params: Params) -> torch.Tensor:
    """Adam's ``t`` as a float32 scalar on the device of ``params``."""
    device = next(iter(params.values())).device if params else None
    return torch.tensor(value, dtype=torch.float32, device=device)


def adam_init(params: Params) -> AdamState:
    return AdamState(t=step_count(1.0, params), v=_zeros(params), mg=_zeros(params))


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: AdamState, lr: float,
                mom1: float = 0.9, mom2: float = 0.999) -> AdamState:
    """Reference ``adam_updates`` (``utils/nn.py:50-73``)."""
    # bias corrections in float32 on the device, as the JAX package
    # computes them (1 - mom ** t)
    one_m1 = 1.0 - torch.pow(mom1, state.t)
    one_m2 = 1.0 - torch.pow(mom2, state.t)
    for k, p in params.items():
        g, v, mg = grads[k], state.v[k], state.mg[k]
        v.mul_(mom1).add_((1.0 - mom1) * g)
        v_hat = v / one_m1 if mom1 > 0 else g
        mg.mul_(mom2).add_((1.0 - mom2) * g.square())
        mg_hat = mg / one_m2
        p.sub_(lr * v_hat / torch.sqrt(mg_hat + 1e-8))
    state.t.add_(1.0)
    return state


@dataclass
class AdamaxState:
    v: Params
    mg: Params  # infinity-norm accumulator


def adamax_init(params: Params) -> AdamaxState:
    return AdamaxState(v=_zeros(params), mg=_zeros(params))


@torch.no_grad()
def adamax_update(params: Params, grads: Params, state: AdamaxState, lr: float,
                  mom1: float = 0.9, mom2: float = 0.999) -> AdamaxState:
    """Reference ``adamax_updates`` (``utils/nn.py:29-48``)."""
    for k, p in params.items():
        g, v, mg = grads[k], state.v[k], state.mg[k]
        if mom1 > 0:
            v.mul_(mom1).add_((1.0 - mom1) * g)
        else:
            v.copy_(g)
        torch.maximum(mom2 * mg + 1e-8, g.abs(), out=mg)
        p.sub_(lr * v / mg)
    return state


@dataclass
class NesterovState:
    v: Params


def nesterov_init(params: Params) -> NesterovState:
    return NesterovState(v=_zeros(params))


@torch.no_grad()
def nesterov_update(params: Params, grads: Params, state: NesterovState, lr: float,
                    mom1: float = 0.9) -> NesterovState:
    """Reference ``nesterov_updates`` (``utils/nn.py:75-87``):
    ``v' = mom1 v - lr g``; ``p' = p - mom1 v + (1 + mom1) v'``."""
    for k, p in params.items():
        g, v = grads[k], state.v[k]
        v_new = mom1 * v - lr * g
        p.copy_(p - mom1 * v + (1.0 + mom1) * v_new)
        v.copy_(v_new)
    return state


_OPTIMIZERS = {
    "adam": (adam_init, adam_update),
    "adamax": (adamax_init, adamax_update),
    "nesterov": (nesterov_init, nesterov_update),
}


def make_optimizer(name: str):
    """``(init_fn, update_fn)`` for the reference's ``--optimizer`` values."""
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"unsupported optimizer {name!r}; choose from {sorted(_OPTIMIZERS)}"
        )
    return _OPTIMIZERS[name]
