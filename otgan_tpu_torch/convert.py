"""Carries weights and training state between the JAX package and the port.

The JAX side is the ``TrainState`` pytree after ``jax.device_get``: nested
dicts of numpy arrays (``{"conv2d_0": {"V", "g", "b"}, "dense_0": ...}``)
and optimizer states with fields ``t``/``v``/``mg`` (named tuples or dicts).
The port names a parameter ``"<layer>.<V|g|b>"`` and stores V in PyTorch's
layout, so the conversion transposes:

* conv V: HWIO <-> OIHW;
* dense V: ``(in, out)`` <-> ``(out, in)``;
* g and b: unchanged; the toy's plain dense layers have no g.

Weight norm is over every axis but the output one on both sides, so the
effective weights agree. Optimizer moments share their parameter's layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from otgan_tpu_torch.engine import Engine, TrainState
from otgan_tpu_torch.nn.optim import AdamaxState, AdamState, NesterovState


def _to_port(a) -> torch.Tensor:
    # a writable float32 copy for torch, then a (multi-threaded) relayout
    t = torch.from_numpy(np.array(a, np.float32))
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 2:
        return t.T.contiguous()
    return t


def _to_jax(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    elif t.dim() == 2:
        t = t.T
    return t.contiguous().numpy()


def flatten_params(tree: Dict[str, Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """JAX nested params -> ``{"layer.leaf": tensor}`` in the port's layout."""
    return {
        f"{layer}.{leaf}": _to_port(value)
        for layer, leaves in tree.items()
        for leaf, value in leaves.items()
    }


def unflatten_params(named: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """``{"layer.leaf": tensor}`` -> JAX nested params of numpy arrays."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, value in named.items():
        layer, leaf = name.rsplit(".", 1)
        tree.setdefault(layer, {})[leaf] = _to_jax(torch.as_tensor(value))
    return tree


def _tensors(tree, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    flat = flatten_params(tree)
    if set(flat) != set(like):
        raise KeyError(
            f"parameter names differ: only JAX {sorted(set(flat) - set(like))}, "
            f"only port {sorted(set(like) - set(flat))}"
        )
    out = {}
    for k, ref in like.items():
        if tuple(flat[k].shape) != tuple(ref.shape):
            raise ValueError(f"{k}: JAX shape {flat[k].shape} vs port {tuple(ref.shape)}")
        out[k] = flat[k].to(ref.device, ref.dtype)
    return out


@torch.no_grad()
def load_params(module: torch.nn.Module, tree) -> None:
    """Copy JAX params into ``module``'s parameters."""
    params = dict(module.named_parameters())
    for k, t in _tensors(tree, params).items():
        params[k].copy_(t)


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def opt_state_from_jax(opt, like: Dict[str, torch.Tensor], optimizer: str):
    if optimizer == "adam":
        return AdamState(
            t=float(np.asarray(_field(opt, "t"))),
            v=_tensors(_field(opt, "v"), like),
            mg=_tensors(_field(opt, "mg"), like),
        )
    if optimizer == "adamax":
        return AdamaxState(v=_tensors(_field(opt, "v"), like),
                           mg=_tensors(_field(opt, "mg"), like))
    if optimizer == "nesterov":
        return NesterovState(v=_tensors(_field(opt, "v"), like))
    raise ValueError(f"unsupported optimizer {optimizer!r}")


def opt_state_to_jax(opt) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(opt, AdamState):
        out["t"] = np.asarray(opt.t, np.float32)
    for name in ("v", "mg"):
        if hasattr(opt, name):
            out[name] = unflatten_params(getattr(opt, name))
    return out


def state_from_jax(engine: Engine, state: TrainState, jax_state) -> TrainState:
    """Overwrite ``state`` (made by ``engine.init_state``) with a JAX
    ``TrainState``: params, EMA, optimizer moments and step. The JAX PRNG
    key has no torch counterpart; latents are drawn from ``state.rng``."""
    load_params(state.gen, _field(jax_state, "gen_params"))
    load_params(state.disc, _field(jax_state, "disc_params"))
    gen_params = dict(state.gen.named_parameters())
    disc_params = dict(state.disc.named_parameters())
    state.gen_ema = _tensors(_field(jax_state, "gen_ema"), gen_params)
    opt = engine.cfg.optimizer
    state.gen_opt = opt_state_from_jax(_field(jax_state, "gen_opt"), gen_params, opt)
    state.disc_opt = opt_state_from_jax(_field(jax_state, "disc_opt"), disc_params, opt)
    state.step = int(np.asarray(_field(jax_state, "step")))
    return state


def state_to_jax(state: TrainState) -> Dict[str, Any]:
    """The port's state as the JAX ``TrainState``'s fields (numpy leaves,
    JAX layouts); ``rng`` is left out."""
    return {
        "gen_params": unflatten_params(dict(state.gen.named_parameters())),
        "disc_params": unflatten_params(dict(state.disc.named_parameters())),
        "gen_ema": unflatten_params(state.gen_ema),
        "gen_opt": opt_state_to_jax(state.gen_opt),
        "disc_opt": opt_state_to_jax(state.disc_opt),
        "step": np.asarray(state.step, np.int32),
    }
