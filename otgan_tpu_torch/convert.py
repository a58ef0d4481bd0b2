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

A JAX checkpoint file holds the ``TrainState`` pytree's leaves as a list
(``otgan_tpu/utils/checkpoint.py:103-117``). :func:`jax_leaf_names` gives
that list's order for a port state: the fields ``gen_params, disc_params,
gen_ema, gen_opt, disc_opt, step, rng``; in each parameter tree the layers
sorted and in each layer the leaves sorted (JAX sorts dict keys at every
level); an optimizer state's fields in their declared order, Adam ``(t, v,
mg)``, Adamax ``(v, mg)``, Nesterov ``(v)``. :func:`state_from_jax_leaves`
reads such a list into a port state, :func:`jax_leaves` writes one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from otgan_tpu_torch.engine import Engine, TrainState
from otgan_tpu_torch.nn.optim import AdamaxState, AdamState, NesterovState, step_count


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
            t=step_count(float(np.asarray(_field(opt, "t"))), like),
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
        out["t"] = np.asarray(float(opt.t), np.float32)
    for name in ("v", "mg"):
        if hasattr(opt, name):
            out[name] = unflatten_params(getattr(opt, name))
    return out


def state_from_jax(engine: Engine, state: TrainState, jax_state) -> TrainState:
    """Overwrite ``state`` (made by ``engine.init_state``) with a JAX
    ``TrainState``: params, EMA, optimizer moments and step. The JAX PRNG
    key has no torch counterpart; latents are drawn from ``state.rng``."""
    return _load_state(state, jax_state, engine.cfg.optimizer)


def _load_state(state: TrainState, jax_state, opt: str) -> TrainState:
    load_params(state.gen, _field(jax_state, "gen_params"))
    load_params(state.disc, _field(jax_state, "disc_params"))
    gen_params = dict(state.gen.named_parameters())
    disc_params = dict(state.disc.named_parameters())
    state.gen_ema = _tensors(_field(jax_state, "gen_ema"), gen_params)
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


_OPTIMIZERS = {AdamState: "adam", AdamaxState: "adamax", NesterovState: "nesterov"}


def _sorted(named: Dict[str, torch.Tensor]) -> List[Tuple[str, torch.Tensor]]:
    """A parameter dict in the JAX tree's leaf order: by layer, then leaf."""
    return sorted(named.items(), key=lambda kv: kv[0].rsplit(".", 1))


def _leaf_layout(state: TrainState) -> List[Tuple[Tuple[str, ...], Optional[torch.Tensor]]]:
    """``(path, tensor)`` of each JAX leaf in pytree order; ``tensor`` is
    the port's counterpart, None for the scalars and the key."""
    out = []
    for field, named in (("gen_params", dict(state.gen.named_parameters())),
                         ("disc_params", dict(state.disc.named_parameters())),
                         ("gen_ema", state.gen_ema)):
        out += [((field, name), t) for name, t in _sorted(named)]
    for field in ("gen_opt", "disc_opt"):
        opt = getattr(state, field)
        for f in dataclasses.fields(opt):
            val = getattr(opt, f.name)
            if isinstance(val, dict):
                out += [((field, f.name, name), t) for name, t in _sorted(val)]
            else:
                out.append(((field, f.name), None))  # Adam's shared step count t
    return out + [(("step",), None), (("rng",), None)]


def _jax_shape(t: torch.Tensor) -> Tuple[int, ...]:
    shape = tuple(t.shape)
    if t.dim() == 4:  # OIHW -> HWIO
        return shape[2], shape[3], shape[1], shape[0]
    return shape[::-1] if t.dim() == 2 else shape


def jax_leaf_names(state: TrainState) -> List[str]:
    """``"<field>/[<opt field>/]<layer>.<leaf>"`` of each leaf of the JAX
    ``TrainState`` of this configuration, in the JAX package's pytree order."""
    return ["/".join(path) for path, _ in _leaf_layout(state)]


def jax_leaves(state: TrainState, rng_key: Sequence[int] = (0, 0)) -> List[np.ndarray]:
    """The state as the JAX ``TrainState``'s leaves, in pytree order, JAX
    layouts and dtypes (float32 tensors and Adam's t, int32 step); the JAX
    PRNG key, which the port does not keep, is ``rng_key`` (uint32)."""
    out = []
    for path, t in _leaf_layout(state):
        if t is not None:
            out.append(_to_jax(t).astype(np.float32))
        elif path[0] == "step":
            out.append(np.asarray(state.step, np.int32))
        elif path[0] == "rng":
            out.append(np.asarray(rng_key, np.uint32))
        else:
            out.append(np.asarray(float(getattr(getattr(state, path[0]), path[1])), np.float32))
    return out


def seed_from_jax_key(key) -> int:
    """A torch seed from a JAX PRNG key's uint32 words, read as one
    big-endian integer modulo 2^64."""
    seed = 0
    for word in np.asarray(key, np.uint32).ravel():
        seed = ((seed << 32) | int(word)) % (1 << 64)
    return seed


def state_from_jax_leaves(state: TrainState, leaves: Sequence[np.ndarray],
                          rng: bool = True) -> TrainState:
    """Overwrite ``state`` with the JAX ``TrainState`` leaves ``leaves`` (a
    JAX checkpoint file's, in pytree order, float32 where the JAX state is).
    Counts and shapes are checked against :func:`jax_leaf_names`. The JAX
    key has no torch stream: with ``rng`` the run generator is seeded from
    its words (:func:`seed_from_jax_key`), so a resume is deterministic but
    draws other latents than the JAX run would."""
    layout = _leaf_layout(state)
    if len(leaves) != len(layout):
        raise ValueError(f"{len(leaves)} leaves, but a state of this configuration has "
                         f"{len(layout)}: a checkpoint of another model or optimizer?")
    tree: Dict[str, Any] = {}
    for (path, t), arr in zip(layout, leaves):
        if t is not None and tuple(arr.shape) != _jax_shape(t):
            raise ValueError(f"{'/'.join(path)}: checkpoint shape {tuple(arr.shape)} vs "
                             f"{_jax_shape(t)}")
        *parents, last = path
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        if t is not None:
            layer, leaf = last.rsplit(".", 1)
            node.setdefault(layer, {})[leaf] = arr
        else:
            node[last] = arr
    _load_state(state, tree, _OPTIMIZERS[type(state.gen_opt)])
    if rng:
        state.rng.manual_seed(seed_from_jax_key(tree["rng"]))
    return state
