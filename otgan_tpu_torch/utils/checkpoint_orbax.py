"""Sharded checkpoints with ``torch.distributed.checkpoint`` (counterpart of
``otgan_tpu/utils/checkpoint_orbax.py``, ``--checkpoint_backend orbax``).

The npz backend (``utils/checkpoint.py``) writes one file from one
process. Here every rank takes part in the write: DCP plans it over the
ranks, writes each replicated tensor once (its planner deduplicates them
and spreads the writes over the ranks, one ``__<rank>_0.distcp`` file
each), and the coordinator (rank 0) writes ``.metadata`` last, after every
rank's files. Layout: ``<save_dir>/orbax/<step>/``, the JAX package's, so
``latest_checkpoint``, ``sample.py`` and ``evaluate.py`` find it there.

* A step directory counts only once committed, i.e. once its ``.metadata``
  exists; a crash mid-save leaves a directory without it, which is never
  "the latest". A save over an existing step directory removes it first.
* The state dict is the npz backend's flat, named one
  (``_named_tensors``, ``_opt_scalars``): parameters, EMA shadow, both
  optimizer states, the step and the run generator's state, all tensors
  (no pickled objects).
* ``slot_dtype="bfloat16"`` writes the EMA shadow and the optimizer moments
  as bfloat16; a restore loads them into the float32 state (DCP's load
  casts on copy). Parameters and the step stay exact.
* ``async_write`` writes on a background thread: host copies are taken on
  the caller's thread first (the optimizers update in place), and
  :func:`wait_for_pending_saves` joins the writer and re-raises its error.
  With several ranks the plan exchange of every save and restore runs over
  a gloo group of its own, never over the training collectives' group.
* Retention (``max_to_keep``, ``keep_every_hours``) is applied by rank 0
  after the commit, as the npz backend's; it also removes uncommitted step
  directories below the newest committed step.
* A checkpoint written by K ranks restores onto any number of ranks (the
  state is replicated; each rank reads all of it).

Hosts without a shared filesystem each write their own ranks' files and
only rank 0's host has ``.metadata``: to resume, gather the step directory
onto a filesystem every host reads.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader

from otgan_tpu_torch.utils.checkpoint import (
    _SLOT_FIELDS,
    _Writer,
    _named_tensors,
    _opt_scalars,
    retained_steps,
    set_opt_scalar,
)

SUBDIR = "orbax"
METADATA = ".metadata"
# files that only an orbax step directory holds
_ORBAX_FILES = (("_CHECKPOINT_METADATA",), ("_METADATA",), ("default", "_METADATA"),
                ("commit_success.txt",))

_writer = _Writer()
_groups: dict = {}  # the default group -> the gloo group of its checkpoints


def step_dir(save_dir: str, step: int) -> str:
    return os.path.join(save_dir, SUBDIR, str(step))


def is_committed(path: str) -> bool:
    """Whether the step directory ``path`` holds a finished DCP write."""
    return os.path.isfile(os.path.join(path, METADATA))


def is_jax_orbax(path: str) -> bool:
    """Whether the step directory ``path`` is a committed checkpoint of the
    JAX package's orbax backend (its metadata files; orbax renames a step
    directory to its bare number only when the write is finished)."""
    return any(os.path.exists(os.path.join(path, *name)) for name in _ORBAX_FILES)


def wait_for_pending_saves() -> None:
    """Join the in-flight background write, if any, re-raising its error."""
    _writer.wait()


def _group_kwargs() -> dict:
    """DCP's process-group arguments: ``no_dist`` without a group, else a
    gloo group over every rank, made once (collectively, at the first save
    or restore, which every rank makes)."""
    if not dist.is_initialized():
        return {"no_dist": True}
    world = dist.group.WORLD
    if world not in _groups:
        _groups[world] = dist.new_group(backend="gloo")
    return {"process_group": _groups[world]}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _host_state_dict(state, slot_dtype: str) -> Dict[str, torch.Tensor]:
    """Host copies of the whole state, owned by the caller."""
    if slot_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"slot_dtype must be float32 or bfloat16, got {slot_dtype!r}")
    sd = {}
    for key, t in _named_tensors(state):
        t = t.detach()
        if (slot_dtype == "bfloat16" and key.split("/")[0] in _SLOT_FIELDS
                and t.dtype == torch.float32):
            t = t.to(torch.bfloat16)
        sd[key] = t.to("cpu", copy=True)
    for key, opt, name in _opt_scalars(state):
        sd[key] = torch.tensor(float(getattr(opt, name)), dtype=torch.float64)
    sd["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    sd["rng"] = state.rng.get_state().clone()
    sd["rng_device"] = torch.tensor(list(state.rng.device.type.encode()), dtype=torch.uint8)
    return sd


def save_checkpoint(save_dir: str, state, step: int, max_to_keep: int = 0,
                    keep_every_hours: float = 0.0, async_write: bool = True,
                    slot_dtype: str = "float32") -> str:
    """Write ``state`` to ``<save_dir>/orbax/<step>`` on every rank (each
    rank calls this); returns the step directory. Retention runs on rank 0
    after the commit, in the writer thread when ``async_write``."""
    wait_for_pending_saves()
    path = step_dir(save_dir, step)
    kw = _group_kwargs()
    if _rank() == 0 and os.path.exists(path):
        shutil.rmtree(path)  # an older or unfinished write of this step
    if "process_group" in kw:
        dist.barrier(group=kw["process_group"])  # no rank writes into it before
    sd = _host_state_dict(state, slot_dtype)

    def write() -> None:
        dcp.save(sd, checkpoint_id=path, **kw)
        if _rank() == 0 and max_to_keep:
            prune_checkpoints(save_dir, max_to_keep, keep_every_hours)

    if async_write:
        _writer.submit(write)
    else:
        write()
    return path


def committed_steps(save_dir: str) -> Dict[int, str]:
    """``{step: directory}`` of the committed DCP steps under ``save_dir``."""
    root = os.path.join(save_dir, SUBDIR)
    names = os.listdir(root) if os.path.isdir(root) else []
    return {int(n): os.path.join(root, n) for n in names
            if re.fullmatch(r"\d+", n) and is_committed(os.path.join(root, n))}


def prune_checkpoints(save_dir: str, max_to_keep: int = 5,
                      keep_every_hours: float = 5.0) -> list:
    """The npz backend's retention (``checkpoint.retained_steps``) over
    committed step directories, by the commit's mtime; also removes
    uncommitted step directories below the newest committed step. The JAX
    package's orbax steps are left alone. Returns the removed directories."""
    steps = committed_steps(save_dir)
    removed = []
    if not steps:
        return removed
    root = os.path.join(save_dir, SUBDIR)
    newest = max(steps)
    for n in os.listdir(root):
        p = os.path.join(root, n)
        if (re.fullmatch(r"\d+", n) and int(n) < newest and int(n) not in steps
                and not is_jax_orbax(p)):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    keep = retained_steps({s: os.path.getmtime(os.path.join(p, METADATA))
                           for s, p in steps.items()}, max_to_keep, keep_every_hours)
    for s in sorted(set(steps) - keep):
        shutil.rmtree(steps[s], ignore_errors=True)
        removed.append(steps[s])
    return removed


@torch.no_grad()
def restore_checkpoint(path: str, state, rng: bool = True):
    """Restore the committed step directory ``path`` into ``state`` (made by
    ``Engine.init_state`` for the same configuration) in place, on every
    rank of the run (each calls this), and return it. Names and shapes are
    checked against the checkpoint's metadata first; bfloat16 slots load
    into the float32 state. ``rng=False`` leaves the run generator as it
    is."""
    wait_for_pending_saves()  # never read around this process's own write
    if not is_committed(path):
        raise FileNotFoundError(f"{path} holds no committed DCP checkpoint ({METADATA} missing)")
    saved = FileSystemReader(path).read_metadata().state_dict_metadata
    template, scalars = {}, {}
    for key, t in _named_tensors(state):
        if key not in saved:
            raise ValueError(f"{path} has no {key}: a checkpoint of another model?")
        size = tuple(saved[key].size)
        if size != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {size} vs state {tuple(t.shape)}")
        template[key] = t.detach()
    for key, opt, name in _opt_scalars(state):
        if key not in saved:
            raise ValueError(f"{path} has no {key}: a checkpoint of another optimizer?")
        template[key] = scalars[key] = torch.zeros((), dtype=torch.float64)
    template["step"] = torch.zeros((), dtype=torch.int64)
    if rng:
        for key in ("rng", "rng_device"):
            template[key] = torch.zeros(tuple(saved[key].size), dtype=torch.uint8)
    extra = sorted(set(saved) - set(template) - {"rng", "rng_device"})
    if extra:
        raise ValueError(f"{path} has tensors the state lacks: {extra[:5]}")
    dcp.load(template, checkpoint_id=path, **_group_kwargs())
    for key, opt, name in _opt_scalars(state):
        set_opt_scalar(opt, name, float(scalars[key]))
    state.step = int(template["step"])
    if rng:
        rng_device = bytes(template["rng_device"].tolist()).decode()
        if rng_device != state.rng.device.type:
            raise ValueError(f"{path} holds a {rng_device} generator's state; this run's "
                             f"generator is on {state.rng.device.type}")
        state.rng.set_state(template["rng"])
    return state
