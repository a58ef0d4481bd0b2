"""Full-train-state checkpoints (counterpart of
``otgan_tpu/utils/checkpoint.py``, its npz backend).

The reference saves only trainable variables and loses the EMA shadow and
Adam slots on resume (SURVEY.md section 5.4). Here ``otgan_state-<epoch>.npz``
holds the ENTIRE train state: generator and critic parameters, the EMA
shadow, both optimizer states, the step and the run generator's state
(``torch.Generator.get_state()``), so resume is exact. Keys name the tensors
(``gen/dense_0.V``, ``gen_opt/mg/dense_0.V``, ``step``, ``rng``...), in the
port's layouts; the files are the port's own (``convert.py`` carries state
from the JAX package in memory). No pickled objects.

* Writes are atomic: the file is written as ``<name>.tmp.npz`` and renamed.
* ``slot_dtype="bfloat16"`` stores the EMA shadow and the optimizer moments
  as bfloat16 bit patterns in uint16 arrays, keys suffixed ``__bf16``
  (``:40-43``); parameters, Adam's step count and the step stay exact.
* ``async_write=True`` writes on a background thread. The host copies are
  taken on the caller's thread before it returns: the optimizers update
  parameters and moments in place, so the writer must own its copies before
  the next step runs (the JAX note on donation, ``:20-24``).
  :func:`wait_for_pending_saves` joins the writer and re-raises its error.
* Retention (:func:`prune_checkpoints`) keeps the highest steps plus one
  long-term file per ``keep_every_hours`` window by mtime, as
  ``tf.train.Saver(max_to_keep, keep_checkpoint_every_n_hours)``.

Orbax step directories (``<save_dir>/orbax/<step>``) are not read: the
port's sharded checkpoints come with ``torch.distributed.checkpoint`` in a
later slice.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_PREFIX = "otgan_state"
_BF16_SUFFIX = "__bf16"
# TrainState fields stored in reduced precision under slot_dtype="bfloat16"
_SLOT_FIELDS = ("gen_ema", "gen_opt", "disc_opt")


class _Writer:
    """At most one background write at a time; its error is kept for the
    next :meth:`wait`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("background checkpoint write failed") from err

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run() -> None:
            try:
                fn()
            except Exception as e:  # re-raised by the next wait()
                with self._lock:
                    self._error = e

        thread = threading.Thread(target=run, name="checkpoint-writer", daemon=False)
        with self._lock:
            self._thread = thread
        thread.start()


_writer = _Writer()


def wait_for_pending_saves() -> None:
    """Join the in-flight background write, if any; a failure inside it
    (disk full, unwritable directory) is re-raised here, so a return means
    every reported checkpoint is on disk."""
    _writer.wait()


def _named_tensors(state) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(key, tensor)`` of every tensor of the train state."""
    yield from ((f"gen/{k}", p) for k, p in state.gen.named_parameters())
    yield from ((f"disc/{k}", p) for k, p in state.disc.named_parameters())
    yield from ((f"gen_ema/{k}", t) for k, t in state.gen_ema.items())
    for field in ("gen_opt", "disc_opt"):
        opt = getattr(state, field)
        for f in dataclasses.fields(opt):
            val = getattr(opt, f.name)
            if isinstance(val, dict):
                yield from ((f"{field}/{f.name}/{k}", t) for k, t in val.items())


def _opt_scalars(state) -> Iterator[Tuple[str, object, str]]:
    """``(key, optimizer state, field)`` of each optimizer's scalars
    (Adam's shared step count ``t``)."""
    for field in ("gen_opt", "disc_opt"):
        opt = getattr(state, field)
        for f in dataclasses.fields(opt):
            if not isinstance(getattr(opt, f.name), dict):
                yield f"{field}/{f.name}", opt, f.name


def _host_arrays(state, slot_dtype: str) -> Dict[str, np.ndarray]:
    """Host copies of the whole state, owned by the caller (never views of
    tensors that a later step updates in place)."""
    if slot_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"slot_dtype must be float32 or bfloat16, got {slot_dtype!r}")
    arrays = {}
    for key, t in _named_tensors(state):
        t = t.detach()
        if (slot_dtype == "bfloat16" and key.split("/")[0] in _SLOT_FIELDS
                and t.dtype == torch.float32):
            bits = t.to(torch.bfloat16).view(torch.int16).to("cpu", copy=True)
            arrays[key + _BF16_SUFFIX] = bits.numpy().view(np.uint16)
        else:
            arrays[key] = t.to("cpu", copy=True).numpy()
    for key, opt, name in _opt_scalars(state):
        arrays[key] = np.asarray(getattr(opt, name), np.float64)
    arrays["step"] = np.asarray(state.step, np.int64)
    arrays["rng"] = state.rng.get_state().numpy().copy()
    arrays["rng_device"] = np.asarray(state.rng.device.type)
    return arrays


def save_checkpoint(
    save_dir: str,
    state,
    step: int,
    slot_dtype: str = "float32",
    async_write: bool = False,
    max_to_keep: int = 0,
    keep_every_hours: float = 5.0,
) -> str:
    """Write ``otgan_state-<step>.npz``; returns its (final) path.

    ``max_to_keep > 0`` applies the retention policy after the write, inside
    the writer thread when ``async_write`` is on, so pruning never stalls
    the training loop."""
    os.makedirs(save_dir, exist_ok=True)
    wait_for_pending_saves()
    arrays = _host_arrays(state, slot_dtype)
    path = os.path.join(save_dir, f"{_PREFIX}-{step}.npz")
    tmp = path + ".tmp.npz"

    def write() -> None:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        if max_to_keep:
            _prune_committed(save_dir, max_to_keep, keep_every_hours)

    if async_write:
        _writer.submit(write)
    else:
        write()
    return path


def _load_arrays(path: str) -> Dict[str, np.ndarray]:
    if os.path.isdir(path):
        raise ValueError(f"not a checkpoint path: {path} (the port reads "
                         f"{_PREFIX}-<step>.npz files; orbax step directories are not "
                         "ported)")
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


@torch.no_grad()
def restore_checkpoint(path: str, state, rng: bool = True):
    """Restore ``path`` into ``state`` (made by ``Engine.init_state`` for the
    same run configuration) in place and return it. Names and shapes are
    checked; bfloat16 slots are decoded. ``rng=False`` leaves the run
    generator as it is (a sampler that draws from its own seeds, perhaps on
    another device than the run)."""
    wait_for_pending_saves()  # never read around an in-flight write
    arrays = _load_arrays(path)
    for key, t in _named_tensors(state):
        if key in arrays:
            src = torch.from_numpy(arrays.pop(key))
        elif key + _BF16_SUFFIX in arrays:
            src = torch.from_numpy(arrays.pop(key + _BF16_SUFFIX).view(np.int16))
            src = src.view(torch.bfloat16)
        else:
            raise ValueError(f"{path} has no {key}: a checkpoint of another model?")
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} vs state "
                             f"{tuple(t.shape)}")
        t.copy_(src)
    for key, opt, name in _opt_scalars(state):
        if key not in arrays:
            raise ValueError(f"{path} has no {key}: a checkpoint of another optimizer?")
        setattr(opt, name, float(arrays.pop(key)))
    state.step = int(arrays.pop("step"))
    saved_rng, rng_device = arrays.pop("rng"), str(arrays.pop("rng_device"))
    if rng:
        if rng_device != state.rng.device.type:
            raise ValueError(f"{path} holds a {rng_device} generator's state; this run's "
                             f"generator is on {state.rng.device.type}")
        state.rng.set_state(torch.from_numpy(saved_rng))
    if arrays:
        raise ValueError(f"{path} has tensors the state lacks: {sorted(arrays)[:5]}")
    return state


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The highest-step ``otgan_state-<step>.npz`` in ``save_dir``, or None
    (replaces the reference's filename-suffix parsing, ``train.py:190-193``)."""
    wait_for_pending_saves()  # this process's newest file may still be renaming
    best, best_step = None, -1
    for p in glob.glob(os.path.join(save_dir, f"{_PREFIX}-*.npz")):
        m = re.search(rf"{_PREFIX}-(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def checkpoint_step(path: str) -> int:
    """The step in a checkpoint's name; raises for anything else, a
    digit-named directory included."""
    if os.path.isdir(path):
        raise ValueError(f"not a checkpoint path: {path} (directories are orbax "
                         "checkpoints, which the port does not read)")
    m = re.search(rf"{_PREFIX}-(\d+)\.npz$", path)
    if not m:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(m.group(1))


def prune_checkpoints(save_dir: str, max_to_keep: int = 5,
                      keep_every_hours: float = 5.0) -> list:
    """Retention of ``tf.train.Saver(max_to_keep=5,
    keep_checkpoint_every_n_hours=...)``, as the reference's saving variant
    uses it (``train_with_model_saving.py:59``): keep the ``max_to_keep``
    highest steps, plus one long-term checkpoint per ``keep_every_hours``
    window (by file mtime). Returns the deleted paths."""
    wait_for_pending_saves()  # never prune around an in-flight write
    return _prune_committed(save_dir, max_to_keep, keep_every_hours)


def _prune_committed(save_dir: str, max_to_keep: int, keep_every_hours: float) -> list:
    """Retention without the pending-save barrier (the writer thread calls
    this after its own write; joining itself would deadlock)."""
    deleted = []
    # a crash mid-save leaves otgan_state-<N>.npz.tmp.npz behind
    for p in glob.glob(os.path.join(save_dir, f"{_PREFIX}-*.tmp.npz")):
        os.remove(p)
        deleted.append(p)
    paths = [p for p in glob.glob(os.path.join(save_dir, f"{_PREFIX}-*.npz"))
             if re.search(rf"{_PREFIX}-(\d+)\.npz$", p)]
    if len(paths) <= max_to_keep:
        return deleted
    # "newest" is the highest STEP (the resume order); mtimes rank only the
    # long-term anchors, since copies and restores can flatten them
    by_step = sorted(paths, key=checkpoint_step)
    keep = set(by_step[-max_to_keep:])
    window = keep_every_hours * 3600.0
    last_kept = None
    for mtime, p in sorted((os.path.getmtime(p), p) for p in by_step):
        if last_kept is None or mtime - last_kept >= window:
            keep.add(p)
            last_kept = mtime
    for p in by_step:
        if p not in keep:
            os.remove(p)
            deleted.append(p)
    return deleted
