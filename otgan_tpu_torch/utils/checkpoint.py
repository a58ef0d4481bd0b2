"""Full-train-state checkpoints (counterpart of
``otgan_tpu/utils/checkpoint.py``): the npz backend, and the dispatch to
the sharded one (``utils/checkpoint_orbax.py``).

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

:func:`restore_checkpoint` also reads the JAX package's npz files, which
bear the same name (``otgan_state-<epoch>.npz``) and hold the ``TrainState``
leaves as ``leaf_<i>`` in pytree order (``leaf_<i>__bf16`` for bfloat16
slots; ``otgan_tpu/utils/checkpoint.py:103-117``). The two are told apart by
their keys (:func:`checkpoint_format`), never by the name, and a JAX file is
read through ``convert.state_from_jax_leaves``.

Step directories ``<save_dir>/orbax/<step>`` are the sharded backend's
(``--checkpoint_backend orbax``): the port writes them with
``torch.distributed.checkpoint`` (DCP), and :func:`restore_checkpoint`
reads them there once committed (``.metadata`` written). The JAX package's
orbax step directories sit at the same paths; they cannot be read without
orbax, so a restore of one raises, naming it. :func:`checkpoint_format`
tells the four formats apart by their files and keys: ``"port"`` and
``"jax"`` npz files, ``"dcp"`` and ``"orbax (JAX)"`` directories.
:func:`latest_checkpoint` scans both backends; the highest step wins.
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

from otgan_tpu_torch.convert import state_from_jax_leaves

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
    """Join the in-flight background writes of both backends, if any; a
    failure inside one (disk full, unwritable directory) is re-raised here,
    so a return means every reported checkpoint is on disk."""
    from otgan_tpu_torch.utils import checkpoint_orbax

    _writer.wait()
    checkpoint_orbax.wait_for_pending_saves()


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


def _step_dir_format(path: str) -> str:
    """``"dcp"`` or ``"orbax (JAX)"`` for a step directory
    ``<save_dir>/orbax/<step>``; raises for any other directory, and for a
    step directory whose write did not finish."""
    from otgan_tpu_torch.utils import checkpoint_orbax as co

    step_dir = os.path.normpath(path)
    if not (re.fullmatch(r"\d+", os.path.basename(step_dir))
            and os.path.basename(os.path.dirname(step_dir)) == co.SUBDIR):
        raise ValueError(f"not a checkpoint path: {path} (directories must be step "
                         f"directories <save_dir>/{co.SUBDIR}/<step>)")
    if co.is_committed(step_dir):
        return "dcp"
    if co.is_jax_orbax(step_dir):
        return "orbax (JAX)"
    raise ValueError(f"{path} holds no finished checkpoint: neither DCP's {co.METADATA} nor "
                     "orbax's metadata (a write that did not finish?)")


def _load_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _is_jax_format(arrays) -> bool:
    return "leaf_0" in arrays or "leaf_0" + _BF16_SUFFIX in arrays


def checkpoint_format(path: str) -> str:
    """For a step directory ``"dcp"`` (the port's sharded backend) or
    ``"orbax (JAX)"`` (the JAX package's, unreadable here); for a file
    ``"jax"`` (``leaf_<i>`` keys), else ``"port"`` (named keys, ``step``,
    ``rng_device``)."""
    if os.path.isdir(path):
        return _step_dir_format(path)
    with np.load(path, allow_pickle=False) as data:
        return "jax" if _is_jax_format(data.files) else "port"


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _jax_leaves(arrays: Dict[str, np.ndarray], path: str) -> list:
    """A JAX file's leaves in order, bfloat16 slots decoded to float32."""
    leaves = []
    for i in range(len(arrays)):
        if f"leaf_{i}" in arrays:
            leaves.append(arrays[f"leaf_{i}"])
        elif f"leaf_{i}{_BF16_SUFFIX}" in arrays:
            leaves.append(_bf16_to_f32(arrays[f"leaf_{i}{_BF16_SUFFIX}"]))
        else:
            break
    if len(leaves) != len(arrays):
        raise ValueError(f"{path}: a JAX checkpoint's keys must be leaf_0 .. "
                         f"leaf_{len(arrays) - 1}; got {sorted(arrays)[:5]}")
    return leaves


@torch.no_grad()
def restore_checkpoint(path: str, state, rng: bool = True):
    """Restore ``path`` into ``state`` (made by ``Engine.init_state`` for the
    same run configuration) in place and return it; the file may be the
    port's or the JAX package's, or a step directory of the port's sharded
    backend (every rank of the run calls this for one). Names (or the JAX
    leaf order) and shapes are checked; bfloat16 slots are decoded.
    ``rng=False`` leaves the run generator as it is (a sampler that draws
    from its own seeds, perhaps on another device than the run); from a JAX
    file it is seeded from the JAX key (``convert.seed_from_jax_key``). A
    step directory of the JAX package's orbax backend raises."""
    wait_for_pending_saves()  # never read around an in-flight write
    if os.path.isdir(path):
        fmt = _step_dir_format(path)
        if fmt != "dcp":
            raise ValueError(
                f"{path} is a checkpoint of the JAX package's orbax backend ({fmt} format), "
                "which cannot be read without orbax: write it as npz with the JAX package "
                "(--checkpoint_backend npz) and pass that otgan_state-<step>.npz, or resume "
                "it there")
        from otgan_tpu_torch.utils import checkpoint_orbax

        return checkpoint_orbax.restore_checkpoint(path, state, rng=rng)
    arrays = _load_arrays(path)
    if _is_jax_format(arrays):
        return state_from_jax_leaves(state, _jax_leaves(arrays, path), rng=rng)
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
    """The highest-step checkpoint in ``save_dir``, or None (replaces the
    reference's filename-suffix parsing, ``train.py:190-193``): an
    ``otgan_state-<step>.npz`` file or a finished step directory
    ``orbax/<step>``, the port's (DCP) or the JAX package's (orbax, which a
    restore then refuses, naming it). A step directory whose write did not
    finish is passed over."""
    from otgan_tpu_torch.utils import checkpoint_orbax as co

    wait_for_pending_saves()  # this process's newest file may still be renaming
    best, best_step = None, -1
    for p in glob.glob(os.path.join(save_dir, f"{_PREFIX}-*.npz")):
        m = re.search(rf"{_PREFIX}-(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    for p in glob.glob(os.path.join(save_dir, co.SUBDIR, "*")):
        base = os.path.basename(p)
        if (re.fullmatch(r"\d+", base) and int(base) > best_step
                and (co.is_committed(p) or co.is_jax_orbax(p))):
            best, best_step = p, int(base)
    return best


def checkpoint_step(path: str) -> int:
    """The step of a checkpoint: from an ``otgan_state-<step>.npz`` name or a
    step directory ``<save_dir>/orbax/<step>``; raises for anything else,
    another digit-named directory included."""
    if os.path.isdir(path):
        _step_dir_format(path)
        return int(os.path.basename(os.path.normpath(path)))
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
    paths = {checkpoint_step(p): p for p in glob.glob(os.path.join(save_dir, f"{_PREFIX}-*.npz"))
             if re.search(rf"{_PREFIX}-(\d+)\.npz$", p)}
    keep = retained_steps({step: os.path.getmtime(p) for step, p in paths.items()},
                          max_to_keep, keep_every_hours)
    for step in sorted(set(paths) - keep):
        os.remove(paths[step])
        deleted.append(paths[step])
    return deleted


def retained_steps(mtimes: Dict[int, float], max_to_keep: int,
                   keep_every_hours: float) -> set:
    """The steps that ``tf.train.Saver``'s retention keeps of checkpoints
    written at ``mtimes`` (step -> seconds): the ``max_to_keep`` highest,
    plus one long-term checkpoint per ``keep_every_hours`` window; all of
    them while there are at most ``max_to_keep``. "Newest" is the highest
    step (the resume order); mtimes rank only the long-term anchors, since
    copies and restores can flatten them."""
    if len(mtimes) <= max_to_keep:
        return set(mtimes)
    keep = set(sorted(mtimes)[-max_to_keep:])
    window, last_kept = keep_every_hours * 3600.0, None
    for mtime, step in sorted((t, s) for s, t in mtimes.items()):
        if last_kept is None or mtime - last_kept >= window:
            keep.add(step)
            last_kept = mtime
    return keep
