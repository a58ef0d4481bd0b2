"""One G:D cycle as one CUDA graph (``--fused_cycle``; the counterpart of
the JAX engine's one cycle program, ``otgan_tpu/engine.py::_cycle_step``).

:class:`CycleGraph` captures ``Engine.cycle`` on static input buffers once
per schedule (the ``is_disc_step`` of each step; a full cycle or an
epoch's leftover) and replays it for every later call with that schedule.
What a capture must not lose:

* the latents: ``TrainState.rng`` is registered with the graph, so every
  replay advances it and draws what the eager cycle draws;
* Adam's step count is a device tensor (``nn/optim.py``), so the bias
  corrections advance in the graph;
* ``--debug_nans``: under capture the engine writes each check's finite
  flag into the graph's output instead of reading it; the host reads the
  flags after each replay and raises at the first bad one, in the eager
  order;
* the launch counters are Python and count at capture time only: the
  capture's delta is taken back and added once per replay. The phase marks
  (``utils/tracing.py``) are kernels on the card, recorded at capture and
  run by each replay; on the CPU (a test's stub graph, whose capture runs
  the cycle) their host tally is treated as the counters are;
* the capture moves no host state: ``state.step`` and the counters are
  put back after it, and the caller replays at once for the same batches.

A capture that runs out of device memory raises :class:`CaptureOutOfMemory`
(also when the capture's end fails after it, "capture invalidated"), and
leaves no trace: the state, ``state.step``, the launch counters and the
latent generator are as before it (the generator registered with the dead
graph is replaced by a fresh one in the same state), and the thread's
stream is put back. ``Engine.cycle_step`` then drops its graphs and runs
every later call eagerly, as ``--no_fused_cycle`` does, and says why. Any
other failed capture raises with the CUDA error. A graph keeps the memory
its capture allocated in a private pool; an engine's graphs share the first
one's pool (``pool``), which is safe because replays never overlap and each
graph keeps its own outputs alive, so one pool holds the temporaries of one
cycle, not of each schedule.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import torch
from torch.profiler import record_function

from otgan_tpu_torch.nn import dense_boundary, layer_boundary
from otgan_tpu_torch.ops import (
    sinkhorn_cuda,
    sinkhorn_grid_cuda,
    sinkhorn_resident_cuda,
    sinkhorn_step_cuda,
)
from otgan_tpu_torch.utils import tracing

# every kernel's launch counter (dicts the wrappers add to at launch), and
# the main path's counts
COUNTERS = (sinkhorn_cuda.launches, sinkhorn_grid_cuda.launches,
            sinkhorn_resident_cuda.launches, sinkhorn_step_cuda.launches,
            layer_boundary.launches, dense_boundary.launches, tracing.counts)


class CaptureOutOfMemory(RuntimeError):
    """A cycle's capture ran out of device memory; nothing of it remains."""


def out_of_memory(e: BaseException) -> bool:
    """Whether ``e``, or an error it was raised in or from, is the device
    running out of memory."""
    while e is not None:
        if isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e):
            return True
        e = e.__cause__ or e.__context__
    return False


# graphs that a failed capture left half-registered with a generator: the
# graph lists the generator's state but the state does not list the graph
# (its first registration allocates, and ran out of memory), and freeing
# such a graph aborts the process. They never captured, so hold no pool;
# settle_half_registered completes the registration once memory is back.
_half_registered: List[Tuple[torch.cuda.CUDAGraph, torch.Generator]] = []


def settle_half_registered() -> None:
    """Complete the generator registrations a failed capture left half
    done, so those graphs free cleanly; one that fails again stays listed."""
    for graph, gen in list(_half_registered):
        try:
            graph.register_generator_state(gen)
        except RuntimeError:
            continue
        _half_registered.remove((graph, gen))


class TorchGraph:
    """``torch.cuda.CUDAGraph`` behind the interface :class:`CycleGraph`
    uses (a test substitutes a stub). Capture is thread-local, so the
    prefetch thread's copies and pinned allocations go on meanwhile."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def register_generator(self, gen: torch.Generator) -> None:
        if not hasattr(self.graph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator with a CUDA graph; "
                "its replays would reuse one latent draw: run with --no_fused_cycle")
        try:
            self.graph.register_generator_state(gen)
        except RuntimeError:
            _half_registered.append((self.graph, gen))
            raise

    @contextlib.contextmanager
    def capture(self, pool=None):
        stream = torch.cuda.current_stream()
        begun = False
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                begun = True
                yield
        except RuntimeError:
            if not begun:  # capture_begin registers the default generator first
                device = torch.cuda.current_device()
                _half_registered.append((self.graph, torch.cuda.default_generators[device]))
            raise
        finally:
            # a capture_begin or capture_end that raises skips the context's
            # own return to it
            torch.cuda.set_stream(stream)

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()


class CycleGraph:
    """``engine.cycle`` on ``len(xs)`` batches of ``xs``'s shapes, captured
    into the memory pool ``pool`` (a new one if None; :attr:`pool` is the
    one it used); :meth:`replay` runs it on new batches."""

    def __init__(self, engine, state, xs: Sequence[torch.Tensor],
                 graph_factory: Callable = TorchGraph, pool=None):
        self.n = len(xs)
        self.graph = graph_factory()
        rng_state = state.rng.get_state()
        step0 = state.step
        before = [dict(c) for c in COUNTERS]
        marks = tracing.host_marks()
        checks: List[Tuple[int, str, torch.Tensor]] = []
        engine.deferred_checks = checks
        try:
            self.static_xs = [x.clone() for x in xs]
            self.graph.register_generator(state.rng)
            with self.graph.capture(pool):
                _, mets = engine.cycle(state, self.static_xs)
                self.dists = torch.stack([m.dist for m in mets])
                self.entropies = torch.stack([m.entropy for m in mets])
                self.flags = torch.stack([ok for _, _, ok in checks]) if checks else None
        except RuntimeError as e:
            # the generator stays registered with the dead graph (mid-capture
            # if its end never ran): the state goes on with a fresh one
            rng = torch.Generator(device=state.rng.device)
            rng.set_state(rng_state)
            state.rng = rng
            if out_of_memory(e):
                raise CaptureOutOfMemory(
                    f"capturing a cycle of {self.n} steps ran out of device memory: {e}") from e
            raise
        finally:
            engine.deferred_checks = None
            after = [dict(c) for c in COUNTERS]
            for c, b in zip(COUNTERS, before):
                c.update(b)
            self.marks = tracing.take_back(marks)
            state.step = step0
        self.pool = self.graph.pool()
        self.delta = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, before)]
        self.checks = [(step - step0, name) for step, name, _ in checks]

    def replay(self, state, xs: Sequence[torch.Tensor]):
        """The cycle on ``xs``: ``(state, [StepMetrics] * n)``, the metrics
        copied out of the graph's buffers."""
        from otgan_tpu_torch.engine import StepMetrics

        for s, x in zip(self.static_xs, xs):
            s.copy_(x)
        with record_function("cycle"):
            self.graph.replay()
        for c, d in zip(COUNTERS, self.delta):
            for k, n in d.items():
                c[k] = c.get(k, 0) + n
        tracing.add_marks(self.marks)
        step0 = state.step
        state.step += self.n
        if self.flags is not None:
            for (offset, name), ok in zip(self.checks, self.flags.tolist()):
                if not ok:
                    raise FloatingPointError(
                        f"--debug_nans: non-finite {name} at step {step0 + offset} (0-based)")
        dists, ents = self.dists.clone(), self.entropies.clone()
        return state, [StepMetrics(dist=dists[i], entropy=ents[i]) for i in range(self.n)]
