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
  capture's delta is taken back and added once per replay;
* the capture moves no host state: ``state.step`` and the counters are
  put back after it, and the caller replays at once for the same batches.

A capture that fails raises with the CUDA error (out of memory also names
``--no_fused_cycle``); nothing falls back to the eager cycle. A graph
keeps the memory its capture allocated in a private pool; an engine's
graphs share the first one's pool (``pool``), which is safe because
replays never overlap and each graph keeps its own outputs alive, so one
pool holds the temporaries of one cycle, not of each schedule.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch.profiler import record_function

from otgan_tpu_torch.ops import (
    sinkhorn_cuda,
    sinkhorn_grid_cuda,
    sinkhorn_resident_cuda,
    sinkhorn_step_cuda,
)

# every kernel's launch counter (dicts the wrappers add to at launch)
COUNTERS = (sinkhorn_cuda.launches, sinkhorn_grid_cuda.launches,
            sinkhorn_resident_cuda.launches, sinkhorn_step_cuda.launches)


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
        self.graph.register_generator_state(gen)

    def capture(self, pool=None):
        return torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local")

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
        self.static_xs = [x.clone() for x in xs]
        self.graph = graph_factory()
        self.graph.register_generator(state.rng)
        step0 = state.step
        before = [dict(c) for c in COUNTERS]
        checks: List[Tuple[int, str, torch.Tensor]] = []
        engine.deferred_checks = checks
        try:
            with self.graph.capture(pool):
                _, mets = engine.cycle(state, self.static_xs)
                self.dists = torch.stack([m.dist for m in mets])
                self.entropies = torch.stack([m.entropy for m in mets])
                self.flags = torch.stack([ok for _, _, ok in checks]) if checks else None
        except RuntimeError as e:
            if "out of memory" in str(e):
                raise RuntimeError(f"capturing a cycle of {self.n} steps ran out of device "
                                   f"memory ({e}); run with --no_fused_cycle") from e
            raise
        finally:
            engine.deferred_checks = None
            after = [dict(c) for c in COUNTERS]
            for c, b in zip(COUNTERS, before):
                c.update(b)
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
        step0 = state.step
        state.step += self.n
        if self.flags is not None:
            for (offset, name), ok in zip(self.checks, self.flags.tolist()):
                if not ok:
                    raise FloatingPointError(
                        f"--debug_nans: non-finite {name} at step {step0 + offset} (0-based)")
        dists, ents = self.dists.clone(), self.entropies.clone()
        return state, [StepMetrics(dist=dists[i], entropy=ents[i]) for i in range(self.n)]
