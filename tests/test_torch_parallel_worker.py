"""Worlds of CPU processes joined by gloo, for the port's multi-rank tests.

:class:`World` starts ``size`` processes (spawned, so no state leaks in
from the test process) that join one gloo group through a file in a
temporary directory, then run tasks: a task is the name of a function of
this module, called on every rank as ``fn(rank, size, **kwargs)``; the
test gets the ranks' results in rank order. A task that fails, or does not
finish within its timeout (a collective whose peer is missing blocks
forever), tears the world down and fails the test; the next task starts a
new world. This module imports no JAX.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist


class World:
    def __init__(self, size: int, timeout: float = 300.0):
        self.size = size
        self.timeout = timeout
        self._procs = []

    def _start(self):
        ctx = mp.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory()
        init = os.path.join(self._dir.name, "init")
        self._tasks = [ctx.Queue() for _ in range(self.size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_serve, args=(r, self.size, init, self._tasks[r], self._results),
                        daemon=True)
            for r in range(self.size)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn: str, **kwargs):
        """``fn(rank, size, **kwargs)`` on every rank; the results by rank."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, kwargs))
        out = {}
        try:
            while len(out) < self.size:
                rank, ok, value = self._results.get(timeout=self.timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed in {fn}:\n{value}")
                out[rank] = value
        except queue.Empty:
            self.close()
            raise TimeoutError(f"{fn} did not finish on {self.size} ranks in {self.timeout} s")
        except RuntimeError:
            self.close()
            raise
        return [out[r] for r in range(self.size)]

    def close(self):
        for q in self._tasks if self._procs else []:
            q.put(None)
        for p in self._procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join(timeout=20)
        if self._procs:
            self._dir.cleanup()
        self._procs = []


def _serve(rank, size, init, tasks, results):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=size)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, kwargs = item
            try:
                results.put((rank, True, globals()[fn](rank, size, **kwargs)))
            except Exception:  # reported to the test, which fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _block(a: np.ndarray, rank: int, size: int) -> torch.Tensor:
    b = a.shape[0] // size
    return torch.from_numpy(np.ascontiguousarray(a[rank * b:(rank + 1) * b]))


def _np(m):
    return [t.numpy() for t in m[:4]] + [float(m.entropy)]


def _same_on_every_rank(tensors) -> bool:
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return torch.equal(hi, lo)


# ---- tasks ----

def rows_matcher(rank, size, fa, fb, lam, iters, single=False, tol=0.0, batch=None,
                 precision=None):
    """This rank's outputs of the row-sharded matcher (kernel path), the
    tier its block picks, and the plain steps it ran. ``fa``/``fb`` are the
    global features, zero-padded to a multiple of ``size`` when ``batch``
    is given."""
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st
    from otgan_tpu_torch.parallel import matching_sharded as ms

    make = ms.make_sharded_single_batch_matcher if single else ms.make_sharded_two_batch_matcher
    st.reset_launch_counts()
    m = make(None, lam, iters, tol=tol, use_pallas=True, precision=precision)(
        _block(fa, rank, size), _block(fb, rank, size), batch=batch)
    return _np(m), dict(st.launches)


def matrix_matcher(rank, size, fa, fb, lam, iters, single=False, precision=None):
    """This rank's outputs of the matrix-parallel matcher (kernel path) and
    the launches of its Sinkhorn tiers (``train.kernel_launches``)."""
    from otgan_tpu_torch import train
    from otgan_tpu_torch.nn import dense_boundary, layer_boundary
    from otgan_tpu_torch.ops import (
        sinkhorn_cuda,
        sinkhorn_grid_cuda,
        sinkhorn_resident_cuda,
        sinkhorn_step_cuda,
    )
    from otgan_tpu_torch.parallel import matching_matrix as mm
    from otgan_tpu_torch.utils import tracing

    for mod in (sinkhorn_cuda, sinkhorn_grid_cuda, sinkhorn_resident_cuda, sinkhorn_step_cuda,
                layer_boundary, dense_boundary):
        mod.reset_launch_counts()
    tracing.reset_counts()  # the main path's counts, beside the launches
    make = (mm.make_matrix_parallel_single_batch_matcher if single
            else mm.make_matrix_parallel_two_batch_matcher)
    m = make(None, lam, iters, use_pallas=True, precision=precision)(
        _block(fa, rank, size), _block(fb, rank, size))
    return _np(m), train.kernel_launches()


def engine_step(rank, size, cfg, state_path, x_init, x, z, kind):
    """One step of the port's engine on ``size`` ranks from the JAX state in
    ``state_path`` (a pickle of plain dicts written by the test): the step's
    dist and entropy, the updated parameters, and the init's spread."""
    import pickle

    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.convert import state_from_jax, unflatten_params
    from otgan_tpu_torch.engine import Engine

    torch.set_num_threads(2)
    eng = Engine(TrainConfig(**cfg), device="cpu")
    state, nf = eng.init_state(0, x_init)
    with open(state_path, "rb") as f:
        state = state_from_jax(eng, state, pickle.load(f))
    step = eng.disc_step if kind == "disc" else eng.gen_step
    state, met = step(state, x, z)
    module = state.disc if kind == "disc" else state.gen
    if not _same_on_every_rank(module.parameters()):
        raise RuntimeError("parameters differ across ranks after the step")
    return dict(
        dist=float(met.dist), entropy=float(met.entropy), nf=nf,
        init_spread=eng.init_spread, desc=eng.matcher_desc,
        params=unflatten_params(dict(module.named_parameters())) if rank == 0 else None,
    )


def engine_matchers(rank, size, fa, fb, cfgs):
    """For each config: the engine's matcher description (after its first
    match) and its outputs on this rank's rows."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine

    out = []
    for cfg in cfgs:
        eng = Engine(TrainConfig(**cfg), device="cpu")
        m = eng._matcher(_block(fa, rank, size), _block(fb, rank, size))
        out.append((eng.matcher_desc, _np(m)))
    return out


def engine_grads(rank, size, cfg, x_init, x, z, kind):
    """The gradients one step of the port's engine hands its optimizer on
    ``size`` ranks (after their all-reduce), by parameter name, with the
    step's dist and entropy; rank 0 returns the gradients."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine

    eng = Engine(TrainConfig(**cfg), device="cpu")
    state, _ = eng.init_state(0, x_init)
    captured = {}
    update = eng.opt_update

    def spy(params, grads, opt, lr, **kw):
        captured.update({k: g.numpy().copy() for k, g in grads.items()})
        return update(params, grads, opt, lr, **kw)

    eng.opt_update = spy
    step = eng.disc_step if kind == "disc" else eng.gen_step
    state, met = step(state, x, z)
    return dict(dist=float(met.dist), entropy=float(met.entropy),
                grads=captured if rank == 0 else None)


def perturb_state(state, seed: int):
    """Move every tensor of a train state to seeded random values (a tensor
    read in the wrong place cannot then pass) and set the step and the
    optimizers' scalars, the same on every rank."""
    from otgan_tpu_torch.utils.checkpoint import _named_tensors, _opt_scalars

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, t in _named_tensors(state):
            t.normal_(generator=gen)
    for i, (_, opt, name) in enumerate(_opt_scalars(state)):
        setattr(opt, name, 3.0 + i)
    state.step = 11
    state.rng.manual_seed(seed)
    return state


def named_arrays(state) -> dict:
    """Every tensor and scalar of a train state as numpy, by key."""
    from otgan_tpu_torch.utils.checkpoint import _named_tensors, _opt_scalars

    out = {k: t.detach().float().cpu().numpy().copy() for k, t in _named_tensors(state)}
    out.update({k: getattr(opt, name) for k, opt, name in _opt_scalars(state)})
    out["step"] = state.step
    out["rng"] = state.rng.get_state().numpy().copy()
    return out


def dcp_save(rank, size, cfg, x_init, save_dir, step, seed):
    """Every rank makes the same state and writes it with the sharded
    backend; rank 0 returns its arrays."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.utils import checkpoint_orbax

    eng = Engine(TrainConfig(**cfg), device="cpu")
    state = perturb_state(eng.init_state(0, x_init)[0], seed)
    checkpoint_orbax.save_checkpoint(save_dir, state, step, async_write=True)
    checkpoint_orbax.wait_for_pending_saves()
    return named_arrays(state) if rank == 0 else None


def dcp_restore(rank, size, cfg, x_init, path):
    """Every rank restores ``path`` into a fresh state; returns its arrays."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.utils.checkpoint import restore_checkpoint

    eng = Engine(TrainConfig(**cfg), device="cpu")
    state = eng.init_state(1, x_init)[0]
    restore_checkpoint(path, state)
    return named_arrays(state)


def multihost_engine_steps(rank, size, cfg, x_init, xs, ranks_per_process):
    """Steps of a ``--multihost`` engine whose processes are nodes of
    ``ranks_per_process`` ranks (torchrun's ``LOCAL_WORLD_SIZE``): each rank
    is handed its process's rows of the init batch and of every batch; the
    steps' dist and entropy."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine

    os.environ["LOCAL_WORLD_SIZE"] = str(ranks_per_process)
    try:
        eng = Engine(TrainConfig(**cfg, multihost=True), device="cpu")
        pid, pcount = rank // ranks_per_process, size // ranks_per_process
        if (eng.pid, eng.pcount, eng.local_world) != (pid, pcount, ranks_per_process):
            raise RuntimeError(f"processes {eng.pid}/{eng.pcount} of {eng.local_world} ranks")
        state = eng.init_state(0, np.array_split(x_init, pcount)[pid])[0]
        out = []
        for x in xs:
            step = eng.disc_step if eng.is_disc_step(state.step) else eng.gen_step
            state, met = step(state, np.array_split(x, pcount)[pid])
            out.append((float(met.dist), float(met.entropy)))
        return out
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


# ---- --fused_cycle on K ranks (tests/test_torch_fused_cycle_ranks.py) ----

class StubGraph:
    """A graph without a card: capture runs the block (on the CPU, for
    real), replay does nothing; its pool is the one it was given, else a
    token of its own."""

    def register_generator(self, gen):
        self.gen = gen

    @contextlib.contextmanager
    def capture(self, pool=None):
        self.given_pool = pool
        yield

    def pool(self):
        return self.given_pool if self.given_pool is not None else ("pool", id(self))

    def replay(self):
        pass


class EmulatedCycleGraph:
    """``cycle_graph.CycleGraph`` as the engine sees it, without a card: its
    capture runs none of the cycle (a CUDA graph's capture executes none
    of its work, collectives included) and its replay runs the cycle once,
    eagerly. ``graph_factory`` is called at capture, where a test makes it
    fail."""

    def __init__(self, engine, state, xs, graph_factory, pool=None):
        graph_factory()
        self.engine = engine
        self.pool = pool if pool is not None else ("pool", id(self))

    def replay(self, state, xs):
        return self.engine.cycle(state, xs)


def _graph_factory(rank, fail, emulated: bool):
    """Graphs for one engine: :class:`StubGraph`s, of which capture number
    ``fail[1]`` (0-based) on rank ``fail[0]`` fails, ``fail[2]`` saying how:
    ``"oom"`` out of device memory, ``"error"`` otherwise. An emulated
    capture fails at its start; a stub's at its end, after its cycle ran,
    as ``capture_end`` fails on the card."""
    from otgan_tpu_torch.cycle_graph import CaptureOutOfMemory

    made = []

    def error(how):
        if how == "oom":
            return torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return RuntimeError("CUDA error: operation not permitted when stream is capturing")

    class FailingStub(StubGraph):
        @contextlib.contextmanager
        def capture(self, pool=None):
            with super().capture(pool):
                yield
            raise error(fail[2])

    def factory():
        i = len(made)
        made.append(i)
        failing = fail is not None and fail[0] == rank and fail[1] == i
        if emulated:
            if failing:
                e = error(fail[2])
                if fail[2] == "oom":
                    raise CaptureOutOfMemory(f"capturing a cycle ran out of memory: {e}") from e
                raise e
            return None
        return FailingStub() if failing else StubGraph()

    return factory


def fused_cycle_ranks(rank, size, cfg, x_init, xs, calls, graphs="cpu", fail=None):
    """The engine of ``cfg`` on this rank, handed the global batches ``xs``
    through ``cycle_step`` in calls of ``calls`` batches each. ``graphs``:
    ``"cpu"`` the CPU's own path (batches grouped, each cycle eager);
    ``"stub"`` captures through ``CycleGraph`` with :class:`StubGraph`;
    ``"emulated"`` through :class:`EmulatedCycleGraph`; ``fail`` as in
    :func:`_graph_factory`. A raised error ends the calls. Returns every
    step's (dist, entropy), the engine's fused flags and graphs, this
    rank's launch counts and state step, the error, whether the parameters
    agree on every rank, and rank 0's state (``named_arrays``)."""
    from otgan_tpu_torch import engine as engine_mod
    from otgan_tpu_torch import train
    from otgan_tpu_torch.config import TrainConfig

    eng = engine_mod.Engine(TrainConfig(**cfg), device="cpu")
    state, _ = eng.init_state(0, x_init)
    if graphs != "cpu":
        eng.cycle_graphs, eng.graph_factory = True, _graph_factory(rank, fail, graphs == "emulated")
    real = engine_mod.CycleGraph
    if graphs == "emulated":
        engine_mod.CycleGraph = EmulatedCycleGraph
    steps, error, at = [], None, []
    try:
        i = 0
        for n in calls:
            state, mets = eng.cycle_step(state, [torch.from_numpy(x) for x in xs[i:i + n]])
            steps += [(float(m.dist), float(m.entropy)) for m in mets]
            at.append((state.step, train.kernel_launches()))
            i += n
    except Exception as e:  # the test holds every rank to raising
        error = f"{type(e).__name__}: {e}"
    finally:
        engine_mod.CycleGraph = real
    same = _same_on_every_rank([*state.gen.parameters(), *state.disc.parameters()])
    return dict(steps=steps, error=error, after_calls=at, same_on_every_rank=same,
                fused=(eng.cycle_graphs, eng.fused_cycle, eng.fused_cycle_reason),
                graphs=len(eng._graphs), state=named_arrays(state) if rank == 0 else None)


def fused_cycle_from_jax(rank, size, cfg, state_path, x_init, xs, zs, captured):
    """One cycle of the engine of ``cfg`` on the batches ``xs`` from the JAX
    state in ``state_path`` (as :func:`engine_step`), its latents the global
    ``zs`` of the JAX cycle: captured (``StubGraph``, each kind of step
    taken as warmed up) or, without ``captured``, step by step. The steps'
    dist and entropy, rank 0's parameters, whether they agree on every
    rank."""
    import pickle

    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.convert import state_from_jax, unflatten_params
    from otgan_tpu_torch.engine import Engine

    torch.set_num_threads(2)
    eng = Engine(TrainConfig(**cfg), device="cpu")
    state, _ = eng.init_state(0, x_init)
    with open(state_path, "rb") as f:
        state = state_from_jax(eng, state, pickle.load(f))
    draws = iter(zs)
    eng.latents = lambda batch, generator=None: torch.from_numpy(next(draws))
    xs = [torch.from_numpy(x) for x in xs]
    if captured:
        eng.cycle_graphs, eng.graph_factory = True, StubGraph
        eng._eager_kinds = {True, False}
        state, mets = eng.cycle_step(state, xs)
        if len(eng._graphs) != 1:
            raise RuntimeError(f"the cycle was not captured: {len(eng._graphs)} graphs")
    else:
        state, mets = eng.cycle(state, xs)
    params = [*state.gen.parameters(), *state.disc.parameters()]
    return dict(steps=[(float(m.dist), float(m.entropy)) for m in mets],
                same_on_every_rank=_same_on_every_rank(params),
                gen=unflatten_params(dict(state.gen.named_parameters())) if rank == 0 else None,
                disc=unflatten_params(dict(state.disc.named_parameters())) if rank == 0 else None)
