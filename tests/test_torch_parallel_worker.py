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
    from otgan_tpu_torch.ops import (
        sinkhorn_cuda,
        sinkhorn_grid_cuda,
        sinkhorn_resident_cuda,
        sinkhorn_step_cuda,
    )
    from otgan_tpu_torch.parallel import matching_matrix as mm

    for mod in (sinkhorn_cuda, sinkhorn_grid_cuda, sinkhorn_resident_cuda, sinkhorn_step_cuda):
        mod.reset_launch_counts()
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
