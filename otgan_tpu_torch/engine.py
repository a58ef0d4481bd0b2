"""Single-device training engine (counterpart of ``otgan_tpu/engine.py``).

One generator step and one critic step of the reference (``train.py:108-151``)
as eager PyTorch on one device:

* generator step: images -> critic features of fake and real batches ->
  matching -> ``sum f_gen * sg(f_aa - f_ab)`` -> Adam descent -> EMA;
* critic step: the same matching on critic features with gradients into
  the critic, Adam with ``-lr`` (ascent, ``train.py:143``).

The 5:1 schedule (step ``s`` is a critic step when ``s % (n + 1) == 0``) is
a Python loop in :meth:`Engine.cycle`. Under ``--fused_cycle`` (the default)
:meth:`Engine.cycle_step` runs the trainer's cycles on one card as CUDA
graphs (``cycle_graph.py``): eagerly until each kind of step has run once,
then one capture per schedule, full or an epoch's leftover, all in one
memory pool, replayed; ``--sinkhorn_tol > 0``, several ranks and the CPU
run eagerly, and say why (``fused_cycle_reason``). Step functions take the
latent as an argument, so a test can feed the JAX package's draw; without
one they draw the family's latent (DCGAN ``U(-1, 1)^100``, toy ``N(0,
1)^256``, the DenseNet's tuple of four ``U(-1, 1)`` noises) from the state's
``torch.Generator``. Matching is float32 at ``--matching_precision`` (true
float32 by default, 3xTF32 for ``high``, one TF32 pass for ``default``:
``ops/costs.py``); model matmuls and convs run in ``cfg.compute_dtype``. The model family (``--model
dcgan|densenet|toy_mlp``) picks the generator, the critic, the latent
distribution and the transport cost: cosine for the conv models, the scaled
squared-Euclidean cost for the toy (``otgan_tpu/engine.py:77-79``), in
every matcher build.

``--grad_accum M`` (``otgan_tpu/engine.py:400-542``) microbatches the model
around the full-batch match: the features of M microbatches without
autograd, one global match, then each microbatch again under autograd,
seeded by its rows of the match's stop-gradient cotangents, its gradients
summed. The MED losses are sums over rows, so, given the same latents,
the gradients are the full-batch step's. Only the (B, d) features, the
critic step's fake images and one microbatch's activations are live at a
time; the batch stays uint8 on the device until its microbatch is ingested.

Each step is named for ``torch.profiler`` (``--profile_dir``): ``gen_step``
or ``disc_step``, inside them ``features``, ``match``, ``loss_backward`` and
``update``, and ``microbatch`` under accumulation. ``--debug_nans`` checks
the loss, the gradients, ``dist`` and ``entropy`` of every step before its
update and raises ``FloatingPointError`` at the first non-finite one (in a
captured cycle, from the graph's flags after the replay); without it a
step makes no check and no host sync.

Several GPUs (counterpart of the JAX engine's mesh half): one process per
GPU under ``torchrun``, each with the whole model. Every rank is handed the
GLOBAL batch and draws the global latents from the same generator, then
keeps its contiguous rows (``parallel/mesh.py``). The matcher runs on local
rows (row-sharded, matrix-parallel, or gathered and global, as
``--matching_layout`` and ``--sharded_matching`` pick). Each rank's loss is
the sum over its rows, which is the global loss restricted to them because
the MED surrogate decomposes row by row; the gradients are then summed
over the ranks, so every rank takes the same optimizer step. The reported
distance sums its three inner products over the ranks before dividing by
``2 B``. With one rank the engine is the single-device engine.

Several hosts (``--multihost``, ``parallel/mesh.py``): each process is
handed its own shard's batch, ``B / P`` rows, and its ranks keep their
rows of it, which are their rows of the global batch (ranks are numbered
process by process). The latents are still drawn at the global batch from
the shared generator, each rank keeping its rows, and the data-dependent
init runs on the processes' init batches gathered in process order; so
the latents, the global match and the gradients are those of one process
fed the concatenation of the processes' batches.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from otgan_tpu_torch.config import TrainConfig, check_supported
from otgan_tpu_torch.cycle_graph import CycleGraph, TorchGraph
from otgan_tpu_torch.models import get_model
from otgan_tpu_torch.nn.ema import ema_init, ema_update
from otgan_tpu_torch.nn.layers import data_init, reset_parameters
from otgan_tpu_torch.nn.optim import make_optimizer
from otgan_tpu_torch.ops.costs import cosine_cost, resolve_precision, scaled_sqeuclidean_cost
from otgan_tpu_torch.ops.losses import med_discriminator_loss, med_generator_loss
from otgan_tpu_torch.ops.matching import (
    MatchedFeatures,
    calc_distance,
    match_random,
    match_single_batch,
    match_two_batch,
)
from otgan_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_sum,
    local_rows,
    process_count,
    process_index,
    rank_and_size,
    replicate,
)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for ``cpu``; never falls back."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return d


@dataclass
class TrainState:
    """Everything a step changes. Parameters live in the two modules; the
    EMA shadow and optimizer moments are dicts keyed by parameter name."""

    gen: nn.Module
    disc: nn.Module
    gen_ema: Dict[str, torch.Tensor]
    gen_opt: Any
    disc_opt: Any
    step: int
    rng: torch.Generator  # latent draws when a step is given none


class StepMetrics(NamedTuple):
    dist: torch.Tensor  # transport distance BEFORE the update (train.py:231)
    entropy: torch.Tensor  # mean Sinkhorn entropy (utils/matching.py:57)


def map_latent(fn, z):
    """``fn`` on a latent, or on each tensor of a tuple of latents (the
    DenseNet's noises)."""
    return tuple(fn(t) for t in z) if isinstance(z, (tuple, list)) else fn(z)


def _as_tensor(t) -> torch.Tensor:
    return torch.from_numpy(t) if isinstance(t, np.ndarray) else t


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No parameter gradients for ``module`` (its input still gets one)."""
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


class Engine:
    def __init__(self, cfg: TrainConfig, device=None, group=None):
        """``group``: the process group of the ranks (default: the default
        group when one is initialised); one rank is the single-device path."""
        check_supported(cfg)
        self.cfg = cfg
        self.group = group
        self.rank, self.world = rank_and_size(group)
        if cfg.num_devices and cfg.num_devices != self.world:
            raise ValueError(
                f"--num_devices {cfg.num_devices} must equal the number of "
                f"ranks ({self.world}): launch with torchrun --nproc_per_node "
                f"{cfg.num_devices}"
            )
        # the processes that hold disjoint data shards (one without --multihost)
        self.pid, self.pcount = (process_index(), process_count()) if cfg.multihost else (0, 1)
        if self.world % self.pcount:
            raise ValueError(f"{self.world} ranks do not split over {self.pcount} processes")
        self.local_world = self.world // self.pcount  # ranks of this process
        self.local_index = self.rank % self.local_world
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None and self.world > 1:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if cfg.grad_accum > 1 and cfg.batch_size % cfg.grad_accum != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by "
                f"grad_accum {cfg.grad_accum}"
            )
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.family = get_model(cfg.model)
        self.cost_fn = scaled_sqeuclidean_cost if cfg.model == "toy_mlp" else cosine_cost
        self.opt_init, opt_update = make_optimizer(cfg.optimizer)
        if cfg.optimizer == "nesterov":
            self.opt_update = functools.partial(opt_update, mom1=cfg.adam_mom1)
        else:
            self.opt_update = functools.partial(
                opt_update, mom1=cfg.adam_mom1, mom2=cfg.adam_mom2
            )
        # --matching_precision: validated eagerly; "highest" maps to None, the
        # matchers' default path (otgan_tpu/engine.py:80-84)
        resolve_precision(cfg.matching_precision)
        self.matching_precision = (
            None if cfg.matching_precision == "highest" else cfg.matching_precision)
        if self.compute_dtype == torch.float32:
            # float32 model compute means float32 convs, not cuDNN's TF32
            torch.backends.cudnn.allow_tf32 = False
        self._matcher = self._make_matcher()
        self.cycle_batches, self.fused_cycle, self.fused_cycle_reason = self._fused_cycle_plan()
        # --fused_cycle on the card: calls run eagerly until each kind of step
        # still to come has run once (lazy init, cuBLAS and cuDNN workspaces,
        # the kernels' build); then each schedule is captured once and
        # replayed, every graph in the first one's memory pool
        self.cycle_graphs = self.fused_cycle
        self.graph_factory = TorchGraph
        self._graphs: Dict[Tuple[bool, ...], CycleGraph] = {}
        self._graph_pool = None
        self._eager_kinds: set = set()
        # set while a cycle is captured: --debug_nans checks are deferred here
        self.deferred_checks: Optional[list] = None

    def _fused_cycle_plan(self) -> Tuple[int, bool, str]:
        """``(batches a cycle_step call takes, whether they run as a CUDA
        graph, why not)``. The CPU has no graph but groups the batches as
        the card does, each cycle run eagerly."""
        cfg = self.cfg
        period = cfg.nr_gen_per_disc + 1
        if not cfg.fused_cycle:
            return 1, False, "--no_fused_cycle"
        if cfg.sinkhorn_tol > 0:
            return 1, False, ("--sinkhorn_tol > 0: the early exit reads the host every "
                              "iteration, which a graph cannot (ROADMAP queue 2b)")
        if self.world > 1:
            return 1, False, (f"{self.world} ranks: NCCL collectives are not captured yet "
                              "(ROADMAP queue 2b)")
        if self.device.type != "cuda":
            return period, False, "cpu: no CUDA graph; each cycle runs eagerly"
        return period, True, ""

    # -- matching mode dispatch (train.py:88-97) --
    def _make_matcher(self):
        cfg = self.cfg
        if cfg.matching_layout not in ("auto", "rows", "matrices"):
            raise ValueError(
                "matching_layout must be 'auto', 'rows' or 'matrices', got "
                f"{cfg.matching_layout!r}"
            )
        if self.world > 1:
            return self._make_parallel_matcher()
        if cfg.no_sinkhorn:
            self.matcher_desc = "random (--no_sinkhorn ablation)"
            return functools.partial(match_random, shard_size=max(cfg.batch_size, 1))
        match = match_single_batch if cfg.single_batch else match_two_batch
        kernel = "CUDA kernel" if cfg.use_pallas and self.device.type == "cuda" else "plain"
        self.matcher_desc = (
            f"{'single' if cfg.single_batch else 'two'}-batch on one device "
            f"(Sinkhorn: {kernel})"
        )
        return functools.partial(
            match,
            lam=cfg.sinkhorn_lambda,
            n_iters=cfg.nr_sinkhorn_iter,
            cost_fn=self.cost_fn,
            use_pallas=cfg.use_pallas,
            tol=cfg.sinkhorn_tol,
            precision=self.matching_precision,
        )

    def _make_parallel_matcher(self):
        """The JAX engine's multi-device dispatch (``otgan_tpu/engine.py``
        ``_make_matcher``); its ``matcher_desc`` strings, letter for letter."""
        cfg = self.cfg
        self.matcher_desc = "global (GSPMD-partitioned)"
        if cfg.no_sinkhorn:
            self.matcher_desc = "random (--no_sinkhorn ablation)"
            shard = max(cfg.batch_size // self.world, 1)
            return self._gathered(functools.partial(match_random, shard_size=shard))
        if cfg.sharded_matching:
            if cfg.matching_layout == "auto":
                # the rule needs the critic's feature count: resolved in
                # init_state, or at the first match without it
                self.matcher_desc = "auto (layout resolves on the critic feature dim)"
                self._auto_matchers: dict = {}

                def auto_matcher(f_a, f_b):
                    return self.resolve_auto_layout(int(f_a.shape[-1]))(f_a, f_b)

                return auto_matcher
            return self._build_layout_matcher(cfg.matching_layout)
        match = match_single_batch if cfg.single_batch else match_two_batch
        return self._gathered(functools.partial(
            match,
            lam=cfg.sinkhorn_lambda,
            n_iters=cfg.nr_sinkhorn_iter,
            cost_fn=self.cost_fn,
            use_pallas=cfg.use_pallas,
            tol=cfg.sinkhorn_tol,
            precision=self.matching_precision,
        ))

    def _gathered(self, match):
        """What GSPMD does with a global matcher on a sharded batch: gather
        the features, match globally, keep this rank's rows."""

        def matcher(f_a, f_b):
            m = match(all_gather_rows(f_a.detach(), self.group),
                      all_gather_rows(f_b.detach(), self.group))
            mine = [local_rows(t, self.rank, self.world) for t in m[:4]]
            return MatchedFeatures(*mine, m.entropy)

        return matcher

    def auto_layout_estimate(self, feature_dim: int) -> dict:
        """Per-rank extra memory of the matrix-parallel layout: the float32
        ``(4, B, d)`` accumulator, the two gathered ``(B, d)`` feature
        copies and this rank's whole cost matrices. The row-sharded layout
        gathers the features too but holds ``1/K`` of the outputs and row
        blocks of the matrices; the accumulator decides."""
        cfg = self.cfg
        B, d = cfg.batch_size, feature_dim
        n_mats = 3 if cfg.single_batch else 6
        N = B if cfg.single_batch else B // 2
        rounds = max(1, -(-n_mats // self.world))
        return {
            "accumulator_bytes": 4 * B * d * 4,
            "gathered_bytes": 2 * B * d * 4,
            "matrices_bytes": rounds * N * N * 4,
        }

    def resolve_auto_layout(self, feature_dim: int):
        """``--matching_layout auto``: matrices when the estimate fits
        ``--matching_memory_budget_gb``, rows otherwise (cached per feature
        count)."""
        cached = self._auto_matchers.get(feature_dim)
        if cached is not None:
            return cached
        need = sum(self.auto_layout_estimate(feature_dim).values())
        budget = self.cfg.matching_memory_budget_gb * 1e9
        layout = "matrices" if need <= budget else "rows"
        matcher = self._build_layout_matcher(layout)
        self.matcher_desc += (
            f" [auto: estimated {need / 1e9:.2f} GB matrix-parallel "
            f"residency vs {self.cfg.matching_memory_budget_gb:.1f} GB "
            f"budget -> {layout}]"
        )
        self._auto_matchers[feature_dim] = matcher
        return matcher

    def _build_layout_matcher(self, layout: str):
        cfg = self.cfg
        n_dev = self.world
        kind = "single" if cfg.single_batch else "two"
        if layout == "matrices":
            from otgan_tpu_torch.parallel.matching_matrix import (
                make_matrix_parallel_single_batch_matcher,
                make_matrix_parallel_two_batch_matcher,
            )

            self.matcher_desc = (
                f"matrix-parallel ({kind}-batch, whole matrices "
                f"round-robined over the {n_dev}-device mesh)"
            )
            make = (
                make_matrix_parallel_single_batch_matcher
                if cfg.single_batch
                else make_matrix_parallel_two_batch_matcher
            )
        else:
            from otgan_tpu_torch.parallel.matching_sharded import (
                make_sharded_single_batch_matcher,
                make_sharded_two_batch_matcher,
            )

            quantum = n_dev if cfg.single_batch else 2 * n_dev
            if cfg.batch_size % quantum != 0:
                n_half = cfg.batch_size if cfg.single_batch else cfg.batch_size // 2
                pad = -n_half % n_dev
                if cfg.single_batch:
                    self.matcher_desc = (
                        f"row-sharded (single-batch, padded rows: "
                        f"+{pad} pad rows on the {n_dev}-device mesh)"
                    )
                else:
                    self.matcher_desc = (
                        f"row-sharded (two-batch, padded halves: "
                        f"+{pad} pad rows per half on the "
                        f"{n_dev}-device mesh)"
                    )
            else:
                self.matcher_desc = (
                    f"row-sharded ({kind}-batch, whole local halves "
                    f"on the {n_dev}-device mesh)"
                )
            make = (
                make_sharded_single_batch_matcher
                if cfg.single_batch
                else make_sharded_two_batch_matcher
            )
        return make(
            self.group,
            cfg.sinkhorn_lambda,
            cfg.nr_sinkhorn_iter,
            cost_fn=self.cost_fn,
            tol=cfg.sinkhorn_tol,
            use_pallas=cfg.use_pallas,
            precision=self.matching_precision,
        )

    def _local_latent(self, z):
        """This rank's rows of global latents (of each tensor of a tuple)."""
        if self.world == 1:
            return z
        return map_latent(lambda t: local_rows(t, self.rank, self.world), z)

    def _local_data(self, x):
        """This rank's rows of this process's batch (the global batch
        without ``--multihost``)."""
        if self.local_world == 1:
            return x
        return local_rows(x, self.local_index, self.local_world)

    def _distance(self, f_a, f_b, m: MatchedFeatures) -> torch.Tensor:
        if self.world == 1:
            return calc_distance(f_a, f_b, m)
        nd = torch.stack([torch.sum(f_a * m.a_a), torch.sum(f_b * m.b_b),
                          torch.sum(f_a * m.a_b)]).float()
        dist.all_reduce(nd, group=self.group)
        return (nd[1] + nd[0] - 2.0 * nd[2]) / (2.0 * f_a.shape[0] * self.world)

    def _sum_grads(self, grads):
        if self.world > 1:
            all_reduce_sum(grads, self.group)
        return grads

    def _build_models(self):
        opts = dict(self.cfg.model_opts(), compute_dtype=self.compute_dtype)
        return self.family.make_generator(**opts), self.family.make_discriminator(**opts)

    def latents(self, batch: int, generator: Optional[torch.Generator] = None):
        """``batch`` of the family's latents on the device, from ``generator``
        (a tensor; the DenseNet's: a tuple of four)."""
        return self.family.sample_latent(batch, generator, self.device, **self.cfg.model_opts())

    # -- init (the data-dependent init really runs) --
    def init_state(self, seed: int, x_init) -> Tuple[TrainState, int]:
        """Random V from ``seed``, then g and b from the batch ``x_init``
        (uint8 or float NHWC images, or toy points) and as many latents.
        The toy takes no data-dependent init (``otgan_tpu/engine.py:309``):
        its plain layers keep their He-scale V and zero b. Returns the state
        and the critic's feature count. Several ranks each run it on the
        whole batch, then take rank 0's parameters; ``init_spread`` is how
        far any rank's own init was from them (0.0 when the ranks agreed)."""
        cpu_rng = torch.Generator().manual_seed(seed)
        gen, disc = self._build_models()
        reset_parameters(disc, cpu_rng)
        reset_parameters(gen, cpu_rng)
        gen.to(self.device)
        disc.to(self.device)
        x = _as_tensor(x_init).to(self.device)
        if self.pcount > 1:
            # the processes' init batches, in process order: the global one
            x = all_gather_rows(self._local_data(x), self.group)
        x = self.ingest(x)
        if self.cfg.data_dependent_init and self.cfg.model != "toy_mlp":
            f = data_init(disc, x)
            z = self.family.sample_latent(x.shape[0], cpu_rng, **self.cfg.model_opts())
            data_init(gen, map_latent(lambda t: t.to(self.device), z))
        else:
            with torch.no_grad():
                f = disc(x)
        self.init_spread = 0.0
        if self.world > 1:
            # every rank ran the same init on the whole batch; rank 0's
            # parameters win, and init_spread records how far the others were
            params = [*gen.parameters(), *disc.parameters()]
            self.init_spread = replicate(params, self.group)
        if hasattr(self, "_auto_matchers"):
            # --matching_layout auto, now that the feature count is known
            self.resolve_auto_layout(int(f.shape[-1]))
        gen_params = dict(gen.named_parameters())
        disc_params = dict(disc.named_parameters())
        state = TrainState(
            gen=gen,
            disc=disc,
            gen_ema=ema_init(gen_params),
            gen_opt=self.opt_init({k: p.detach() for k, p in gen_params.items()}),
            disc_opt=self.opt_init({k: p.detach() for k, p in disc_params.items()}),
            step=0,
            rng=torch.Generator(device=self.device).manual_seed(seed + 1),
        )
        return state, int(f.shape[-1])

    def ingest(self, x) -> torch.Tensor:
        """A batch to the device in the compute dtype: uint8 ``[0, 255]``
        images cross as bytes and become ``x / 127.5 - 1`` (f32, then
        rounded once to the compute dtype) on the device; float images and
        toy points are cast, as the JAX package casts them at placement."""
        x = _as_tensor(x).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        return x.to(self.compute_dtype)

    def _latent(self, state: TrainState, batch: int, z):
        if z is None:
            return self.latents(batch, state.rng)
        return map_latent(lambda t: _as_tensor(t).to(self.device, torch.float32), z)

    def _microbatches(self, n: int) -> List[slice]:
        """``cfg.grad_accum`` row slices of ``n`` local rows."""
        m = self.cfg.grad_accum
        bounds = [n * i // m for i in range(m + 1)]
        return [slice(a, b) for a, b in zip(bounds, bounds[1:])]

    def _check_finite(self, step: int, **quantities) -> None:
        """``--debug_nans``: raise at the first non-finite quantity, in the
        order given (each a tensor or a list of tensors). Under a cycle's
        capture each flag is recorded instead, for the host to read after
        each replay (``cycle_graph.py``)."""
        for name, value in quantities.items():
            ts = value if isinstance(value, (list, tuple)) else [value]
            ok = torch.stack([torch.isfinite(t).all() for t in ts]).all()
            if self.deferred_checks is not None:
                self.deferred_checks.append((step, name, ok))
            elif not bool(ok):
                raise FloatingPointError(
                    f"--debug_nans: non-finite {name} at step {step} (0-based)")

    def _finish(self, state: TrainState, kind: str, grads, loss, distance, m) -> StepMetrics:
        """Check (``--debug_nans``), then the optimizer step of ``kind``:
        descent for the generator with its EMA, ascent for the critic
        (``train.py:143``)."""
        cfg = self.cfg
        if cfg.debug_nans:
            self._check_finite(state.step, loss=loss, gradient=list(grads), dist=distance,
                               entropy=m.entropy)
        module = state.gen if kind == "gen" else state.disc
        params = dict(module.named_parameters())
        with record_function("update"):
            if kind == "gen":
                self.opt_update(params, dict(zip(params, grads)), state.gen_opt,
                                cfg.learning_rate_gen)
                ema_update(state.gen_ema, params, cfg.ema_decay)
            else:
                self.opt_update(params, dict(zip(params, grads)), state.disc_opt,
                                -cfg.learning_rate_disc)
        state.step += 1
        return StepMetrics(dist=distance, entropy=m.entropy)

    # -- generator update (train.py:108-113 descent; EMA at :223) --
    def gen_step(self, state: TrainState, x_data, z=None) -> Tuple[TrainState, StepMetrics]:
        """One generator step on this process's batch ``x_data`` (the global
        batch without ``--multihost``) and the global latents ``z``, else
        drawn at the global batch: each rank keeps its rows."""
        with record_function("gen_step"):
            z = self._local_latent(self._latent(state, len(x_data) * self.pcount, z))
            x = self._local_data(x_data)
            grad_fn = self._gen_grads_accum if self.cfg.grad_accum > 1 else self._gen_grads
            grads, loss, distance, m = grad_fn(state, x, z)
            return state, self._finish(state, "gen", grads, loss, distance, m)

    def _gen_grads(self, state: TrainState, x, z):
        params = list(state.gen.parameters())
        # the critic stays frozen through the backward pass too: under
        # --remat its segments recompute there and must record what the
        # frozen forward recorded
        with _frozen(state.disc):
            with record_function("features"):
                with torch.no_grad():
                    f_dat = state.disc(self.ingest(x))
                f_gen = state.disc(state.gen(z))
            with record_function("match"):
                m = self._matcher(f_gen, f_dat)
                distance = self._distance(f_gen.detach(), f_dat, m)
            with record_function("loss_backward"):
                loss = med_generator_loss(f_gen, m)
                grads = self._sum_grads(torch.autograd.grad(loss, params))
        return grads, loss.detach(), distance, m

    def _gen_grads_accum(self, state: TrainState, x, z):
        """``_gen_step_accum`` (``otgan_tpu/engine.py:432-487``)."""
        params = list(state.gen.parameters())
        mbs = self._microbatches(len(x))
        x = _as_tensor(x).to(self.device, non_blocking=True)  # stays uint8 here
        with record_function("features"), torch.no_grad():
            f_gen, f_dat = [], []
            for sl in mbs:
                with record_function("microbatch"):
                    f_gen.append(state.disc(state.gen(map_latent(lambda t: t[sl], z))))
                    f_dat.append(state.disc(self.ingest(x[sl])))
            f_gen, f_dat = torch.cat(f_gen), torch.cat(f_dat)
        with record_function("match"):
            m = self._matcher(f_gen, f_dat)
            distance = self._distance(f_gen, f_dat, m)
        del f_gen, f_dat
        grads, loss = None, 0.0
        with record_function("loss_backward"):
            for sl in mbs:
                with record_function("microbatch"), _frozen(state.disc):
                    f = state.disc(state.gen(map_latent(lambda t: t[sl], z)))
                    mb_loss = med_generator_loss(f, _rows(m, sl))
                    g = torch.autograd.grad(mb_loss, params)
                    grads = _accumulate(grads, g)
                    loss = loss + mb_loss.detach()
            grads = self._sum_grads(grads)
        return grads, loss, distance, m

    # -- critic update: ascent via negative lr (train.py:115-130,143) --
    def disc_step(self, state: TrainState, x_data, z=None) -> Tuple[TrainState, StepMetrics]:
        """One critic step, with the batches of :meth:`gen_step`."""
        with record_function("disc_step"):
            z = self._local_latent(self._latent(state, len(x_data) * self.pcount, z))
            x = self._local_data(x_data)
            grad_fn = self._disc_grads_accum if self.cfg.grad_accum > 1 else self._disc_grads
            grads, loss, distance, m = grad_fn(state, x, z)
            return state, self._finish(state, "disc", grads, loss, distance, m)

    def _disc_grads(self, state: TrainState, x, z):
        params = list(state.disc.parameters())
        with record_function("features"):
            x_fake = self.sample(state, z, ema=self.cfg.train_disc_against_ema)
            f_fake = state.disc(x_fake)
            f_dat = state.disc(self.ingest(x))
        with record_function("match"):
            m = self._matcher(f_fake, f_dat)
            distance = self._distance(f_fake.detach(), f_dat.detach(), m)
        with record_function("loss_backward"):
            loss = med_discriminator_loss(f_fake, f_dat, m)
            grads = self._sum_grads(torch.autograd.grad(loss, params))
        return grads, loss.detach(), distance, m

    def _disc_grads_accum(self, state: TrainState, x, z):
        """``_disc_step_accum`` (``otgan_tpu/engine.py:489-542``): the fake
        images are kept from the first pass, so the second runs no
        generator."""
        params = list(state.disc.parameters())
        mbs = self._microbatches(len(x))
        x = _as_tensor(x).to(self.device, non_blocking=True)
        with record_function("features"), torch.no_grad():
            x_fake, f_fake, f_dat = [], [], []
            for sl in mbs:
                with record_function("microbatch"):
                    x_fake.append(self.sample(state, map_latent(lambda t: t[sl], z),
                                              ema=self.cfg.train_disc_against_ema))
                    f_fake.append(state.disc(x_fake[-1]))
                    f_dat.append(state.disc(self.ingest(x[sl])))
            f_fake, f_dat = torch.cat(f_fake), torch.cat(f_dat)
        with record_function("match"):
            m = self._matcher(f_fake, f_dat)
            distance = self._distance(f_fake, f_dat, m)
        del f_fake, f_dat
        grads, loss = None, 0.0
        with record_function("loss_backward"):
            for sl, xf in zip(mbs, x_fake):
                with record_function("microbatch"):
                    mb_loss = med_discriminator_loss(state.disc(xf),
                                                     state.disc(self.ingest(x[sl])), _rows(m, sl))
                    g = torch.autograd.grad(mb_loss, params)
                    grads = _accumulate(grads, g)
                    loss = loss + mb_loss.detach()
            grads = self._sum_grads(grads)
        return grads, loss, distance, m

    def is_disc_step(self, step: int) -> bool:
        """1 critic step per ``nr_gen_per_disc`` generator steps
        (train.py:213-226), unless the critic is frozen."""
        freeze = self.cfg.disc_freeze_after_steps
        return step % (self.cfg.nr_gen_per_disc + 1) == 0 and (
            freeze <= 0 or step < freeze
        )

    def cycle(self, state: TrainState, xs: Sequence,
              zs: Optional[Sequence] = None) -> Tuple[TrainState, List[StepMetrics]]:
        """Consecutive steps on the batches ``xs`` under the G:D schedule."""
        mets = []
        for i, x in enumerate(xs):
            z = None if zs is None else zs[i]
            step = self.disc_step if self.is_disc_step(state.step) else self.gen_step
            state, met = step(state, x, z)
            mets.append(met)
        return state, mets

    def _kinds_ahead(self, step: int) -> set:
        """The kinds of step (``is_disc_step``) the schedule can still take
        from ``step`` on."""
        freeze = self.cfg.disc_freeze_after_steps
        disc = freeze <= 0 or step < freeze
        gen = self.cfg.nr_gen_per_disc > 0 or freeze > 0
        return {k for k, on in ((True, disc), (False, gen)) if on}

    def cycle_step(self, state: TrainState, xs: Sequence) -> Tuple[TrainState, List[StepMetrics]]:
        """The steps on the batches ``xs`` (``otgan_tpu/engine.py:544-566``).
        Under ``--fused_cycle`` on the card, calls run eagerly until each
        kind of step still to come has run once; after that every call, a
        full cycle or an epoch's leftover, replays the CUDA graph of its
        schedule, captured at its first call (``cycle_graph.py``). All the
        graphs share the first one's memory pool: replays never overlap, so
        the pool holds one cycle's temporaries, and no eager step runs beside
        it. Under a graph ``--debug_nans`` raises after the replay, so the
        state is then past the whole cycle, the bad step's update included;
        the eager path raises before that update. Not fused, the steps run
        one by one."""
        if not self.cycle_graphs:
            return self.cycle(state, xs)
        xs = [_as_tensor(x).to(self.device, non_blocking=True) for x in xs]
        schedule = tuple(self.is_disc_step(state.step + i) for i in range(len(xs)))
        if not self._kinds_ahead(state.step) <= self._eager_kinds:
            state, mets = self.cycle(state, xs)
            self._eager_kinds |= set(schedule)
            if self._kinds_ahead(state.step) <= self._eager_kinds and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()  # the graphs' pool takes what the eager cycles held
            return state, mets
        graph = self._graphs.get(schedule)
        if graph is None:
            torch.cuda.empty_cache()  # what an epoch's end (samples, eval) left cached
            graph = CycleGraph(self, state, xs, self.graph_factory, self._graph_pool)
            self._graphs[schedule], self._graph_pool = graph, graph.pool
        return graph.replay(state, xs)

    # -- sampling (train.py:72-75, x_gens / x_gens_ema) --
    @torch.no_grad()
    def sample(self, state: TrainState, z, ema: bool = False) -> torch.Tensor:
        """Samples (images, or toy points) from latents ``z``, or from ``z``
        fresh draws of the state's generator when ``z`` is an int; with
        ``ema`` the EMA weights generate."""
        if isinstance(z, int):
            z = self.latents(z, state.rng)
        else:
            z = self._latent(state, 0, z)
        if ema:
            return functional_call(state.gen, state.gen_ema, (z,))
        return state.gen(z)


def _rows(m: MatchedFeatures, sl: slice) -> MatchedFeatures:
    """The matched features of the rows ``sl``."""
    return MatchedFeatures(*(t[sl] for t in m[:4]), m.entropy)


def _accumulate(acc, grads):
    if acc is None:
        return list(grads)
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc
