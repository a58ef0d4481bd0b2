"""Training CLI (counterpart of ``otgan_tpu/train.py``).

``python -m otgan_tpu_torch.train [--device cpu] --flags`` takes every flag
of the JAX package's trainer (``config.py``). It initialises the models
(data-dependent init on the first batch; none for the toy), then runs
epochs under the reference's G:D schedule (``train.py:196-231``): shuffled
CIFAR-10 (or synthetic) batches, or for ``--model toy_mlp`` fresh
8-Gaussians batches, 78 a epoch (``OTGAN_TOY_EPOCH_BATCHES`` overrides).
Under ``--fused_cycle`` (the default) it takes the batches a G:D cycle at
a time, an epoch's leftover as one group (``otgan_tpu/train.py:400-470``):
on the card, on one rank or each of K, once each kind of step has run
eagerly, every group runs as a replay of the CUDA graph of its schedule
(``engine.py::cycle_step``);
``config.json`` and the first record of ``metrics.jsonl`` say whether it
took effect (``fused_cycle_effective``) and if not why
(``fused_cycle_reason``). A capture that runs out of device memory turns
it off for the rest of the run: the next record (echoed) says
``fused_cycle_effective=False`` and the reason.
It logs JSONL metrics to ``save_dir/metrics.jsonl``: per epoch the mean
generator and critic distances and entropy, and with ``--log_every_steps
N`` every N-th step's dist, entropy and ``step_ms``: the wall time of the
group that took the step, from its batches' arrival to the readback of its
logged metrics, over the group's steps. So a fused cycle's steps share one
value, with one readback a cycle, while an unfused step is a group of its
own and reads back alone; per epoch the
launches of each Sinkhorn kernel and of its plain version since the first
step (``launches``, this rank's), the calls that replayed a cycle's graph
(``cycle_replays``), and on the card the process's peak
device memory allocated and reserved so far (``peak_allocated_gb``,
``peak_reserved_gb``).

After each epoch it writes 100 samples of the generator and of its EMA
(``sample<e>.png`` and ``ema_sample<e>.png`` grids for images,
``sample<e>.npy`` and ``ema_sample<e>.npy`` for toy points), drawn from
latents seeded by the epoch. ``--profile_dir D`` traces the epochs with
``torch.profiler`` into ``D/trace_rank<r>.json`` (``utils/tracing.py``), also
when the run raises; the loop names its parts with host spans
(``data_wait``, ``dispatch``, ``epoch_end`` and inside it ``readback``,
``samples``, ``eval``, ``checkpoint``), and each epoch's record carries the
device ms a step of each kind and phase from the engine's marks
(``device_ms``, read after the epoch's readback, so without a new wait);
``--debug_nans`` makes every step raise ``FloatingPointError`` at its first
non-finite loss, gradient, distance or entropy (``engine.py``). Every
``--save_every_epochs`` epochs (not the first epoch of a run) it writes the
full train state,
``otgan_state-<epoch>.npz`` (``utils/checkpoint.py``; retention, slot dtype
and background writes from the config), or under ``--checkpoint_backend
orbax`` the step directory ``orbax/<epoch>`` written by every rank with
``torch.distributed.checkpoint`` (``utils/checkpoint_orbax.py``), and
beside it ``distances.npz``,
the per-epoch mean distances of the run (an epoch without a step of one
kind logs that kind's last mean with ``dist_*_carried``). ``--load_params``
resumes from ``--model_name`` or the latest checkpoint in ``--save_dir`` at the epoch
after it, and says which format it read: the port's, or the JAX package's
``otgan_state-<epoch>.npz`` (same name; ``utils/checkpoint.py`` tells them
apart by their keys), so a TPU run's directory resumes here, or a DCP step
directory; a JAX run's orbax step directory cannot be read without orbax
and raises, naming it. The data generator starts afresh from ``--seed``,
as in the JAX trainer.

Every ``--eval_every_epochs`` epochs (not the first epoch of a run, never
for the toy) it scores ``--inception_samples`` generated images
(``eval/``, weights at ``OTGAN_INCEPTION_WEIGHTS``; the event is skipped
with a message when they are missing), the raw generator then the EMA:
``inception_score`` / ``inception_std`` and, under ``--eval_fid``, ``fid``
against the real data's statistics, each with an ``ema_`` twin, then the
reference's running ``max_inception_score`` / ``max_inception_epoch``
over both (``train.py:245-273``). The statistics come from
``--fid_stats_path`` (``python -m otgan_tpu_torch.eval.fid``), else from
the training images once, cached to ``<save_dir>/fid_stats.npz``; a user's
``--fid_stats_path`` is never written. The JAX trainer's TPU memory
warnings (``otgan_tpu/train.py:240-280``) are not ported, their limits
being a TPU's.

Batches are assembled by the native library (``data/native.py``; numpy on a
host without ``g++``, as the first line says). ``--host_prefetch`` (the
default) assembles them ahead on the loader's producer thread and places
the next step's batch on the card from a worker thread while the current
step runs, also across an epoch's end (:func:`_prefetch_placed`): a copy
from pinned host memory on a side stream, which the step's stream waits
for. ``--no_host_prefetch`` assembles and places inline.

On K GPUs: ``torchrun --nproc_per_node K -m otgan_tpu_torch.train
--num_devices K ...``, one process per GPU (NCCL; gloo with ``--device
cpu``). Every rank reads the same global batches; only rank 0 writes
``config.json``, ``metrics.jsonl``, samples and npz checkpoints, runs the
eval events (on its replica of the state, so the scores are the
single-process ones; the other ranks wait at the next step's collective),
and prints. Every rank ends in a barrier, then leaves the process group.

Over several hosts (``--multihost``, ``otgan_tpu/train.py:51-122,
159-345``): ``torchrun --nnodes P --node_rank p --nproc_per_node K
--rdzv_endpoint host:port ... --multihost``, or without torchrun one
process a card with the JAX flags ``--coordinator_address host:port
--num_processes P --process_id p``. ``OTGAN_INIT_TIMEOUT`` seconds bound
the group's init and the first device query (``utils/init_watchdog.py``;
off by default). Each process (a node under torchrun) reads its own shard
of the data, rows ``p::P``, from a generator seeded ``(seed, p)``, at the
local batch ``B / P`` (synthetic data is drawn from a fresh ``seed``
generator on every process, then sharded; the toy draws its own batches);
its ranks keep their rows of it. Each process says ``process p/P (local
batch n)``. npz checkpoints switch to the sharded backend there, which
every rank writes; rank 0 still writes every other artifact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from otgan_tpu_torch.config import TrainConfig, build_parser, config_from_namespace
from otgan_tpu_torch.data.cifar10 import DataLoader, synthetic
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine, TrainState
from otgan_tpu_torch.eval import fid as fid_mod
from otgan_tpu_torch.eval import inception as inc
from otgan_tpu_torch.eval.inception_net import InceptionV3
from otgan_tpu_torch.nn import dense_boundary, layer_boundary
from otgan_tpu_torch.ops import (
    sinkhorn_cuda,
    sinkhorn_grid_cuda,
    sinkhorn_resident_cuda,
    sinkhorn_step_cuda,
)
from otgan_tpu_torch.parallel.mesh import init_from_env
from otgan_tpu_torch.utils import checkpoint_orbax, tracing
from otgan_tpu_torch.utils.checkpoint import (
    checkpoint_format,
    checkpoint_step,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_pending_saves,
)
from otgan_tpu_torch.utils.init_watchdog import arm as arm_watchdog
from otgan_tpu_torch.utils.metrics import MetricLogger
from otgan_tpu_torch.utils.plotting import img_tile, save_tile_img
from otgan_tpu_torch.utils.tracing import profiled, trace_path

SAMPLES_PER_EPOCH = 100


class TrainResult(NamedTuple):
    state: TrainState
    steps: List[dict]  # one record per step: step, kind, dist, entropy, step_ms


def make_loader(cfg: TrainConfig, rng: np.random.Generator, pid: int = 0,
                pcount: int = 1) -> DataLoader:
    """Process ``pid`` of ``pcount``'s loader (``otgan_tpu/train.py:282-338``):
    its shard of CIFAR-10 or of the synthetic set at the local batch
    ``B / pcount``. The synthetic set is drawn from ``rng`` in one process,
    else from a fresh ``seed`` generator (the same set on every process).
    ``--ingest_dtype compute`` emits the model's compute dtype (bfloat16, or
    float32 for anything else)."""
    dtype = cfg.compute_dtype if cfg.ingest_dtype == "compute" else cfg.ingest_dtype
    kw = dict(batch_size=cfg.batch_size // pcount, rng=rng, process_index=pid,
              process_count=pcount, prefetch=2 if cfg.host_prefetch else 0,
              out_dtype=dtype if dtype in ("uint8", "bfloat16") else "float32")
    if cfg.synthetic_data:
        synth_rng = rng if pcount == 1 else np.random.default_rng(cfg.seed)
        return DataLoader(cfg.data_dir, data=synthetic(synth_rng, cfg.synthetic_size), **kw)
    return DataLoader(cfg.data_dir, subset="train", **kw)


def _toy_epoch(rng: np.random.Generator, batch_size: int, n_batches: int = 78):
    """One notebook "epoch" of fresh 8-Gaussians batches (~40000 / 512)."""
    for _ in range(n_batches):
        yield sample_8gaussians(rng, batch_size)


def save_samples(engine: Engine, state: TrainState, path: str, seed: int, ema: bool) -> None:
    """100 samples from latents seeded by ``seed``: a PNG grid at ``path``
    for images, an ``.npy`` beside it for toy points."""
    z = engine.latents(SAMPLES_PER_EPOCH, torch.Generator(device=engine.device).manual_seed(seed))
    x = engine.sample(state, z, ema=ema).float().cpu().numpy()
    if x.ndim == 4:
        save_tile_img(img_tile(x, aspect_ratio=1.0, border_color=1.0, stretch=False), path)
    else:
        np.save(path.replace(".png", ".npy"), x)


def kernel_launches() -> dict:
    """The Sinkhorn kernels' launch counters, the layer-boundary kernels'
    (one a forward or backward crossing), the DenseNet's slab kernels' (one
    a slab write, gather or scatter), their plain versions', and the main
    path's counts (``tracing.counts``: microbatch passes, list inputs a conv
    concatenated)."""
    return {"col_potential": sinkhorn_cuda.launches["kernel"],
            "col_potential_plain": sinkhorn_cuda.launches["plain"],
            "resident": sinkhorn_resident_cuda.launches["kernel"],
            "resident_plain": sinkhorn_resident_cuda.launches["plain"],
            "grid": sinkhorn_grid_cuda.launches["kernel"],
            "grid_plain": sinkhorn_grid_cuda.launches["plain"],
            **{f"local_step_{k}": n for k, n in sinkhorn_step_cuda.launches.items()},
            "layer_boundary": layer_boundary.launches["kernel"],
            "layer_boundary_plain": layer_boundary.launches["plain"],
            "dense_boundary": dense_boundary.launches["kernel"],
            "dense_boundary_plain": dense_boundary.launches["plain"],
            **tracing.counts}


def _prefetch_placed(items: Iterable[Tuple[int, object]], place: Callable,
                     depth: int = 1) -> Iterator[Tuple[int, object]]:
    """Iterate ``(epoch, pending)`` items, yielding ``(epoch, place(pending))``,
    the placement of the NEXT item running on one worker thread while the
    caller consumes the current one (``otgan_tpu/train.py:51-102``). The
    pull comes before the yield, so while the caller does an epoch's end
    (metrics, samples, eval, checkpoint) the next epoch's first batch is
    being placed. Items whose payload is ``None`` (epoch ends) pass through
    unplaced. ``depth=0`` places inline (``--no_host_prefetch``). A worker's
    exception is raised at the consuming ``yield``."""
    if depth <= 0:
        for ep, pending in items:
            yield ep, (None if pending is None else place(pending))
        return
    it = iter(items)
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="host-prefetch")
    try:
        q: deque = deque()

        def pull() -> None:
            for ep, pending in it:
                q.append((ep, None if pending is None else ex.submit(place, pending)))
                return

        pull()
        while q:
            ep, fut = q.popleft()
            pull()  # submit the next placement before the caller blocks
            yield ep, (None if fut is None else fut.result())
    finally:
        ex.shutdown(wait=True)
        if hasattr(it, "close"):
            it.close()


class Placed(NamedTuple):
    """A batch on the card, copied on a side stream; :meth:`wait` hands it
    to the current stream."""

    x: torch.Tensor
    ready: torch.cuda.Event

    def wait(self) -> torch.Tensor:
        stream = torch.cuda.current_stream(self.x.device)
        stream.wait_event(self.ready)
        # the allocator must not reuse the memory before this stream is done
        self.x.record_stream(stream)
        return self.x


class HostToDevice:
    """``place`` of :func:`_prefetch_placed` on the card: a host batch is
    copied into one of ``SLOTS`` pinned buffers, then to ``device`` on a
    side stream. Runs on the worker thread, which must set its own device
    (the current device is a thread's own); a buffer is refilled only after
    its last copy finished."""

    SLOTS = 3  # one batch being filled, one in flight, one the step holds

    def __init__(self, device: torch.device):
        # the worker sets this device, so it needs its index ("cuda" alone
        # is the current device of the thread that reads it)
        self.device = torch.device("cuda", torch.cuda.current_device()
                                   if device.index is None else device.index)
        self.stream = torch.cuda.Stream(self.device)
        self.buffers: List[Optional[Tuple[torch.Tensor, torch.cuda.Event]]] = [None] * self.SLOTS
        self.count = 0

    def __call__(self, x) -> Placed:
        torch.cuda.set_device(self.device)
        src = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        slot = self.count % len(self.buffers)
        self.count += 1
        buf = None
        if self.buffers[slot] is not None:
            buf, done = self.buffers[slot]
            done.synchronize()
            if buf.shape != src.shape or buf.dtype != src.dtype:
                buf = None
        if buf is None:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        with torch.cuda.stream(self.stream):
            x_dev = buf.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self.buffers[slot] = (buf, ready)
        return Placed(x_dev, ready)


def maybe_init_distributed(cfg: TrainConfig, device="cuda") -> torch.device:
    """Join the run's process group (``otgan_tpu/train.py:105-122``):
    torchrun's when its environment is set; under ``--multihost`` without
    it, the manual launch's (``--coordinator_address``, ``--num_processes``,
    ``--process_id``). The group's init and the first device query run
    under the launch watchdog, ``OTGAN_INIT_TIMEOUT`` seconds (off by
    default). Returns this process's device."""
    watchdog = arm_watchdog(float(os.environ.get("OTGAN_INIT_TIMEOUT", "0")))
    try:
        manual = {}
        if cfg.multihost and "WORLD_SIZE" not in os.environ:
            if not cfg.coordinator_address:
                raise ValueError(
                    "--multihost needs torchrun's environment (torchrun --nnodes P ...) or "
                    "the manual flags --coordinator_address host:port --num_processes P "
                    "--process_id p")
            manual = dict(coordinator_address=cfg.coordinator_address,
                          num_processes=cfg.num_processes, process_id=cfg.process_id)
        dev = init_from_env(device, **manual)
        if dev.type == "cuda" and torch.cuda.is_available():
            torch.cuda.get_device_name(dev)  # the first query of the card
    finally:
        watchdog.disarm()
    return dev


class _NoLogger:
    """What ranks other than 0 log to."""

    def log(self, step: int, **values) -> None:
        pass

    def __enter__(self) -> "_NoLogger":
        return self

    def __exit__(self, *exc) -> None:
        pass


@dataclasses.dataclass
class EvalCache:
    """What a run's eval events share: the classifier, loaded at the first
    event on the run's device, and the FID reference statistics by path
    (None: FID is off for the run)."""

    net: Optional[InceptionV3] = None
    fid_stats: Dict[str, Optional[tuple]] = dataclasses.field(default_factory=dict)


def check_eval_flags(cfg: TrainConfig) -> None:
    """Fail at launch, not hours later at the first eval event."""
    if cfg.inception_batch < 0:
        raise ValueError(f"--inception_batch must be >= 1 (or 0 for the default), "
                         f"got {cfg.inception_batch}")
    if cfg.eval_fid and cfg.fid_stats_path and not os.path.exists(cfg.fid_stats_path):
        # a missing explicit path is almost always a typo: computing this
        # run's statistics and writing them THERE would mislabel later runs
        raise FileNotFoundError(
            f"--fid_stats_path {cfg.fid_stats_path} does not exist — precompute it with "
            "`python -m otgan_tpu_torch.eval.fid --data_dir ... --out ...`, or drop the "
            "flag to compute and cache statistics from this run's data under --save_dir")


def _fid_reference_stats(cfg: TrainConfig, loader, net: InceptionV3, cache: EvalCache):
    """(mu, sigma) of the real data for the FID, or None to skip FID this
    run. From ``--fid_stats_path`` (or the run's cached copy) when present,
    else computed once from the training images and cached to
    ``<save_dir>/fid_stats.npz``. A ``--fid_stats_path`` that exists but
    cannot be used (another weight variant, a foreign or broken archive)
    turns FID off with a message; it is never overwritten and never
    replaced by this run's statistics. Decided once per path and run."""
    user_path = bool(cfg.fid_stats_path)
    path = cfg.fid_stats_path or os.path.join(cfg.save_dir, "fid_stats.npz")
    if path in cache.fid_stats:
        return cache.fid_stats[path]
    if user_path and not os.path.exists(path):
        # launch validation rejects this; the file vanished during the run
        print(f"--fid_stats_path {path} no longer exists — FID disabled for this run "
              "(path left untouched)", flush=True)
        cache.fid_stats[path] = None
        return None
    stats = None
    if os.path.exists(path):
        try:
            stats = fid_mod.load_reference_statistics(path, expect_variant=net.variant)
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
            if user_path:
                print(f"cannot use --fid_stats_path {path}: {e!r} — FID disabled for this "
                      "run (file left untouched)", flush=True)
                cache.fid_stats[path] = None
                return None
            print(f"recomputing FID reference statistics: {e!r}", flush=True)
    if stats is None:
        imgs = loader.images_255()
        print(f"computing FID reference statistics over {imgs.shape[0]} real images",
              flush=True)
        stats = fid_mod.reference_statistics(imgs, net=net, batch=cfg.inception_batch or None)
        fid_mod.save_reference_statistics(path, stats[0], stats[1], net.variant, imgs.shape[0])
    cache.fid_stats[path] = stats
    return stats


def _maybe_inception_eval(cfg: TrainConfig, engine: Engine, state: TrainState, logger,
                          step: int, loader, cache: EvalCache) -> Optional[float]:
    """One eval event (``otgan_tpu/train.py:671-752``): the raw generator,
    then the EMA, each scored on ``--inception_samples`` images drawn in
    batches of ``--batch_size`` from latents seeded 10000, 10001, ...;
    logs the scores (and FIDs) and returns the better score, or None when
    there are no weights."""
    if cache.net is None:
        try:
            cache.net = inc.load_net(device=engine.device)
        except FileNotFoundError as e:
            print(f"inception weights unavailable, skipping eval: {e}", flush=True)
            return None
    net, batch = cache.net, cfg.inception_batch or None
    ref_stats = _fid_reference_stats(cfg, loader, net, cache) if cfg.eval_fid else None
    best = None
    for ema in (False, True):
        def sampler(seed, _ema=ema):
            gen = torch.Generator(device=engine.device).manual_seed(10_000 + seed)
            return engine.sample(state, engine.latents(cfg.batch_size, gen), ema=_ema)

        tag = "ema_" if ema else ""
        n, splits = cfg.inception_samples, cfg.inception_splits
        mu = sigma = None
        if ref_stats is not None and os.environ.get("OTGAN_EVAL_DEVICE_REDUCE", "1") == "0":
            # the host-float64 score protocol, pinned by the user: the
            # combined scorer reduces on the device, so two passes
            mean, std = inc.inception_score_from_sampler(sampler, n, splits, net=net,
                                                         batch=batch)
            mu, sigma = fid_mod.feature_statistics_from_sampler(sampler, n, net=net, batch=batch)
        elif ref_stats is not None:
            (mean, std), (mu, sigma) = fid_mod.combined_eval_from_sampler(
                sampler, n, splits, net=net, batch=batch)
        else:
            mean, std = inc.inception_score_from_sampler(sampler, n, splits, net=net, batch=batch)
        if mu is not None:
            fid_val = fid_mod.frechet_distance(mu, sigma, *ref_stats)
            logger.log(step, **{f"{tag}fid": fid_val})
            print(f"{'EMA ' if ema else ''}FID was {fid_val:.4f}", flush=True)
        logger.log(step, **{f"{tag}inception_score": mean, f"{tag}inception_std": std})
        print(f"{'EMA ' if ema else ''}inception score was {mean:.6f}, std was {std:.3f}",
              flush=True)
        best = mean if best is None else max(best, mean)
    return best


def train(cfg: TrainConfig, device=None) -> TrainResult:
    check_eval_flags(cfg)
    engine = Engine(cfg, device)  # rejects options without a port first
    rank0 = engine.rank == 0
    speaks = engine.local_index == 0  # prints for its process
    pid, pcount = engine.pid, engine.pcount
    if cfg.batch_size % pcount != 0:
        raise ValueError(f"global batch {cfg.batch_size} must be divisible by the process "
                         f"count {pcount}")
    local_batch = cfg.batch_size // pcount
    if pcount > 1 and cfg.checkpoint_backend != "orbax":
        # npz checkpoints go through one process; the sharded backend is the
        # several-host path
        if speaks:
            print("multihost run: switching checkpoint_backend npz -> orbax (per-process "
                  "shard writes)", flush=True)
        cfg = dataclasses.replace(cfg, checkpoint_backend="orbax")
    if rank0:
        os.makedirs(cfg.save_dir, exist_ok=True)
        # the flags, and what --fused_cycle did beside them (loaders of
        # either package ignore unknown keys)
        saved = dict(dataclasses.asdict(cfg), fused_cycle_effective=engine.fused_cycle,
                     fused_cycle_reason=engine.fused_cycle_reason)
        with open(os.path.join(cfg.save_dir, "config.json"), "w") as f:
            json.dump(saved, f, indent=2, sort_keys=True)
    data_rng = np.random.default_rng(cfg.seed if pcount == 1 else (cfg.seed, pid))
    is_toy = cfg.model == "toy_mlp"
    host_path = ""
    if is_toy:
        x_init = sample_8gaussians(data_rng, cfg.init_batch_size or local_batch)
        n_toy = int(os.environ.get("OTGAN_TOY_EPOCH_BATCHES", "78"))
    else:
        loader = make_loader(cfg, data_rng, pid, pcount)
        if loader.common_num_batches == 0:
            raise ValueError(f"{loader.data.shape[0]} examples make no batch of {local_batch}")
        x_init = loader.init_batch(cfg.init_batch_size or None)
        host_path = "; host batches: " + ("native" if loader.native_available() else "numpy")
    state, num_features = engine.init_state(cfg.seed, x_init)
    if speaks:
        accum = (f"; grad_accum: {cfg.grad_accum} microbatches of "
                 f"{cfg.batch_size // cfg.grad_accum}" if cfg.grad_accum > 1 else "")
        procs = f"; process {pid}/{pcount} (local batch {local_batch})" if pcount > 1 else ""
        print(
            f"device: {engine.device} ({engine.world} rank(s)); global batch: "
            f"{cfg.batch_size}; matcher: {engine.matcher_desc}{accum}{procs}{host_path}\n"
            f"model has a hidden representation with {num_features} features",
            flush=True,
        )
    start_epoch = 0
    if cfg.load_params:
        path = cfg.model_name or latest_checkpoint(cfg.save_dir)
        if path:
            fmt = checkpoint_format(path)
            restore_checkpoint(path, state)
            start_epoch = checkpoint_step(path) + 1
            if speaks:
                print(f"restored {path} ({fmt} checkpoint format); resuming at epoch "
                      f"{start_epoch}", flush=True)
        elif speaks:
            print("no checkpoint found; training from scratch", flush=True)

    # --fused_cycle groups the batches a cycle at a time (the JAX trainer's
    # grouping, otgan_tpu/train.py:400-470), an epoch's leftover as one
    # group; each group goes to the engine's graph of its schedule; a run
    # that is not fused takes one batch at a time
    group = engine.cycle_batches

    def work_items():
        """``(epoch, [host batches])`` per cycle (or step), then ``(epoch,
        None)`` at each epoch's end."""
        for epoch in range(start_epoch, cfg.max_epochs):
            batches = _toy_epoch(data_rng, local_batch, n_toy) if is_toy else loader.epoch()
            pending = []
            for x in batches:
                pending.append(x)
                if len(pending) == group:
                    yield epoch, pending
                    pending = []
            if pending:
                yield epoch, pending
            yield epoch, None

    on_card = engine.device.type == "cuda"
    place_one = HostToDevice(engine.device) if cfg.host_prefetch and on_card else (lambda x: x)

    def place(pending):
        return [place_one(x) for x in pending]

    steps: List[dict] = []
    stride = cfg.log_every_steps
    with MetricLogger(cfg.save_dir) if rank0 else _NoLogger() as logger, \
            profiled(cfg.profile_dir, engine.device, engine.rank):
        logger.log(state.step, matcher=engine.matcher_desc, init_spread=engine.init_spread,
                   fused_cycle_effective=engine.fused_cycle,
                   fused_cycle_reason=engine.fused_cycle_reason)
        launches0 = kernel_launches()
        fused_reason = engine.fused_cycle_reason
        mean_dist_gen: List[Optional[float]] = []
        mean_dist_disc: List[Optional[float]] = []
        # the reference's running max over raw and EMA scores (train.py:264-272)
        max_inception_score, max_inception_epoch = float("-inf"), -1
        eval_cache = EvalCache()
        start_time = begin = time.time()
        dist_gen, dist_disc, entropies = [], [], []
        marks0 = tracing.device_ms(engine.device)
        placed_items = _prefetch_placed(work_items(), place, depth=1 if cfg.host_prefetch else 0)
        try:
            while True:
                with record_function("data_wait"):
                    epoch, placed = next(placed_items, (None, None))
                    t0 = time.perf_counter()
                    if placed is not None:
                        xs = [p.wait() if isinstance(p, Placed) else p for p in placed]
                if epoch is None:
                    break
                if placed is not None:
                    start = state.step
                    kinds = [engine.is_disc_step(start + i) for i in range(len(xs))]
                    with record_function("dispatch"):
                        state, mets = engine.cycle_step(state, xs)
                    if engine.fused_cycle_reason != fused_reason:  # a capture ran out of memory
                        fused_reason = engine.fused_cycle_reason
                        logger.log(state.step, fused_cycle_effective=engine.fused_cycle,
                                   fused_cycle_reason=fused_reason)
                    for is_disc, met in zip(kinds, mets):
                        (dist_disc if is_disc else dist_gen).append(met.dist)
                        entropies.append(met.entropy)
                    logged = [i for i in range(len(xs)) if stride and (start + i + 1) % stride == 0]
                    if logged:
                        # waits; a cycle's steps share its wall time
                        with record_function("readback"):
                            vals = [(float(mets[i].dist), float(mets[i].entropy)) for i in logged]
                        step_ms = (time.perf_counter() - t0) * 1e3 / len(xs)
                        for i, (dist, ent) in zip(logged, vals):
                            rec = dict(step=start + i + 1, kind="disc" if kinds[i] else "gen",
                                       dist=dist, entropy=ent, step_ms=step_ms)
                            steps.append(rec)
                            logger.log(rec["step"], **{k: v for k, v in rec.items() if k != "step"})
                    continue
                # ---- the epoch's end ----
                with record_function("epoch_end"):
                    # an epoch with no step of a kind (short epochs under the 5:1
                    # schedule) carries that kind's last epoch mean, flagged;
                    # before the first such step the key is left out and the
                    # history holds None, which save_distances backfills
                    # (otgan_tpu/train.py:481-509)
                    vals = {}
                    with record_function("readback"):
                        for key, kind, hist in (("dist_gen", dist_gen, mean_dist_gen),
                                                ("dist_disc", dist_disc, mean_dist_disc)):
                            if kind:
                                vals[key] = float(torch.stack(kind).mean())
                            elif hist and hist[-1] is not None:
                                vals[key], vals[f"{key}_carried"] = hist[-1], True
                            hist.append(vals.get(key))
                        entropy = float(torch.stack(entropies).mean())
                        # the epoch's steps are done: reading their marks waits no longer
                        marks = tracing.device_ms(engine.device)
                    launches = {k: n - launches0[k] for k, n in kernel_launches().items()}
                    if on_card:  # the process's peaks so far
                        dev = engine.device
                        vals["peak_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                        vals["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
                    logger.log(state.step, epoch=epoch, epoch_time=time.time() - begin,
                               entropy=entropy, launches=launches, cycle_replays=engine.replays,
                               device_ms=tracing.per_step(marks, marks0), **vals)
                    marks0 = marks
                    if rank0:
                        # per-epoch samples, raw and EMA (train.py:233-243)
                        with record_function("samples"):
                            for prefix, ema in (("sample", False), ("ema_sample", True)):
                                save_samples(engine, state,
                                             os.path.join(cfg.save_dir, f"{prefix}{epoch}.png"),
                                             seed=epoch, ema=ema)
                    # periodic inception eval (train.py:245-273)
                    if rank0 and not is_toy and (epoch + 1) % cfg.eval_every_epochs == 0 \
                            and epoch != start_epoch:
                        with record_function("eval"):
                            best = _maybe_inception_eval(cfg, engine, state, logger, state.step,
                                                         loader, eval_cache)
                        if best is not None:
                            if best > max_inception_score:
                                max_inception_score, max_inception_epoch = best, epoch
                            print(f"max inception score was {max_inception_score:.6f}, iter was "
                                  f"{max_inception_epoch}", flush=True)
                            logger.log(state.step, max_inception_score=max_inception_score,
                                       max_inception_epoch=max_inception_epoch)
                    # periodic checkpoint (train.py:275-281): the sharded backend
                    # on every rank, npz on rank 0
                    if (epoch + 1) % cfg.save_every_epochs == 0 and epoch != start_epoch:
                        ckpt_kw = dict(slot_dtype=cfg.checkpoint_slot_dtype,
                                       async_write=cfg.async_checkpoint,
                                       max_to_keep=cfg.max_checkpoints_to_keep,
                                       keep_every_hours=cfg.keep_checkpoint_every_n_hours)
                        with record_function("checkpoint"):
                            if cfg.checkpoint_backend == "orbax":
                                path = checkpoint_orbax.save_checkpoint(cfg.save_dir, state,
                                                                        epoch, **ckpt_kw)
                            elif rank0:
                                path = save_checkpoint(cfg.save_dir, state, epoch, **ckpt_kw)
                        if rank0:
                            logger.save_distances(mean_dist_gen, mean_dist_disc)
                            print(f"saved {path}; elapsed hours "
                                  f"{(time.time() - start_time) / 3600:.3f}; total updates "
                                  f"{state.step}", flush=True)
                dist_gen, dist_disc, entropies = [], [], []
                begin = time.time()
        finally:
            placed_items.close()
    if cfg.profile_dir and rank0:
        print(f"wrote {trace_path(cfg.profile_dir, engine.rank)}", flush=True)
    # every checkpoint reported as saved is on disk before train() returns
    wait_for_pending_saves()
    # the engine may outlive this call in a reference cycle (the auto
    # layout's matcher holds it); its graphs must not, or the process group
    # cannot be destroyed
    engine.drop_graphs()
    return TrainResult(state, steps)


def main(argv: Optional[list] = None) -> TrainResult:
    raw = list(argv if argv is not None else sys.argv[1:])
    parser = build_parser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no silent fallback")
    ns = parser.parse_args(raw)
    cfg = config_from_namespace(ns, raw)
    joined = not dist.is_initialized()  # leave a caller's group alone
    device = maybe_init_distributed(cfg, ns.device)
    result = train(cfg, device)
    if joined and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
