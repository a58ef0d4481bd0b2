"""Training CLI (counterpart of ``otgan_tpu/train.py``).

``python -m otgan_tpu_torch.train [--device cpu] --flags`` takes every flag
of the JAX package's trainer (``config.py``). It initialises the models
(data-dependent init on the first batch; none for the toy), then runs
epochs under the reference's G:D schedule (``train.py:196-231``): shuffled
CIFAR-10 (or synthetic) batches, or for ``--model toy_mlp`` fresh
8-Gaussians batches, 78 a epoch (``OTGAN_TOY_EPOCH_BATCHES`` overrides).
It logs JSONL metrics to ``save_dir/metrics.jsonl``: per epoch the mean
generator and critic distances and entropy, and with ``--log_every_steps
N`` every N-th step's dist, entropy and wall time, and per epoch the
launches of each Sinkhorn kernel and of its plain version since the first
step (``launches``, this rank's).

After each epoch it writes 100 samples of the generator and of its EMA
(``sample<e>.png`` and ``ema_sample<e>.png`` grids for images,
``sample<e>.npy`` and ``ema_sample<e>.npy`` for toy points), drawn from
latents seeded by the epoch. ``--profile_dir D`` traces the epochs with
``torch.profiler`` into ``D/trace_rank<r>.json`` (``utils/tracing.py``), also
when the run raises; ``--debug_nans`` makes every step raise
``FloatingPointError`` at its first non-finite loss, gradient, distance or
entropy (``engine.py``). Every ``--save_every_epochs`` epochs (not the
first epoch of a run) it writes the full train state,
``otgan_state-<epoch>.npz`` (``utils/checkpoint.py``; retention, slot dtype
and background writes from the config), and beside it ``distances.npz``,
the per-epoch mean distances of the run (an epoch without a step of one
kind logs that kind's last mean with ``dist_*_carried``). ``--load_params``
resumes from ``--model_name`` or the latest checkpoint in ``--save_dir`` at the epoch
after it; the data generator starts afresh from ``--seed``, as in the JAX
trainer. Inception/FID eval and host prefetch come in later slices; the JAX
trainer's TPU memory warnings (``otgan_tpu/train.py:240-280``) are not
ported, their limits being a TPU's.

On K GPUs: ``torchrun --nproc_per_node K -m otgan_tpu_torch.train
--num_devices K ...``, one process per GPU (NCCL; gloo with ``--device
cpu``). Every rank reads the same global batches; only rank 0 writes
``config.json``, ``metrics.jsonl``, samples and checkpoints, and prints.
Every rank ends in a barrier, then leaves the process group.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from otgan_tpu_torch.config import TrainConfig, build_parser, config_from_namespace
from otgan_tpu_torch.data.cifar10 import DataLoader, synthetic
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine, TrainState
from otgan_tpu_torch.ops import (
    sinkhorn_cuda,
    sinkhorn_grid_cuda,
    sinkhorn_resident_cuda,
    sinkhorn_step_cuda,
)
from otgan_tpu_torch.parallel.mesh import init_from_env
from otgan_tpu_torch.utils.checkpoint import (
    checkpoint_step,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_pending_saves,
)
from otgan_tpu_torch.utils.metrics import MetricLogger
from otgan_tpu_torch.utils.plotting import img_tile, save_tile_img
from otgan_tpu_torch.utils.tracing import profiled, trace_path

SAMPLES_PER_EPOCH = 100


class TrainResult(NamedTuple):
    state: TrainState
    steps: List[dict]  # one record per step: step, kind, dist, entropy, step_ms


def make_loader(cfg: TrainConfig, rng: np.random.Generator) -> DataLoader:
    out_dtype = "uint8" if cfg.ingest_dtype == "uint8" else "float32"
    if cfg.synthetic_data:
        return DataLoader(cfg.data_dir, batch_size=cfg.batch_size, rng=rng,
                          data=synthetic(rng, cfg.synthetic_size), out_dtype=out_dtype)
    return DataLoader(cfg.data_dir, subset="train", batch_size=cfg.batch_size,
                      rng=rng, out_dtype=out_dtype)


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
    """The Sinkhorn kernels' launch counters, and their plain versions'."""
    return {"col_potential": sinkhorn_cuda.launches["kernel"],
            "col_potential_plain": sinkhorn_cuda.launches["plain"],
            "resident": sinkhorn_resident_cuda.launches["kernel"],
            "resident_plain": sinkhorn_resident_cuda.launches["plain"],
            "grid": sinkhorn_grid_cuda.launches["kernel"],
            "grid_plain": sinkhorn_grid_cuda.launches["plain"],
            **{f"local_step_{k}": n for k, n in sinkhorn_step_cuda.launches.items()}}


class _NoLogger:
    """What ranks other than 0 log to."""

    def log(self, step: int, **values) -> None:
        pass

    def __enter__(self) -> "_NoLogger":
        return self

    def __exit__(self, *exc) -> None:
        pass


def train(cfg: TrainConfig, device=None) -> TrainResult:
    engine = Engine(cfg, device)  # rejects options of later slices first
    rank0 = engine.rank == 0
    if rank0:
        os.makedirs(cfg.save_dir, exist_ok=True)
        cfg.save(os.path.join(cfg.save_dir, "config.json"))
    data_rng = np.random.default_rng(cfg.seed)
    is_toy = cfg.model == "toy_mlp"
    if is_toy:
        x_init = sample_8gaussians(data_rng, cfg.init_batch_size or cfg.batch_size)
        n_toy = int(os.environ.get("OTGAN_TOY_EPOCH_BATCHES", "78"))
    else:
        loader = make_loader(cfg, data_rng)
        if loader.num_batches == 0:
            raise ValueError(
                f"{loader.data.shape[0]} examples make no batch of {cfg.batch_size}"
            )
        x_init = loader.init_batch(cfg.init_batch_size or None)
    state, num_features = engine.init_state(cfg.seed, x_init)
    if rank0:
        accum = (f"; grad_accum: {cfg.grad_accum} microbatches of "
                 f"{cfg.batch_size // cfg.grad_accum}" if cfg.grad_accum > 1 else "")
        print(
            f"device: {engine.device} ({engine.world} rank(s)); global batch: "
            f"{cfg.batch_size}; matcher: {engine.matcher_desc}{accum}\n"
            f"model has a hidden representation with {num_features} features",
            flush=True,
        )
    start_epoch = 0
    if cfg.load_params:
        path = cfg.model_name or latest_checkpoint(cfg.save_dir)
        if path:
            restore_checkpoint(path, state)
            start_epoch = checkpoint_step(path) + 1
            if rank0:
                print(f"restored {path}; resuming at epoch {start_epoch}", flush=True)
        elif rank0:
            print("no checkpoint found; training from scratch", flush=True)
    steps: List[dict] = []
    stride = cfg.log_every_steps
    with MetricLogger(cfg.save_dir) if rank0 else _NoLogger() as logger, \
            profiled(cfg.profile_dir, engine.device, engine.rank):
        logger.log(state.step, matcher=engine.matcher_desc, init_spread=engine.init_spread)
        launches0 = kernel_launches()
        mean_dist_gen: List[Optional[float]] = []
        mean_dist_disc: List[Optional[float]] = []
        start_time = time.time()
        for epoch in range(start_epoch, cfg.max_epochs):
            begin = time.time()
            dist_gen, dist_disc, entropies = [], [], []
            batches = _toy_epoch(data_rng, cfg.batch_size, n_toy) if is_toy else loader.epoch()
            for x in batches:
                t0 = time.perf_counter()
                is_disc = engine.is_disc_step(state.step)
                step_fn = engine.disc_step if is_disc else engine.gen_step
                state, met = step_fn(state, x)
                (dist_disc if is_disc else dist_gen).append(met.dist)
                entropies.append(met.entropy)
                if stride and state.step % stride == 0:
                    dist, ent = float(met.dist), float(met.entropy)  # waits
                    rec = dict(step=state.step, kind="disc" if is_disc else "gen",
                               dist=dist, entropy=ent,
                               step_ms=(time.perf_counter() - t0) * 1e3)
                    steps.append(rec)
                    logger.log(state.step, **{k: v for k, v in rec.items() if k != "step"})
            # an epoch with no step of a kind (short epochs under the 5:1
            # schedule) carries that kind's last epoch mean, flagged; before
            # the first such step the key is left out and the history holds
            # None, which save_distances backfills (otgan_tpu/train.py:481-509)
            vals = {}
            for key, kind, hist in (("dist_gen", dist_gen, mean_dist_gen),
                                    ("dist_disc", dist_disc, mean_dist_disc)):
                if kind:
                    vals[key] = float(torch.stack(kind).mean())
                elif hist and hist[-1] is not None:
                    vals[key], vals[f"{key}_carried"] = hist[-1], True
                hist.append(vals.get(key))
            launches = {k: n - launches0[k] for k, n in kernel_launches().items()}
            logger.log(state.step, epoch=epoch, epoch_time=time.time() - begin,
                       entropy=float(torch.stack(entropies).mean()), launches=launches, **vals)
            if not rank0:
                continue
            # per-epoch samples, raw and EMA (train.py:233-243)
            for prefix, ema in (("sample", False), ("ema_sample", True)):
                save_samples(engine, state, os.path.join(cfg.save_dir, f"{prefix}{epoch}.png"),
                             seed=epoch, ema=ema)
            # periodic checkpoint (train.py:275-281)
            if (epoch + 1) % cfg.save_every_epochs == 0 and epoch != start_epoch:
                path = save_checkpoint(
                    cfg.save_dir, state, epoch, slot_dtype=cfg.checkpoint_slot_dtype,
                    async_write=cfg.async_checkpoint, max_to_keep=cfg.max_checkpoints_to_keep,
                    keep_every_hours=cfg.keep_checkpoint_every_n_hours)
                logger.save_distances(mean_dist_gen, mean_dist_disc)
                print(f"saved {path}; elapsed hours {(time.time() - start_time) / 3600:.3f}; "
                      f"total updates {state.step}", flush=True)
    if cfg.profile_dir and rank0:
        print(f"wrote {trace_path(cfg.profile_dir, engine.rank)}", flush=True)
    # every checkpoint reported as saved is on disk before train() returns
    wait_for_pending_saves()
    return TrainResult(state, steps)


def main(argv: Optional[list] = None) -> TrainResult:
    raw = list(argv if argv is not None else sys.argv[1:])
    parser = build_parser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no silent fallback")
    ns = parser.parse_args(raw)
    joined = not dist.is_initialized()  # leave a caller's group alone
    device = init_from_env(ns.device)
    result = train(config_from_namespace(ns, raw), device)
    if joined and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
