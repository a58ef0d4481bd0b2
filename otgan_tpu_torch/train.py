"""Training CLI (counterpart of ``otgan_tpu/train.py``).

``python -m otgan_tpu_torch.train [--device cpu] --flags`` takes every flag
of the JAX package's trainer (``config.py``). It initialises the models
(data-dependent init on the first batch), then runs epochs of shuffled
batches under the reference's G:D schedule (``train.py:196-231``), logging
JSONL metrics to ``save_dir/metrics.jsonl``: per epoch the mean generator
and critic distances and entropy, and with ``--log_every_steps N`` every
N-th step's dist, entropy and wall time, and per epoch the launches of
each Sinkhorn kernel and of its plain version since the first step
(``launches``, this rank's). Checkpoints, sample grids,
Inception/FID eval and host prefetch come in later slices.

On K GPUs: ``torchrun --nproc_per_node K -m otgan_tpu_torch.train
--num_devices K ...``, one process per GPU (NCCL; gloo with ``--device
cpu``). Every rank reads the same global batches; only rank 0 writes
``config.json`` and ``metrics.jsonl`` and prints. Every rank ends in a
barrier, then leaves the process group.
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
from otgan_tpu_torch.engine import Engine, TrainState
from otgan_tpu_torch.ops import sinkhorn_cuda, sinkhorn_step_cuda
from otgan_tpu_torch.parallel.mesh import init_from_env
from otgan_tpu_torch.utils.metrics import MetricLogger


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


def kernel_launches() -> dict:
    """The Sinkhorn kernels' launch counters, and their plain versions'."""
    return {"col_potential": sinkhorn_cuda.launches["kernel"],
            "col_potential_plain": sinkhorn_cuda.launches["plain"],
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
    loader = make_loader(cfg, data_rng)
    if loader.num_batches == 0:
        raise ValueError(
            f"{loader.data.shape[0]} examples make no batch of {cfg.batch_size}"
        )
    state, num_features = engine.init_state(
        cfg.seed, loader.init_batch(cfg.init_batch_size or None)
    )
    if rank0:
        print(
            f"device: {engine.device} ({engine.world} rank(s)); global batch: "
            f"{cfg.batch_size}; matcher: {engine.matcher_desc}\n"
            f"model has a hidden representation with {num_features} features",
            flush=True,
        )
    steps: List[dict] = []
    stride = cfg.log_every_steps
    with MetricLogger(cfg.save_dir) if rank0 else _NoLogger() as logger:
        logger.log(state.step, matcher=engine.matcher_desc, init_spread=engine.init_spread)
        launches0 = kernel_launches()
        for epoch in range(cfg.max_epochs):
            begin = time.time()
            dist_gen, dist_disc, entropies = [], [], []
            for x in loader.epoch():
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
            vals = {}
            if dist_gen:
                vals["dist_gen"] = float(torch.stack(dist_gen).mean())
            if dist_disc:
                vals["dist_disc"] = float(torch.stack(dist_disc).mean())
            launches = {k: n - launches0[k] for k, n in kernel_launches().items()}
            logger.log(state.step, epoch=epoch, epoch_time=time.time() - begin,
                       entropy=float(torch.stack(entropies).mean()), launches=launches, **vals)
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
