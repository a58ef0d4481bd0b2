"""Training CLI (counterpart of ``otgan_tpu/train.py``).

``python -m otgan_tpu_torch.train [--device cpu] --flags`` takes every flag
of the JAX package's trainer (``config.py``). It initialises the models
(data-dependent init on the first batch), then runs epochs of shuffled
batches under the reference's G:D schedule (``train.py:196-231``), logging
JSONL metrics to ``save_dir/metrics.jsonl``: per epoch the mean generator
and critic distances and entropy, and with ``--log_every_steps N`` every
N-th step's dist, entropy and wall time. Checkpoints, sample grids,
Inception/FID eval and host prefetch come in later slices.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from otgan_tpu_torch.config import TrainConfig, build_parser, config_from_namespace
from otgan_tpu_torch.data.cifar10 import DataLoader, synthetic
from otgan_tpu_torch.engine import Engine, TrainState
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


def train(cfg: TrainConfig, device=None) -> TrainResult:
    engine = Engine(cfg, device)  # rejects options of later slices first
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
    print(
        f"device: {engine.device}; global batch: {cfg.batch_size}; "
        f"matcher: {engine.matcher_desc}\n"
        f"model has a hidden representation with {num_features} features",
        flush=True,
    )
    steps: List[dict] = []
    stride = cfg.log_every_steps
    with MetricLogger(cfg.save_dir) as logger:
        logger.log(state.step, matcher=engine.matcher_desc)
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
            logger.log(state.step, epoch=epoch, epoch_time=time.time() - begin,
                       entropy=float(torch.stack(entropies).mean()), **vals)
    return TrainResult(state, steps)


def main(argv: Optional[list] = None) -> TrainResult:
    raw = list(argv if argv is not None else sys.argv[1:])
    parser = build_parser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no silent fallback")
    ns = parser.parse_args(raw)
    return train(config_from_namespace(ns, raw), ns.device)


if __name__ == "__main__":
    main()
