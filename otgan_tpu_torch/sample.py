"""Sampling CLI (counterpart of ``otgan_tpu/sample.py``): samples from a
trained checkpoint, the serving path of the reference trainer's inline
sampling blocks (``train.py:233-243``) on its own.

``python -m otgan_tpu_torch.sample --save_dir D [--checkpoint P] [--ema]
--num_samples N [--device cpu]`` rebuilds the run's configuration from
``D/config.json`` (the port's or the JAX package's: the fields are the
same), restores the latest (or the named) full-state checkpoint, written by
the port or by the JAX package (``utils/checkpoint.py`` reads both), and
writes ``samples.npz`` (key ``samples``) and, for images, a
``samples.png`` grid of the first 100. Latents come in batches of
``--batch_size``, batch i drawn from a generator seeded ``--seed + i``. It
runs on the card unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint
from otgan_tpu_torch.utils.plotting import img_tile, save_tile_img


def build_run_config(args) -> TrainConfig:
    """The run's TrainConfig from ``save_dir/config.json`` (written by the
    trainer), so the model matches the checkpoint; model flags passed
    explicitly override it."""
    overrides = dict(batch_size=args.batch_size)
    for name in ("model", "nonlinearity"):
        val = getattr(args, name, None)
        if val is not None:
            overrides[name] = val
    return TrainConfig.for_run(args.save_dir, **overrides)


@torch.no_grad()
def generate(cfg: TrainConfig, checkpoint: str, num_samples: int, ema: bool = False,
             seed: int = 0, device=None) -> np.ndarray:
    """``num_samples`` samples of the checkpoint's generator (or its EMA);
    ``checkpoint`` is a file of either package."""
    # the state is overwritten by the checkpoint: a one-process template
    # from a small batch, without the data-dependent init, is enough; the
    # run's microbatching, hosts, checkpoint backend and matching precision
    # are training options, not sampling ones
    engine = Engine(dataclasses.replace(cfg, data_dependent_init=False, num_devices=0,
                                        grad_accum=1, multihost=False,
                                        checkpoint_backend="npz",
                                        matching_precision="highest"), device)
    if cfg.model == "toy_mlp":
        x_init = sample_8gaussians(np.random.default_rng(0), 2)
    else:
        x_init = np.zeros((2, 32, 32, 3), np.uint8)
    state, _ = engine.init_state(cfg.seed, x_init)
    restore_checkpoint(checkpoint, state, rng=False)
    out, got = [], 0
    while got < num_samples:
        gen = torch.Generator(device=engine.device).manual_seed(seed + len(out))
        x = engine.sample(state, engine.latents(cfg.batch_size, gen), ema=ema)
        out.append(x.float().cpu().numpy())
        got += x.shape[0]
    return np.concatenate(out)[:num_samples]


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description="OT-GAN sampler (PyTorch)")
    ap.add_argument("--save_dir", required=True, help="training run directory")
    ap.add_argument("--checkpoint", default="", help="explicit checkpoint path")
    ap.add_argument("--model", default=None)
    ap.add_argument("--nonlinearity", default=None)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--num_samples", type=int, default=100)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="output prefix (default save_dir/samples)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)

    cfg = build_run_config(args)
    ckpt = args.checkpoint or latest_checkpoint(args.save_dir)
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint found in {args.save_dir}")
    x = generate(cfg, ckpt, args.num_samples, ema=args.ema, seed=args.seed,
                 device=args.device)
    prefix = args.out or os.path.join(args.save_dir, "samples")
    np.savez(prefix + ".npz", samples=x)
    if x.ndim == 4:  # images -> grid PNG
        save_tile_img(img_tile(x[:100], aspect_ratio=1.0, border_color=1.0), prefix + ".png")
        print(f"wrote {prefix}.png and {prefix}.npz ({x.shape[0]} samples)")
    else:
        print(f"wrote {prefix}.npz ({x.shape[0]} samples)")
    return x


if __name__ == "__main__":
    main()
