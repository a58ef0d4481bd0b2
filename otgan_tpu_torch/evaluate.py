"""Evaluation CLI (counterpart of ``otgan_tpu/evaluate.py``): the Inception
score and FID of a checkpoint.

``python -m otgan_tpu_torch.evaluate --save_dir D [--checkpoint P] [--ema]
[--num_samples 50000] [--splits 10] [--fid_stats_path S | --data_dir C]
[--device cpu]`` rebuilds the run's configuration from ``D/config.json``,
restores the latest (or the named) checkpoint, the port's (npz, or a DCP
step directory ``orbax/<step>``) or the JAX package's npz, generates ``--num_samples`` images (``sample.generate``) and
prints one JSON line: the Inception score (the reference protocol: 50 000
samples, 10 splits, ``train.py:245-273``) and, with reference statistics
(``--fid_stats_path``, from ``python -m otgan_tpu_torch.eval.fid``) or the
CIFAR-10 training set (``--data_dir``), the FID of the first
``--fid_samples`` images. Scoring runs in float32 on the card unless asked
for the CPU; the classifier weights are ``OTGAN_INCEPTION_WEIGHTS``'s.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from otgan_tpu_torch.eval import fid as fid_mod
from otgan_tpu_torch.eval import inception as inc
from otgan_tpu_torch.sample import build_run_config, generate
from otgan_tpu_torch.utils.checkpoint import latest_checkpoint


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description="OT-GAN evaluation (PyTorch)")
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--model", default=None)
    ap.add_argument("--nonlinearity", default=None)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--num_samples", type=int, default=50000)
    ap.add_argument("--splits", type=int, default=10)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_dir", default="", help="real data for FID (optional)")
    ap.add_argument("--fid_stats_path", default="",
                    help="precomputed real-data statistics (.npz from "
                    "`python -m otgan_tpu_torch.eval.fid`): FID without the raw data")
    ap.add_argument("--fid_samples", type=int, default=10000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)

    cfg = build_run_config(args)
    ckpt = args.checkpoint or latest_checkpoint(args.save_dir)
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint found in {args.save_dir}")
    net = inc.load_net(device=args.device)  # before generating: fails fast without weights
    x = generate(cfg, ckpt, args.num_samples, ema=args.ema, seed=args.seed, device=args.device)
    x255 = 127.5 * (x + 1.0)  # [0, 255] (train.py:260-261)

    is_mean, is_std = inc.get_inception_score(x255, splits=args.splits, net=net)
    result = {
        "checkpoint": ckpt,
        "ema": args.ema,
        "num_samples": int(x255.shape[0]),
        "inception_score": round(float(is_mean), 4),
        "inception_std": round(float(is_std), 4),
    }
    if args.fid_stats_path:
        mu_ref, sigma_ref = fid_mod.load_reference_statistics(args.fid_stats_path,
                                                              expect_variant=net.variant)
        mu, sigma = fid_mod.feature_statistics(
            fid_mod.pool_features(x255[:args.fid_samples], net=net))
        result["fid"] = round(float(fid_mod.frechet_distance(mu, sigma, mu_ref, sigma_ref)), 4)
    elif args.data_dir:
        from otgan_tpu_torch.data.cifar10 import load

        real, _ = load(os.path.join(args.data_dir, "cifar-10-python"), "train")
        real = np.transpose(real[:args.fid_samples], (0, 2, 3, 1))
        result["fid"] = round(float(fid_mod.get_fid(x255[:args.fid_samples], real, net=net)), 4)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
