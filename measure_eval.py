#!/usr/bin/env python3
"""The trainer's eval event on one NVIDIA GPU, at the reference protocol:
``python3 measure_eval.py`` from the root of a checkout.

It prints the card's ``nvidia-smi`` name and power limit, then times one
full eval event of ``otgan_tpu_torch.train`` (``_maybe_inception_eval``):
50 000 samples of the raw generator and 50 000 of its EMA, the DCGAN at the
reference batch 5000 (``--preset train_py``; random weights with the
data-dependent init on 500 synthetic images), the Inception score in 10
splits, with the fixed-seed random InceptionV3 (tf2015, 1008 classes;
``eval/random_weights.py``). Once at inception batch 100 (the reference
protocol) and once at 500, then once at 500 under ``--eval_fid`` (the
one-pass scorer) against statistics of 10 000 synthetic images computed
first (timed apart). For each: seconds, img/s (100 000 images an event),
the peak device memory, and the bound: the InceptionV3 forward's float32
operations (counted from its conv and fc shapes) over the card's float32
peak outside the tensor cores (TF32 is off for scoring). Also the
generator's share: 2 x 50 000 samples drawn alone, and a profile of 2000
images scored at batch 500 (the device kernels with the most time, the
busy share), with the same pass timed under ``cudnn.benchmark`` off (the
default) and on. The last line is one JSON object of every number. It needs
a card; without one it exits 1.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import chip_smoke

SAMPLES = 50000
BATCH = 5000


def inception_flops(net) -> float:
    """float32 operations of one 299^2 image through ``net``: 2 per
    multiply-add of every conv and of the fc head (pools, BN and relu are
    not counted)."""
    import torch
    from otgan_tpu_torch.eval import inception as inc
    from otgan_tpu_torch.eval.inception_net import ConvBN

    macs = []

    def hook(mod, _inp, out):
        macs.append(mod.weight.numel() * out.shape[2] * out.shape[3])

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, ConvBN)]
    try:
        with inc.scoring_mode():
            net(torch.zeros((1, 299, 299, 3), device="cuda"))
    finally:
        for h in handles:
            h.remove()
    return 2.0 * (sum(macs) + net.fc.weight.numel())


def profile_scoring(net, engine, state, n: int = 2000, batch: int = 500) -> dict:
    """Where a scoring pass's time goes: ``n`` generated images (made
    before) through the device-reduced Inception score at classifier batch
    ``batch``, under ``torch.profiler``: wall time, the device kernels' time
    and busy share, and the kernels with the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from otgan_tpu_torch.eval import inception as inc

    gen = torch.Generator(device="cuda").manual_seed(0)
    imgs = [engine.sample(state, engine.latents(batch, gen)) for _ in range(n // batch)]

    def score():
        inc.inception_score_from_sampler(lambda s: imgs[s], n, 10, net=net, batch=batch)

    score()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    wall = {}
    for bench in (False, True, False):  # off, on, off: the spread shows in the two offs
        torch.backends.cudnn.benchmark = bench
        score()  # warm-up (and, with benchmark on, the algorithm search)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score()
        torch.cuda.synchronize()
        wall.setdefault(f"cudnn_benchmark_{'on' if bench else 'off'}_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
    return {"images": n, "batch": batch, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, **wall,
            "top_device": [{"name": k[:100], "ms": ms, "count": c} for k, ms, c in kernels[:12]]}


class _Log:
    def __init__(self):
        self.recs = {}

    def log(self, step, **kw):
        self.recs.update(kw)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("measure_eval: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    card = chip_smoke.card_line()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="measure_eval_")
    try:
        print(json.dumps(measure(card, tmp)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def measure(card: str, tmp: str) -> dict:
    """Every number of the script (see the module docstring); ``tmp`` holds
    the weights and statistics files."""
    import numpy as np
    import torch
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.config import parse_args
    from otgan_tpu_torch.data.cifar10 import synthetic
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.eval import fid as fid_mod
    from otgan_tpu_torch.eval import inception as inc
    from otgan_tpu_torch.eval import random_weights as rw

    _, (_, f32_peak) = chip_smoke.peaks(torch.cuda.get_device_name(0))
    os.environ["OTGAN_INCEPTION_WEIGHTS"] = rw.save_npz(
        os.path.join(tmp, "inception_random.npz"), seed=2024, variant="tf2015", num_classes=1008)
    net = inc.load_net(device="cuda")
    flops = inception_flops(net)
    print(f"InceptionV3 forward: {flops / 1e9:.3f} GFLOP an image (float32)", flush=True)

    rng = np.random.default_rng(1)
    cfg = parse_args(["--preset", "train_py", "--inception_samples", str(SAMPLES),
                      "--save_dir", tmp])
    engine = Engine(cfg, "cuda")
    state, _ = engine.init_state(cfg.seed, synthetic(rng, 500))

    def sample_all():
        for ema in (False, True):
            for seed in range(SAMPLES // BATCH):
                gen = torch.Generator(device="cuda").manual_seed(10_000 + seed)
                engine.sample(state, engine.latents(BATCH, gen), ema=ema)

    sample_all()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sample_all()
    torch.cuda.synchronize()
    out = {"card": card, "gflop_per_image": flops / 1e9, "generation_s": time.perf_counter() - t0,
           "generation_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"generation alone: 2 x {SAMPLES} samples at batch {BATCH} in "
          f"{out['generation_s']:.2f} s, peak {out['generation_peak_gb']:.2f} GB on {card}",
          flush=True)
    prof = out["profile"] = profile_scoring(net, engine, state)
    print(f"profiled scoring of {prof['images']} images at batch {prof['batch']}: "
          f"{prof['profiled_wall_ms']:.1f} ms wall, device kernels {prof['device_busy_ms']:.1f} ms "
          f"(busy share {prof['device_busy_share']:.3f}) on {card}", flush=True)
    for r in prof["top_device"]:
        print(f"  {r['ms']:10.3f} ms  x{r['count']:5d}  {r['name']}", flush=True)
    print(f"the same pass unprofiled: cudnn.benchmark off {prof['cudnn_benchmark_off_ms']} ms, "
          f"on {prof['cudnn_benchmark_on_ms']} ms", flush=True)

    stats_imgs = synthetic(rng, 10000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = fid_mod.reference_statistics(stats_imgs, net=net, batch=500)
    torch.cuda.synchronize()
    out["fid_stats_10000_s"] = time.perf_counter() - t0
    stats_path = os.path.join(tmp, "fid_stats.npz")
    fid_mod.save_reference_statistics(stats_path, *stats, net.variant, 10000)

    for label, ibatch, fid in (("is_b100", 100, False), ("is_b500", 500, False),
                               ("is_fid_b500", 500, True)):
        run_cfg = parse_args(["--preset", "train_py", "--inception_samples", str(SAMPLES),
                              "--inception_batch", str(ibatch), "--save_dir", tmp]
                             + (["--eval_fid", "--fid_stats_path", stats_path] if fid else []))
        cache = train_mod.EvalCache(net=net)
        log = _Log()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_mod._maybe_inception_eval(run_cfg, engine, state, log, 0, None, cache)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bound = 2 * SAMPLES * flops / f32_peak
        out[label] = {"s": secs, "img_per_s": 2 * SAMPLES / secs, "bound_s": bound,
                      "bound_by": "operations", "share_of_bound": bound / secs,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "scores": log.recs}
        print(f"eval event {label}: 2 x {SAMPLES} samples, inception batch {ibatch}"
              f"{', --eval_fid' if fid else ''}: {secs:.2f} s, "
              f"{out[label]['img_per_s']:.0f} img/s, bound {bound:.2f} s "
              f"({100 * bound / secs:.0f}% of it), peak {out[label]['peak_gb']:.2f} GB; "
              f"scores {json.dumps(log.recs)} on {card}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
