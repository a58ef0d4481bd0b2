#!/usr/bin/env python3
"""Measures the row-sharded matcher's local-step kernels on one GPU:
``python3 measure_local_step.py`` from the root of a checkout.

1. The time of one step at the row blocks of a multi-GPU run and on the
   whole (6, 4000, 4000) of a group of one, on the default plan
   (``sinkhorn_step_cuda.step_plan``) and swept over its two choices: the
   ring's stages (1, 2, 3, 4, 6, 8; each with the most rows a stage that
   fit; 0, the direct plan) and the blocks a matrix (11, 22, 33, 44, 66 on a 132-SM card).
2. One row-sharded match at batch 2000 (d 32768, lam 500, 500 iterations)
   in a one-process NCCL group under ``torch.profiler``: the wall time and
   the device time by kernel of that same run, and their ratio, the
   device's busy share while profiled. Then the time of one all-reduce of
   the loop's (6, 1000) partials alone.

It prints the card's ``nvidia-smi`` name and power limit first, and one
JSON line of results last. It needs a card and raises without one.
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from chip_smoke import ITERS, LAM, card_line, cuda_ms, free_port, unit_features
from otgan_tpu_torch.ops import sinkhorn_step_cuda as st
from otgan_tpu_torch.ops.costs import true_f32
from otgan_tpu_torch.parallel.matching_sharded import make_sharded_two_batch_matcher

SHAPES = [(6, 313, 2500), (6, 500, 2000), (6, 1000, 1000), (6, 1000, 4000), (6, 4000, 4000)]
STAGES = (0, 1, 2, 3, 4, 6, 8)  # 0: the direct plan
BLOCKS_PER_SM_SHARE = (0.5, 1, 1.5, 2, 3)  # blocks a matrix, in units of SMs / b


def sweep(gen) -> dict:
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in SHAPES:
        b, n, m = shape
        x = -25.0 * torch.rand(shape, generator=gen, device="cuda")
        x = (x - x.amax(-1, keepdim=True)).contiguous()
        v = torch.zeros((b, m), device="cuda")
        step = st.make_local_step(x, mode="stream")
        res = {"default": {"plan": step.plan._asdict(), "ms": cuda_ms(lambda: step(v), 50)}}
        for share in BLOCKS_PER_SM_SHARE:
            blocks = int(share * (sms // b))
            for stages in STAGES:
                if st.step_plan(b, n, m, blocks=blocks, stages=stages) is None:
                    continue
                step = st.make_local_step(x, mode="stream", n_ctas=blocks, stages=stages)
                p = step.plan
                res[f"{p.blocks}x{p.groups}_blocks_{p.stages}_stages_of_{p.stage_rows}"] = (
                    cuda_ms(lambda: step(v), 50))
        best = min((k for k in res if k != "default"), key=res.get)
        out[str(list(shape))] = res
        print(f"local step at {shape}: default {json.dumps(res['default'])}; best {best} "
              f"{res[best]:.4f} ms; all ms {json.dumps(res)}", flush=True)
    return out


def profile_match(gen, batch: int = 2000) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    true_f32()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        fa, fb = unit_features(gen, batch, 32768), unit_features(gen, batch, 32768)
        matcher = make_sharded_two_batch_matcher(None, LAM, ITERS, use_pallas=True)
        matcher(fa, fb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            matcher(fa, fb)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # what one all-reduce of the loop's (6, N) partials costs alone
        part = torch.zeros((6, batch // 2), device="cuda")
        dist.all_reduce(part)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            dist.all_reduce(part)
        host_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        allreduce_us = (time.perf_counter() - t0) * 1e3
    finally:
        dist.destroy_process_group()
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    res = {"batch": batch, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "all_reduce_us_host": host_us, "all_reduce_us_wall": allreduce_us,
           "top_device": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in kernels[:12]]}
    print(f"row-sharded match at batch {batch}, profiled: {wall_ms:.1f} ms wall, device "
          f"kernels {busy_ms:.1f} ms (busy share {busy_ms / wall_ms:.3f})", flush=True)
    for r in res["top_device"]:
        print(f"  {r['ms']:9.3f} ms  x{r['count']:5d}  {r['name']}", flush=True)
    print(f"one all-reduce of a (6, {batch // 2}) float32 tensor: {host_us:.1f} us to "
          f"enqueue, {allreduce_us:.1f} us to finish (mean of 1000)", flush=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("measure_local_step needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card, "sweep_ms": sweep(gen), "profile": profile_match(gen)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
