#!/usr/bin/env python3
"""Measures the resident Sinkhorn kernel (``csrc/sinkhorn_resident.cu``) on
one GPU: the numbers behind its cluster rule (``CLUSTER_SMALL``,
``CLUSTER_LARGE`` and ``SMALL_ROWS`` of ``ops/sinkhorn_resident_cuda.py``)
and behind the tier between it and the grid kernel
(``RESIDENT_TIER_CELLS`` of ``ops/sinkhorn.py``):
``python3 measure_resident.py`` from the root of a checkout.

1. Each of ``chip_smoke.py``'s resident shapes held against the plain
   version and kernel 1's path (lam 500, 500 iterations), with the three
   times, the bound and the expf floor.
2. The cluster barrier alone: 500 barriers (arrive, then wait) on 6
   clusters of the planned size at 6 x 128^2 and 6 x 256^2, the latency
   floor of the loop.
3. At 6 x N^2 two-batch costs (d 32768), N = 128, 256, 384, 512, 768, and
   at 1 x 768^2: the resident kernel at every cluster size that fits, the
   grid kernel on its plan, and kernel 1's path, in ms per match; P of the
   resident kernel held against the grid kernel's within 1e-5.

It prints the card's ``nvidia-smi`` name and power limit first, and one
JSON line of results last. It needs a card and raises without one.
"""

from __future__ import annotations

import json

import torch

from chip_smoke import (ITERS, LAM, P_TOL, card_line, cuda_ms, hold_resident, peaks,
                        resident_shapes, sfu_rate, unit_features)
from otgan_tpu_torch.kernels.build import build_all
from otgan_tpu_torch.ops import sinkhorn_cuda as sk
from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc
from otgan_tpu_torch.ops.matching import two_batch_costs

TIER_SHAPES = [(6, 128), (6, 256), (6, 384), (6, 512), (6, 768), (1, 768)]


def barrier_floor() -> dict:
    """ms of ITERS cluster barriers alone on 6 clusters of the plan's size."""
    out = {}
    for n in (128, 256):
        cs = rc.resident_plan(n, n).cluster
        out[f"6x{n}^2_cluster_{cs}"] = cuda_ms(lambda: rc.barrier_loop_cuda(cs, 6, ITERS), 10)
    print(f"cluster barrier alone, ms per {ITERS}: {json.dumps(out)}", flush=True)
    return out


def tiers(gen) -> dict:
    out = {}
    sms, smem = gc.card_limits(torch.device("cuda"))
    for b, n in TIER_SHAPES:
        costs = two_batch_costs(unit_features(gen, 2 * n, 32768),
                                unit_features(gen, 2 * n, 32768))[:b].contiguous()
        res = {"planned_cluster": rc.resident_plan(n, n).cluster}
        for cs in range(1, rc.MAX_CLUSTER + 1):
            if rc.resident_plan(n, n, cs) is not None:
                res[f"cluster_{cs}"] = cuda_ms(
                    lambda: rc.sinkhorn_resident_cuda(costs, LAM, ITERS, cluster_size=cs), 10)
        res["resident"] = res[f"cluster_{res['planned_cluster']}"]
        res["grid"] = cuda_ms(lambda: gc.sinkhorn_grid_cuda(costs, LAM, ITERS), 5)
        res["grid_plan"] = list(gc.grid_plan(n, n, sms, smem, batch=b))
        res["kernel1_path"] = cuda_ms(lambda: sk.sinkhorn_assignment_kernel(costs, LAM, ITERS), 3)
        p, _ = rc.sinkhorn_resident_cuda(costs, LAM, ITERS)
        p_g, _ = gc.sinkhorn_grid_cuda(costs, LAM, ITERS)
        res["max_abs_dP_vs_grid"] = float((p - p_g).abs().max())
        if res["max_abs_dP_vs_grid"] > P_TOL:
            raise AssertionError(f"the resident kernel disagrees with the grid kernel at "
                                 f"{b} x {n}^2")
        out[f"{b}x{n}^2"] = res
        print(f"{b} x {n}^2, ms per match ({ITERS} iterations): {json.dumps(res)}", flush=True)
        del costs, p, p_g
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("measure_resident needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    build_all()
    _, (bw, flops) = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    exp_rate = sfu_rate()
    held = {label: hold_resident(c, label, bw, flops, exp_rate)
            for label, c in resident_shapes(gen).items()}
    res = {"card": card, "held": held, "barrier_ms": barrier_floor(), "tiers_ms": tiers(gen)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
