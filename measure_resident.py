#!/usr/bin/env python3
"""Measures the resident Sinkhorn kernel (``csrc/sinkhorn_resident.cu``)
against the column-potential kernel (``csrc/sinkhorn.cu``) on one GPU, the
numbers that set the tier between them (``ops/sinkhorn.py``) and the
resident kernel's cluster rule (``ops/sinkhorn_resident_cuda.py``):
``python3 measure_resident.py`` from the root of a checkout.

1. Each of ``chip_smoke.py``'s resident shapes held against the plain
   version and kernel 1 (lam 500, 500 iterations), with the three times.
2. At 6 x N^2 for N = 128, 256, 512, 768 (and 1 x 768^2) the resident
   kernel at every cluster size that fits, and kernel 1, in ms per match.

It prints the card's ``nvidia-smi`` name and power limit first, and one
JSON line of results last. It needs a card and raises without one.
"""

from __future__ import annotations

import json

import torch

from chip_smoke import (ITERS, LAM, card_line, cuda_ms, hold_resident, peaks, resident_shapes,
                        sfu_rate, unit_features)
from otgan_tpu_torch.kernels.build import build_all
from otgan_tpu_torch.ops import sinkhorn_cuda as sk
from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc
from otgan_tpu_torch.ops.costs import true_f32
from otgan_tpu_torch.ops.matching import two_batch_costs

TIER_SHAPES = [(6, 128), (6, 256), (6, 512), (6, 768), (1, 768)]


def sweep(gen) -> dict:
    out = {}
    for b, n in TIER_SHAPES:
        costs = two_batch_costs(unit_features(gen, 2 * n, 32768),
                                unit_features(gen, 2 * n, 32768))[:b].contiguous()
        res = {"planned_cluster": rc.resident_plan(n, n)[0]}
        for cs in range(1, rc.MAX_CLUSTER + 1):
            if rc.resident_plan(n, n, cs) is not None:
                res[f"cluster_{cs}"] = cuda_ms(
                    lambda: rc.sinkhorn_resident_cuda(costs, LAM, ITERS, cluster_size=cs), 10)
        res["kernel1"] = cuda_ms(lambda: sk.sinkhorn_assignment_kernel(costs, LAM, ITERS), 5)
        out[f"{b}x{n}^2"] = res
        print(f"{b} x {n}^2, ms per match ({ITERS} iterations): {json.dumps(res)}", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("measure_resident needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    build_all()
    true_f32()
    _, (bw, flops) = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    exp_rate = sfu_rate()
    held = {label: hold_resident(c, label, bw, flops, exp_rate)
            for label, c in resident_shapes(gen).items()}
    res = {"card": card, "held": held, "sweep_ms": sweep(gen)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
