#!/usr/bin/env python3
"""Measures the grid Sinkhorn kernel (``csrc/sinkhorn_grid.cu``) on one GPU:
the numbers that set the tiers of ``sinkhorn_assignment`` (``ops/sinkhorn.py``)
and the grid kernel's plan (``ops/sinkhorn_grid_cuda.py``):
``python3 measure_grid.py`` from the root of a checkout.

1. The grid barrier alone: ``BARRIERS`` grid-wide barriers and nothing else
   on 132 (one per SM on an H100), 66 and 33 blocks of 1024 threads, in us
   per barrier.
2. The block-count sweep: at 6 x 2500^2 the fewest blocks a matrix whose
   bands fit (120 on an H100; 33 and 66 do not), the count halfway to one
   per SM, and one per SM; at 6 x 1000^2 33, 66 and 132; each also with
   no iteration (the fixed cost: C read, P and the entropy written), and
   the us per iteration that the difference gives.
3. Per match at 6 x N^2 two-batch costs (d 32768, lam 500, 500
   iterations), N = 128, 256, 384, 512, 768, 1024, 1500, 2000, 2500 and the
   largest square the grid kernel holds: the grid kernel on its plan, the
   resident kernel where it holds the matrix, and kernel 1's path
   (``sinkhorn_assignment_kernel``: the local-step kernel's v mode, one
   launch an iteration, which the tier rule takes above the grid kernel's
   ceiling); kernel 1's path alone at N = 4000. The grid kernel's P is held
   against kernel 1's within 1e-5 at each N.

It prints the card's ``nvidia-smi`` name and power limit first, and one
JSON line of results last. It needs a card and raises without one.
"""

from __future__ import annotations

import json

import torch

from chip_smoke import ITERS, LAM, P_TOL, card_line, cuda_ms, unit_features
from otgan_tpu_torch.kernels.build import build_all
from otgan_tpu_torch.ops import sinkhorn_cuda as sk
from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc
from otgan_tpu_torch.ops.costs import true_f32
from otgan_tpu_torch.ops.matching import two_batch_costs

BARRIERS = 20000
TIER_N = [128, 256, 384, 512, 768, 1024, 1500, 2000, 2500]


def costs_6(gen, n: int):
    return two_batch_costs(unit_features(gen, 2 * n, 32768), unit_features(gen, 2 * n, 32768))


def barrier_us() -> dict:
    out = {}
    for blocks in (132, 66, 33):
        ms = cuda_ms(lambda: gc.barrier_loop_cuda(blocks, gc.THREADS, BARRIERS), reps=3)
        out[f"{blocks}_blocks"] = ms / BARRIERS * 1e3
    print(f"grid barrier alone, us per barrier ({gc.THREADS} threads a block): "
          + json.dumps(out), flush=True)
    return out


def block_sweep(gen, sms: int, smem: int) -> dict:
    out = {}
    for n, counts in ((2500, None), (1000, (33, 66, 132))):
        costs = costs_6(gen, n)
        if counts is None:
            fewest = min(k for k in range(1, sms + 1) if gc.grid_plan(n, n, sms, smem, k))
            counts = sorted({fewest, (fewest + sms) // 2, sms})
        for blocks in counts:
            run = lambda it: gc.sinkhorn_grid_cuda(costs, LAM, it, blocks=blocks)  # noqa: E731
            ms, ms0 = cuda_ms(lambda: run(ITERS), reps=5), cuda_ms(lambda: run(0), reps=5)
            groups = gc.grid_groups(blocks, 6, sms)
            rounds = -(-6 // groups)
            res = {"band": gc.grid_plan(n, n, sms, smem, blocks)[1], "matrices_at_once": groups,
                   "ms": ms, "ms_no_iterations": ms0,
                   "us_per_iteration": (ms - ms0) / (rounds * ITERS) * 1e3}
            out[f"6x{n}^2_{blocks}_blocks"] = res
            print(f"grid kernel at 6 x {n}^2 on {blocks} blocks a matrix: {json.dumps(res)}",
                  flush=True)
        del costs
    return out


def tiers(gen, sms: int, smem: int) -> dict:
    out = {}
    top = max(n for n in range(2500, 4000) if gc.grid_plan(n, n, sms, smem))
    for n in TIER_N + [top, 4000]:
        costs = costs_6(gen, n)
        res = {"kernel1_path": cuda_ms(lambda: sk.sinkhorn_assignment_kernel(costs, LAM, ITERS),
                                       reps=3)}
        plan = gc.grid_plan(n, n, sms, smem, batch=6)
        if plan is not None:
            p, _ = gc.sinkhorn_grid_cuda(costs, LAM, ITERS)
            p_k1, _ = sk.sinkhorn_assignment_kernel(costs, LAM, ITERS)
            res.update(grid=cuda_ms(lambda: gc.sinkhorn_grid_cuda(costs, LAM, ITERS), reps=5),
                       grid_plan=list(plan), grid_matrices_at_once=gc.grid_groups(plan[0], 6, sms),
                       grid_max_abs_dP_vs_kernel1=float((p - p_k1).abs().max()))
            if res["grid_max_abs_dP_vs_kernel1"] > P_TOL:
                raise AssertionError(f"the grid kernel disagrees with kernel 1 at 6 x {n}^2")
            del p, p_k1
        if rc.resident_supported(n, n):
            res["resident"] = cuda_ms(lambda: rc.sinkhorn_resident_cuda(costs, LAM, ITERS),
                                      reps=10)
        out[f"6x{n}^2"] = res
        print(f"6 x {n}^2, ms per match ({ITERS} iterations): {json.dumps(res)}", flush=True)
        del costs
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("measure_grid needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    build_all()
    true_f32()
    sms, smem = gc.card_limits(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card, "sms": sms, "smem_per_block": smem, "barrier_us": barrier_us(),
           "block_sweep": block_sweep(gen, sms, smem), "tiers_ms": tiers(gen, sms, smem)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
