#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout, it

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds every CUDA kernel from ``otgan_tpu_torch/csrc/``;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (6 x 2500^2, lam = 500, 500 iterations) and at a
   ragged one (6 x 100 x 228): max |dP| <= 1e-5 and |d entropy| <= 1e-4;
   then the kernel path against a float64 Sinkhorn on a small input;
4. drives the main path, ``otgan_tpu_torch.train --preset train_py
   --synthetic_data --synthetic_size 10000`` for one 5:1 cycle (6 steps of
   global batch 5000, bf16 model compute), with every launch counter set
   to 0 just before and read just after: each kernel of the path must have
   launched and no plain version may have run;
5. prints one ``{"kernels": [...]}`` JSON line: per kernel its launches on
   the main path, its error against the plain version, its time, the plain
   version's time and the bound for the same work on this card;
6. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failed phase raises and the script exits non-zero without that line.
Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LAM, ITERS, BATCH = 500.0, 500, 5000
P_TOL, ENT_TOL = 1e-5, 1e-4
# peak rates of the H100 parts (NVIDIA data sheets): memory bytes/s and
# float32 FLOP/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12), "H100": (3.35e12, 67e12)}
# float32 operations per matrix element per iteration in the kernel: row
# step add, max, subtract, exp, sum; column step the same five
OPS_PER_CELL_ITER = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, rates in PEAKS.items():
        if key in name:
            return key, rates
    raise RuntimeError(f"no peak rates known for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def unit_features(gen, n: int, d: int):
    import torch

    f = torch.randn((n, d), generator=gen, device="cuda")
    return f / f.norm(dim=1, keepdim=True)


def compare_with_plain(costs, label: str) -> dict:
    """Kernel vs plain version on the same logits; raises past the limits."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_cuda as sk
    from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy

    x = sk.scaled_logits(costs, LAM)
    v = sk.col_potential_cuda(x, ITERS)
    v_ref = sk.col_potential_plain(x, ITERS)
    torch.cuda.synchronize()
    p, ent = assignment_and_entropy(x + v[:, None, :])
    p_ref, ent_ref = assignment_and_entropy(x + v_ref[:, None, :])
    res = {
        "max_abs_dP": float((p - p_ref).abs().max()),
        "max_abs_dentropy": float((ent - ent_ref).abs().max()),
        "max_abs_dv": float((v - v_ref).abs().max()),
        "finite": bool(torch.isfinite(p).all() and torch.isfinite(v).all()),
    }
    print(f"kernel vs plain {label} {tuple(x.shape)} lam={LAM} iters={ITERS}: "
          + json.dumps(res), flush=True)
    if not (res["finite"] and res["max_abs_dP"] <= P_TOL
            and res["max_abs_dentropy"] <= ENT_TOL):
        raise AssertionError(f"kernel disagrees with its plain version at {label}")
    return {"x": x, **res}


def sinkhorn_f64(cost, lam: float, iters: int):
    """The reference recursion in float64 (``utils/matching.py:50-57``)."""
    import torch

    log_a = -lam * cost.double()
    for _ in range(iters):
        log_a = log_a - torch.logsumexp(log_a, dim=-1, keepdim=True)
        log_a = log_a - torch.logsumexp(log_a, dim=-2, keepdim=True)
    p = torch.softmax(log_a, dim=-1)
    ent = -(p * torch.log_softmax(log_a, dim=-1)).sum(-1).mean(-1)
    return p, ent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from otgan_tpu_torch.kernels.build import build_all
    from otgan_tpu_torch.ops import sinkhorn_cuda as sk
    from otgan_tpu_torch.ops.costs import cosine_cost
    from otgan_tpu_torch.ops.matching import match_two_batch, two_batch_costs
    from otgan_tpu_torch.ops.sinkhorn import sinkhorn_assignment
    from otgan_tpu_torch import train as train_mod

    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peak_key, (bw, flops) = peaks(name)

    # ---- 2. build ----
    t0 = time.time()
    libs = build_all()
    print(f"build: {len(libs)} CUDA libraries in {time.time() - t0:.1f} s: "
          + ", ".join(os.path.relpath(p, REPO) for p in libs.values()), flush=True)

    # ---- 3. kernel vs plain at the main path's shapes ----
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats_a = unit_features(gen, BATCH, 32768)
    feats_b = unit_features(gen, BATCH, 32768)
    costs = two_batch_costs(feats_a, feats_b)
    main_cmp = compare_with_plain(costs, "main-path")
    # ragged edges in both dims (100 rows of 16-row panels, 228 columns of
    # 256-thread blocks), from critic-width features like the main path's
    ragged = torch.stack([
        cosine_cost(unit_features(gen, 100, 32768), unit_features(gen, 228, 32768))
        for _ in range(6)
    ])
    compare_with_plain(ragged, "ragged")

    x = main_cmp.pop("x")
    kernel_ms = cuda_ms(lambda: sk.col_potential_cuda(x, ITERS), reps=5)
    plain_ms = cuda_ms(lambda: sk.col_potential_plain(x, ITERS), reps=2)
    b, n, m = x.shape
    bytes_moved = 4 * b * n * m + 4 * b * m
    ops = OPS_PER_CELL_ITER * b * n * m * ITERS
    bytes_ms, ops_ms = bytes_moved / bw * 1e3, ops / flops * 1e3
    stream_ms = 4 * b * n * m * ITERS / bw * 1e3  # x streamed every iteration
    print(f"timing at {tuple(x.shape)} x {ITERS} iters on {card}: kernel {kernel_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; bound max(bytes {bytes_ms:.4f} ms, ops {ops_ms:.3f} ms) "
          f"at {peak_key} peaks; streaming x every iteration needs {stream_ms:.3f} ms",
          flush=True)
    del x, costs
    x_small = sk.scaled_logits(
        two_batch_costs(unit_features(gen, 256, 32768), unit_features(gen, 256, 32768)), LAM
    )
    small_ms = cuda_ms(lambda: sk.col_potential_cuda(x_small, ITERS), reps=5)
    print(f"kernel at batch 256 {tuple(x_small.shape)} x {ITERS} iters: {small_ms:.3f} ms "
          f"({small_ms / (2 * ITERS) * 1e3:.2f} us per launch) on {card}", flush=True)
    matcher_ms = cuda_ms(
        lambda: match_two_batch(feats_a, feats_b, LAM, ITERS, use_pallas=True), reps=2
    )
    print(f"matcher (6 costs, Sinkhorn kernel, softmax, 12 matched-feature matmuls) "
          f"at batch {BATCH}, d 32768: {matcher_ms:.3f} ms per match on {card}", flush=True)
    del feats_a, feats_b

    small = two_batch_costs(unit_features(gen, 128, 64), unit_features(gen, 128, 64))
    p_k, e_k = sinkhorn_assignment(small, LAM, 200, use_pallas=True)
    p_o, e_o = sinkhorn_f64(small, LAM, 200)
    d_or = float((p_k.double() - p_o).abs().max())
    de_or = float((e_k.double() - e_o).abs().max())
    print(f"kernel path vs float64 Sinkhorn {tuple(small.shape)} lam={LAM}: "
          f"max|dP| {d_or:.3e}, max|d entropy| {de_or:.3e}", flush=True)
    if not (d_or <= P_TOL and de_or <= ENT_TOL):
        raise AssertionError("kernel path disagrees with the float64 Sinkhorn")

    # ---- 4. the main path, counters zeroed just before ----
    save_dir = os.path.join(REPO, "runs", "chip_smoke")
    argv = ["--preset", "train_py", "--synthetic_data", "--synthetic_size", "10000",
            "--max_epochs", "3", "--log_every_steps", "1", "--save_dir", save_dir]
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.time()
    result = train_mod.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(sk.launches)
    steps = result.steps
    for rec in steps:
        print(f"step {rec['step']} ({rec['kind']}): dist {rec['dist']:.6f} "
              f"entropy {rec['entropy']:.6f} {rec['step_ms']:.1f} ms/step", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path: {len(steps)} steps in {wall:.1f} s (init included); launches "
          f"{launches}; peak memory {peak_gb:.2f} GB on {card}", flush=True)
    if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5:
        raise AssertionError(f"expected one 5:1 cycle, got {[r['kind'] for r in steps]}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError("non-finite dist or entropy on the main path")
    if launches["kernel"] < 1 or launches["plain"] != 0:
        raise AssertionError(f"the main path did not run through the kernel: {launches}")
    with torch.no_grad():
        imgs = result.state.gen(torch.zeros((4, 100), device="cuda"))
    if imgs.shape != (4, 32, 32, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError("generator output after training is malformed")

    # ---- 5. the kernels line ----
    kernels = [{
        "name": "sinkhorn_col_potential",
        "route": "cuda",
        "source": "otgan_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "otgan_tpu/ops/sinkhorn_pallas_tiled.py:64",
        "launches": launches["kernel"],
        "launches_per_step": launches["kernel"] / len(steps),
        "max_abs_err": main_cmp["max_abs_dP"],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [b, n, m],
        "n_iters": ITERS,
        "matcher_ms": matcher_ms,
        "ms_at_batch_256": small_ms,
        "main_path_ms_per_step": [r["step_ms"] for r in steps],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
