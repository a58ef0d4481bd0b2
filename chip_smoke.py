#!/usr/bin/env python3
"""Smoke test of the PyTorch port on NVIDIA GPUs: ``python3 chip_smoke.py``.

Run from the root of a checkout, it

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds every CUDA kernel from ``otgan_tpu_torch/csrc/``;
3. holds the column-potential loop (kernel 1 above the grid kernel's
   ceiling: the local-step kernel's v mode, one launch an iteration)
   against its plain PyTorch version on the card, at the main path's shapes
   (6 x 2500^2, lam = 500, 500 iterations), where kernel 1's path is the
   grid kernel's yardstick, and at a ragged one (6 x 100 x 228): max |dP|
   <= 1e-5 and |d entropy| <= 1e-4; then kernel 1's path, the public entry (which takes the
   resident tier at that size) and the grid kernel against a float64
   Sinkhorn on a small input;
3b. holds the grid kernel (one launch per match, the matrix in the shared
   memory of the whole card) against its plain version and against kernel
   1's path at lam = 500, 500 iterations: the main path's 6 x 2500^2, a
   ragged 6 x 2000 x 2600, the single-batch 3 x 2500^2 with the +999
   diagonal (diag(P) < 1e-6), the largest square its plan holds on this
   card, and 6 x 1000^2 on a forced 33 blocks a matrix (P within 1e-5,
   entropy within 1e-4); then times it at 6 x 2500^2 beside kernel 1's
   path, its plain version and its bound;
4. drives the single-GPU path, ``otgan_tpu_torch.train --preset train_py
   --synthetic_data --synthetic_size 10000`` for one 5:1 cycle (6 steps of
   global batch 5000, bf16 model compute; its epochs of 2 batches are
   leftovers of a cycle: under the default ``--fused_cycle`` the first runs
   eagerly, the next is captured and replayed, the third replayed), with
   every launch counter set
   to 0 just before and read just after: the grid kernel must have
   launched once a step and nothing else, no plain version;
4b. runs the same cycle again with ``--profile_dir``, ``--debug_nans`` and
   ``--no_fused_cycle`` (the spans of a step vanish inside a graph's
   replay), as its own process: it exits 0, its Chrome trace holds 6 device events of the
   grid kernel and every step and phase span (a trace with no device event
   is taken again, at most three times); prints the ten device kernels
   with the most time and the device time of the kernels launched in each
   phase span (``features``, ``match``, ``loss_backward``, ``update``);
4c. drives the DenseNet path, ``--preset train_py --model densenet
   --grad_accum 4 --no_fused_cycle`` (16 layers a block, 16 filters,
   features d 7296; microbatches of 1250, from ``measure_densenet.py``'s
   table; unfused, as the README advises at this batch: see
   ``measure_fused.py``) for one 5:1 cycle at batch 5000, counters zeroed
   just before: 6 grid launches and nothing else, finite dist and entropy,
   the peak memory allocated and reserved printed; then one
   microbatch's gradients of the generator and critic under ``--remat``
   and under ``--remat_policy gen_u1,gen_u2,disc_d2,disc_d3`` against the
   plain models' (float32, cuDNN deterministic): max relative difference
   <= 1e-6; and so for one DCGAN generator step and one critic step through
   the engine at batch 256 without microbatches, under ``--remat`` and
   under ``--remat_policy gen_g1,disc_c4,gen_g2,disc_c3,gen_g3``;
5. holds the row-sharded matcher's local-step kernel, under both tiers
   (fused and stream, one kernel that both launch), against its plain version,
   at the row blocks one rank holds in a multi-GPU run: (6, 313, 2500)
   (batch 5000 on 8 GPUs), (6, 500, 2000) (batch 4000 on 4 GPUs), (6,
   1000, 4000) (batch 8000 on 4 GPUs) and a ragged (6, 100, 228): one step
   (m within 1e-6, s within 1e-5 relative), then 500 iterations of the
   whole matrix split into those blocks, the ranks' all-reduces done in
   torch (P within 1e-5, entropy within 1e-4); the stream tier also on so
   few blocks that each walks many ring stages, and one stream step on the
   whole (6, 4000, 4000) on its default plan; then times each tier at
   every block, one stream step on the whole (6, 4000, 4000), and counts
   the device kernels of one step under ``torch.profiler``;
6. drives the multi-GPU matcher path in a one-process NCCL group: the
   row-sharded two-batch matcher at d 32768, lam 500, 500 iterations, at
   batch 2000 (block (6, 1000, 1000), fused tier) and batch 8000 (block
   (6, 4000, 4000), stream tier), counters zeroed just before and read just
   after, against the single-device matcher (matched features and entropy
   within 1e-4), whose own launches are read too: the grid tier at batch
   2000, kernel 1 at batch 8000 (6 x 4000^2, above the grid tier), the one
   path left to kernel 1 on one card: there kernel 1 is held against its
   plain version on the matcher's own costs and on a ragged (2, 2700, 2650)
   above the ceiling (P within 1e-5, entropy within 1e-4), its v must be
   bitwise equal across two calls and a 3-iteration call must launch
   exactly 3 device kernels, all the local-step kernel (``torch.profiler``);
   then it is timed beside its plain version and its bound, the numbers of
   its entry;
7. with more than one card visible, on K = 4 GPUs (2 when fewer than 4
   are visible) under ``torchrun``: the row-sharded matcher over K ranks against the
   single-device matcher (``chip_smoke.py --ranks``, batches 5000 and
   8000), then training on the row-sharded matcher, once per local-step
   tier: one 3:1 cycle of ``--preset model_saving`` (layout auto, which
   resolves to rows; stream tier) and one 5:1 cycle of ``--preset
   train_py --batch_size 1000K --matching_layout rows`` (fused tier); then
   one 5:1 cycle of ``--preset train_py --matching_layout matrices`` (the
   layout ``auto`` picks for train_py: whole 2500^2 matrices on each rank,
   the grid tier between the collectives). Rank 0 logs the kernels' launch
   counts of the cycle to ``metrics.jsonl``: the tier's kernel must have
   launched (the grid kernel once per matrix rank 0 owns and step) and no
   plain version run. On one card it says that it skipped this, and that
   the local-step kernels' launches then come from phase 6, not from their
   training path;
8. holds the resident kernel (one launch per match, the matrices in shared
   memory) against its plain version and against kernel 1's path at lam =
   500, 500 iterations: (6, 128, 128) (the DCGAN at batch 256), (6, 256,
   256) (the toy at batch 512), (1, 768, 768), a ragged (6, 100, 228) and
   the single-batch (3, 128, 128) with the +999 diagonal (P within 1e-5,
   entropy within 1e-4, diag(P) < 1e-6), with the three times and the
   bound at each; then at 6 x 128^2 on every cluster size that fits (held
   and timed), and ITERS cluster barriers alone on the planned clusters of
   6 x 128^2 and of the toy's 6 x 256^2, the loop's latency floor;
9. drives the toy MED-GAN with the notebook's settings (batch 512, lam 50,
   10 iterations, 1:1) for 2 short epochs with a checkpoint, counters
   zeroed just before: rank 0's ``launches`` must show the resident
   kernel and nothing else; then resumes one epoch with ``--load_params``
   (it must start at epoch 2) and runs ``sample.py --ema --num_samples
   1000`` on the run (finite samples; the mode coverage is printed);
10. drives one 5:1 cycle of the DCGAN at its default batch 256: 6 resident
   launches and nothing else; then ``sample.py`` writes a PNG grid whose
   header and size are checked;
10b. drives the eval path with fixed-seed random InceptionV3 weights
   (tf2015, 1008 classes, written to a temporary npz at
   ``OTGAN_INCEPTION_WEIGHTS``): the card's float32 pool features and
   logits of 16 images, through the scorers' own switch that holds TF32
   off, within 1e-4 (relative to the largest value) of the same network in
   float64 on the CPU, while the same forward with TF32 allowed must miss
   that tolerance; the golden pins of ``tests/test_eval_golden_pins.py`` at
   that file's tolerances; ``python -m otgan_tpu_torch.eval.fid`` on 10 000
   synthetic images, then ``evaluate`` on phase 10's checkpoint at 10 000
   samples and 10 splits with FID against those statistics, counters zeroed
   just before (no Sinkhorn kernel may launch), printing IS, FID, seconds
   and img/s; then one trainer eval event, the DCGAN at batch 256 under
   ``--eval_fid`` with 1000 samples: ``metrics.jsonl`` must hold the raw
   and EMA scores and FIDs and the running max at epoch 1;
10c. writes phase 10's state in the JAX package's checkpoint format
   (``convert.jax_leaves``) into a new run directory, reads it back equal
   to the port-format restore, and resumes there with ``--load_params``:
   the JAX format is read, the run starts at epoch 2 and takes 3 finite
   steps;
12a. (several hosts; 12a-12d run before 11) holds the native batch
   assembler (``data/native.py``, built with g++ on the card's host)
   against its numpy path at batch 5000: the same bytes in uint8, float32
   and bfloat16, both timed; fails if the library did not build;
12b. runs one 5:1 cycle of ``--preset train_py --synthetic_data
   --multihost`` (a world of one process through the manual flags
   ``--coordinator_address --num_processes 1 --process_id 0``, NCCL) with
   ``--host_prefetch`` and with ``--no_host_prefetch``, each its own
   process (``chip_smoke.py --train``) under ``--profile_dir``,
   ``--no_fused_cycle`` (the gaps are read between step spans, which a
   graph's replay does not have) and ``--checkpoint_backend orbax
   --checkpoint_slot_dtype bfloat16``: prints
   cycle ms, img/s, peak memory and the device-idle ms between consecutive
   steps from the trace (``utils/tracing.py::step_gaps``); each run must
   launch the grid kernel 6 times and no plain version, take the native
   host path, and the two must see the same batches (first step's dist
   bitwise equal, later ones within 1e-4);
12c. restores 12b's ``orbax/2`` (``torch.distributed.checkpoint``) into a
   fresh state, equal to an npz of the same final state tensor for tensor
   (restore seconds, directory bytes, and the write seconds of a timed
   synchronous DCP write of that state); resumes it in a new process with
   ``--load_params`` (DCP format read, epoch 3, 3 finite steps); then
   ``sample.py`` and ``evaluate.py`` (random InceptionV3 weights, 1000
   samples) read the directory;
12d. with two or more cards: two "hosts", two ``torchrun`` agents
   (``--nnodes 2``, c10d rendezvous on localhost, half the cards each),
   ``--multihost --matching_layout rows`` at batch 5000 for one cycle, then
   a resume: each process says ``process p/2 (local batch 2500)`` and the
   local-step kernel's launches come from this run; on one card it says
   why it did not run;
13a. (13a-13c run before 11) ``match_two_batch`` at batch 5000 (d 32768,
   lam 500, the grid tier) under ``--matching_precision highest``, ``high``
   (3xTF32) and ``default`` (one TF32 pass): ms per match, and the matched
   features', ``dist``'s and entropy's deltas against ``highest`` and
   against the match on float64 costs; ``high``'s features must be within
   1e-5 of ``highest``'s (DESIGN.md section 7) and TF32 off after every
   match; one split's ms and one cost product's ms and error against
   float64 at each precision; then one train_py cycle under ``high``
   (6 grid launches, nothing else);
13b. the trainer with ``--fused_cycle`` (a CUDA graph a cycle) and with
   ``--no_fused_cycle``, each in this process: the toy (2 epochs of 8
   batches, 1:1), the DCGAN at batch 256 (3 epochs of one 5:1 cycle) and
   train_py at batch 5000 (4 epochs of 10 batches, as on CIFAR-10: six
   schedules, full cycles and leftovers of 4): every step's dist and
   entropy equal bit for bit (at most 1e-6 relative would be reported, and
   fail above), the same launches both ways (16 resident; 18 resident; 40
   grid), the peak memory allocated and reserved both ways; then each of
   the three through the engine: eager cycles against replays, each read
   back once at its end (ms a step, like for like), latents drawn inside
   the graph that differ between two replays, and a profiled replay with
   one device event a step of its kernel (resident; resident; grid);
13c. ``ops/energy.py`` at (2500, 32768) against the same call on the CPU
   (the residuals bit for bit, the loss within 1e-5 relative), then
   ``python -m otgan_tpu_torch.examples.toy_baselines`` for 20 steps of
   each objective: finite weights, ``med_gan`` 40 resident launches
   (2 a step) and the others none;
11. prints one ``{"kernels": [...]}`` JSON line: per kernel its launches on
   its path (``launches_from`` says which run), its error against the
   plain version, its time, the plain version's time, the bound for the
   same work on this card and, as ``sfu_floor_ms``, its expf alone at the
   special-function units' peak; every number printed stands after the
   card's ``nvidia-smi`` name and power limit, the first line;
14. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failed phase raises and the script exits non-zero without that line.
Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
LAM, ITERS, BATCH = 500.0, 500, 5000
P_TOL, ENT_TOL = 1e-5, 1e-4
# peak rates of the H100 parts (NVIDIA data sheets): memory bytes/s and
# float32 FLOP/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12), "H100": (3.35e12, 67e12)}
# float32 operations per matrix element per iteration in the kernels: row
# step add, max, subtract, sum; column step the same four. Beside them one
# expf per element and step, on the special-function units (MUFU.EX2, 16 a
# clock per SM on sm_90), counted against that rate (sfu_rate)
OPS_PER_CELL_ITER = 8
EXPS_PER_CELL_ITER = 2
MUFU_PER_SM_CLOCK = 16
TOY_EPOCH_BATCHES = 8  # batches of the toy run's short epochs
# the DenseNet cycle's --grad_accum: microbatches of 1250, the largest that
# fits both step kinds on an 80 GB card (measure_densenet.py: 65.3 GB for
# the generator step; 2500 runs out of memory; PERF.md 5)
DENSENET_ACCUM = 4
REMAT_POLICY = "gen_u1,gen_u2,disc_d2,disc_d3"
DCGAN_REMAT_POLICY = "gen_g1,disc_c4,gen_g2,disc_c3,gen_g3"


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


def sfu_rate() -> float:
    """expf a second at the card's peak: SMs x 16 MUFU.EX2 a clock x the
    maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * MUFU_PER_SM_CLOCK * mhz * 1e6


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


def time_kernel1(costs, ragged, bw: float, flops: float, exp_rate: float) -> dict:
    """Kernel 1 above the grid kernel's ceiling (the local-step kernel in its
    v mode, one launch an iteration) on ``costs`` and on the ragged costs
    ``ragged``, both of the "tiled" tier on this card: held against its
    plain version (raises past the limits), v bitwise equal across two
    calls, exactly 3 device kernels, all the local-step kernel, in a
    3-iteration call under ``torch.profiler``; then its time on ``costs``,
    the plain version's and its bound: x read once and v written once (the
    column potential writes no P)."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_cuda as sk
    from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
    from otgan_tpu_torch.ops.sinkhorn import kernel_tier

    limits = gc.card_limits(costs.device)
    for c in (costs, ragged):
        if kernel_tier(*c.shape[-2:], limits) != "tiled":
            raise AssertionError(f"{tuple(c.shape)} is not above the grid kernel's ceiling")
    held = {"main": compare_with_plain(costs, "kernel 1's path"),
            "ragged": compare_with_plain(ragged, "kernel 1's path, ragged")}
    x = held["main"].pop("x")
    held["ragged"].pop("x")
    v1 = sk.col_potential_cuda(x, ITERS).clone()
    v2 = sk.col_potential_cuda(x, ITERS)
    names = device_kernels(lambda: sk.col_potential_cuda(x, 3))
    res = {"bitwise_repeatable": bool(torch.equal(v1, v2)), "device_kernels_3_iters": names}
    print(f"kernel 1 at {tuple(x.shape)}: v bitwise equal across two calls: "
          f"{res['bitwise_repeatable']}; device kernels of a 3-iteration call: {names}", flush=True)
    if not res["bitwise_repeatable"]:
        raise AssertionError("kernel 1's v differs between two calls on the same input")
    if len(names) != 3 or not all("local_step" in nm for nm in names):
        raise AssertionError(f"a 3-iteration kernel 1 call launched {names}")
    b, n, m = x.shape
    return {"max_abs_err": max(h["max_abs_dP"] for h in held.values()), "held": held, **res,
            "ms": cuda_ms(lambda: sk.col_potential_cuda(x, ITERS), reps=3),
            "plain_ms": cuda_ms(lambda: sk.col_potential_plain(x, ITERS), reps=2),
            **loop_bound(4 * b * n * m + 4 * b * m, b * n * m * ITERS, bw, flops, exp_rate),
            "stream_ms": 4 * b * n * m * ITERS / bw * 1e3,  # x streamed every iteration
            "shape": [b, n, m]}


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


def resident_shapes(gen) -> dict:
    """The resident tier's costs: the DCGAN at batch 256 (6 x 128^2), the
    toy at batch 512 (6 x 256^2), the point of ``bench.py:541-548`` (1 x
    768^2), a ragged (6, 100, 228), and the single-batch 3 x 128^2 with the
    +999 self-match diagonal."""
    import torch
    from otgan_tpu_torch.ops.costs import cosine_cost, scaled_sqeuclidean_cost
    from otgan_tpu_torch.ops.matching import two_batch_costs

    toy = torch.randn((512, 16), generator=gen, device="cuda")
    fa, fb = unit_features(gen, 128, 32768), unit_features(gen, 128, 32768)
    eye = 999.0 * torch.eye(128, device="cuda")
    return {
        "dcgan_b256": two_batch_costs(unit_features(gen, 256, 32768),
                                      unit_features(gen, 256, 32768)),
        "toy_b512": two_batch_costs(toy, torch.randn((512, 16), generator=gen, device="cuda"),
                                    scaled_sqeuclidean_cost),
        "bench_768": cosine_cost(unit_features(gen, 768, 32768),
                                 unit_features(gen, 768, 32768))[None],
        "ragged": torch.stack([cosine_cost(unit_features(gen, 100, 32768),
                                           unit_features(gen, 228, 32768)) for _ in range(6)]),
        "single_b128": torch.stack([cosine_cost(fa, fa) + eye, cosine_cost(fb, fb) + eye,
                                    cosine_cost(fa, fb)]),
    }


def hold_resident(costs, label: str, bw: float, flops: float, exp_rate: float) -> dict:
    """The resident kernel against its plain version and against kernel 1's
    path on ``costs`` (b, N, M), at LAM and ITERS; raises past P_TOL and
    ENT_TOL. Then the three times and the kernel's bound."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_cuda as sk
    from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc

    p, e = rc.sinkhorn_resident_cuda(costs, LAM, ITERS)
    p_ref, e_ref = rc.sinkhorn_resident_plain(costs, LAM, ITERS)
    p_k1, e_k1 = sk.sinkhorn_assignment_kernel(costs, LAM, ITERS)
    torch.cuda.synchronize()
    b, n, m = costs.shape
    res = {
        "shape": [b, n, m],
        "plan": rc.resident_plan(n, m)._asdict(),
        "max_abs_dP": float((p - p_ref).abs().max()),
        "max_abs_dentropy": float((e - e_ref).abs().max()),
        "max_abs_dP_vs_kernel1": float((p - p_k1).abs().max()),
        "max_abs_dentropy_vs_kernel1": float((e - e_k1).abs().max()),
        "finite": bool(torch.isfinite(p).all() and torch.isfinite(e).all()),
    }
    if label == "single_b128":
        res["max_diag_P"] = float(torch.diagonal(p[:2], dim1=1, dim2=2).max())
    print(f"resident kernel vs plain and kernel 1, {label} {tuple(costs.shape)} lam={LAM} "
          f"iters={ITERS}: " + json.dumps(res), flush=True)
    if not (res["finite"] and max(res["max_abs_dP"], res["max_abs_dP_vs_kernel1"]) <= P_TOL
            and max(res["max_abs_dentropy"], res["max_abs_dentropy_vs_kernel1"]) <= ENT_TOL
            and res.get("max_diag_P", 0.0) < 1e-6):
        raise AssertionError(f"the resident kernel disagrees at {label}")
    res.update(
        ms=cuda_ms(lambda: rc.sinkhorn_resident_cuda(costs, LAM, ITERS), reps=20),
        kernel1_ms=cuda_ms(lambda: sk.sinkhorn_assignment_kernel(costs, LAM, ITERS), reps=5),
        plain_ms=cuda_ms(lambda: rc.sinkhorn_resident_plain(costs, LAM, ITERS), reps=2),
        **match_bound(b, n, m, bw, flops, exp_rate))
    print(f"resident tier at {label} {tuple(costs.shape)}: kernel {res['ms']:.4f} ms, kernel 1 "
          f"{res['kernel1_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']} (expf alone "
          f"{res['sfu_floor_ms']:.4f} ms)", flush=True)
    return res


def resident_clusters(costs, bw: float, flops: float, exp_rate: float) -> dict:
    """The resident kernel at every cluster size that fits ``costs``
    (b, N, M), each held against the plain version (raises past P_TOL and
    ENT_TOL) and timed; and the cluster barrier alone, ITERS of them on b
    clusters of the planned size: the loop's latency floor."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc

    b, n, m = costs.shape
    p_ref, e_ref = rc.sinkhorn_resident_plain(costs, LAM, ITERS)
    out = {}
    for cs in range(1, rc.MAX_CLUSTER + 1):
        if rc.resident_plan(n, m, cs) is None:
            continue
        p, e = rc.sinkhorn_resident_cuda(costs, LAM, ITERS, cluster_size=cs)
        res = {"max_abs_dP": float((p - p_ref).abs().max()),
               "max_abs_dentropy": float((e - e_ref).abs().max()),
               "ms": cuda_ms(lambda: rc.sinkhorn_resident_cuda(costs, LAM, ITERS, cluster_size=cs),
                             reps=10)}
        if not (bool(torch.isfinite(p).all()) and res["max_abs_dP"] <= P_TOL
                and res["max_abs_dentropy"] <= ENT_TOL):
            raise AssertionError(f"the resident kernel disagrees on a cluster of {cs} at "
                                 f"{tuple(costs.shape)}: {res}")
        out[cs] = res
    planned = rc.resident_plan(n, m).cluster
    floor = cuda_ms(lambda: rc.barrier_loop_cuda(planned, b, ITERS), reps=10)
    print(f"resident kernel at {tuple(costs.shape)} by cluster size (planned {planned}): "
          f"{json.dumps(out)}; {ITERS} cluster barriers alone {floor:.4f} ms", flush=True)
    return {"by_cluster": out, "planned": planned, "barrier_floor_ms": floor}


def grid_shapes(gen, main_costs) -> dict:
    """The grid tier's costs (lam 500, 500 iterations): the main path's 6 x
    2500^2 two-batch costs, a ragged 6 x 2000 x 2600, the single-batch 3 x
    2500^2 with the +999 self-match diagonal (``match_single_batch``'s
    costs), the largest square ``grid_plan`` holds on this card, and 6 x
    1000^2 on a forced 33 blocks a matrix (bands of 31 rows, four matrices
    at once), from d 32768 unit features."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
    from otgan_tpu_torch.ops.costs import cosine_cost
    from otgan_tpu_torch.ops.matching import two_batch_costs

    sms, smem = gc.card_limits(torch.device("cuda"))
    top = max(n for n in range(2000, 4000) if gc.grid_plan(n, n, sms, smem))
    fa, fb = unit_features(gen, 2500, 32768), unit_features(gen, 2500, 32768)
    eye = 999.0 * torch.eye(2500, device="cuda")
    return {
        "main_6x2500": (main_costs, None),
        "ragged_6x2000x2600": (torch.stack([
            cosine_cost(unit_features(gen, 2000, 32768), unit_features(gen, 2600, 32768))
            for _ in range(6)]), None),
        "single_3x2500": (torch.stack([cosine_cost(fa, fa) + eye, cosine_cost(fb, fb) + eye,
                                       cosine_cost(fa, fb)]), None),
        f"ceiling_1x{top}": (cosine_cost(unit_features(gen, top, 32768),
                                         unit_features(gen, top, 32768))[None], None),
        "blocks33_6x1000": (two_batch_costs(unit_features(gen, 2000, 32768),
                                            unit_features(gen, 2000, 32768)), 33),
    }


def hold_grid(costs, label: str, blocks=None) -> dict:
    """The grid kernel against its plain version and against kernel 1's
    path on ``costs`` (b, N, M), at LAM and ITERS, on ``blocks`` blocks a
    matrix (None: the plan's); raises past P_TOL and ENT_TOL, and where the
    label says ``single``, unless diag(P) < 1e-6 on the +999 matrices."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_cuda as sk
    from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
    from otgan_tpu_torch.ops.sinkhorn_resident_cuda import sinkhorn_resident_plain

    b, n, m = costs.shape
    sms, smem = gc.card_limits(costs.device)
    p, e = gc.sinkhorn_grid_cuda(costs, LAM, ITERS, blocks=blocks)
    p_ref, e_ref = sinkhorn_resident_plain(costs, LAM, ITERS)
    res = {"shape": [b, n, m], "plan": list(gc.grid_plan(n, m, sms, smem, blocks, batch=b)),
           "max_abs_dP": float((p - p_ref).abs().max()),
           "max_abs_dentropy": float((e - e_ref).abs().max())}
    del p_ref, e_ref
    res["matrices_at_once"] = gc.grid_groups(res["plan"][0], b, sms)
    p_k1, e_k1 = sk.sinkhorn_assignment_kernel(costs, LAM, ITERS)
    res.update(max_abs_dP_vs_kernel1=float((p - p_k1).abs().max()),
               max_abs_dentropy_vs_kernel1=float((e - e_k1).abs().max()),
               finite=bool(torch.isfinite(p).all() and torch.isfinite(e).all()))
    if "single" in label:
        res["max_diag_P"] = float(torch.diagonal(p[:2], dim1=1, dim2=2).max())
    print(f"grid kernel vs plain and kernel 1, {label} {tuple(costs.shape)} lam={LAM} "
          f"iters={ITERS}: " + json.dumps(res), flush=True)
    if not (res["finite"] and max(res["max_abs_dP"], res["max_abs_dP_vs_kernel1"]) <= P_TOL
            and max(res["max_abs_dentropy"], res["max_abs_dentropy_vs_kernel1"]) <= ENT_TOL
            and res.get("max_diag_P", 0.0) < 1e-6):
        raise AssertionError(f"the grid kernel disagrees at {label}")
    return res


STEP_M_TOL, STEP_S_RTOL = 1e-6, 1e-5  # one local step: m absolute, s relative
MULTI_GPU_TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def loop_bound(bytes_moved: float, cell_iters: float, bw: float, flops: float,
               exp_rate: float) -> dict:
    """The least time of Sinkhorn work on this card: ``bytes_moved`` over
    the memory rate, or the work of ``cell_iters`` matrix cells times
    iterations, the larger. That work is OPS_PER_CELL_ITER float32
    operations over their peak and EXPS_PER_CELL_ITER expf over the
    special-function units' peak; ``sfu_floor_ms`` is the expf alone."""
    b_ms = bytes_moved / bw * 1e3
    sfu_ms = EXPS_PER_CELL_ITER * cell_iters / exp_rate * 1e3
    o_ms = max(OPS_PER_CELL_ITER * cell_iters / flops * 1e3, sfu_ms)
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "sfu_floor_ms": sfu_ms}


def match_bound(b: int, n: int, m: int, bw: float, flops: float, exp_rate: float) -> dict:
    """Bound of a whole-loop match on (b, n, m) costs at ITERS: C read once,
    P and the entropies written once."""
    return loop_bound(4 * (2 * b * n * m + b), b * n * m * ITERS, bw, flops, exp_rate)


def drive_blocks(x, n_blocks: int, iters: int, mode=None, n_ctas=None):
    """``iters`` Sinkhorn iterations on the square logits ``x`` (b, N, N)
    split into the row blocks ``n_blocks`` ranks would hold, each block's
    local step a kernel of tier ``mode`` (``"plain"``: the plain version)
    on ``n_ctas`` blocks per matrix (stream tier), the ranks' all-reduces
    done in torch. Returns the column potential."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st

    rows = -(-x.shape[1] // n_blocks)
    blocks = [x[:, i * rows:(i + 1) * rows].contiguous() for i in range(n_blocks)]
    if mode == "plain":
        steps = [st.make_local_step(blk, use_kernel=False) for blk in blocks]
    else:
        steps = [st.make_local_step(blk, mode=mode, n_ctas=n_ctas) for blk in blocks]
    v = x.new_zeros((x.shape[0], x.shape[2]))
    for _ in range(iters):
        parts = [step(v) for step in steps]
        m = torch.stack([p[0] for p in parts])
        s = torch.stack([p[1] for p in parts])
        m_glob = m.amax(dim=0)
        v = -(m_glob + torch.log((s * torch.exp(m - m_glob)).sum(dim=0)))
    return v


def step_errors(blk, v, mode: str, n_ctas=None) -> dict:
    """One local step of tier ``mode`` on ``blk`` against the plain step."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st

    m_ref, s_ref = st.local_step_plain(blk, v)
    m_k, s_k = st.make_local_step(blk, mode=mode, n_ctas=n_ctas)(v)
    return {
        "step_max_abs_dm": float((m_k - m_ref).abs().max()),
        "step_max_rel_ds": float(((s_k - s_ref).abs() / s_ref.abs()).max()),
        "step_finite": bool(torch.isfinite(m_k).all() and torch.isfinite(s_k).all()),
    }


def step_ok(res: dict) -> bool:
    return (res["step_finite"] and res["step_max_abs_dm"] <= STEP_M_TOL
            and res["step_max_rel_ds"] <= STEP_S_RTOL)


def hold_local_step(x, n_blocks: int, label: str, whole: bool = False) -> dict:
    """Both local-step tiers against the plain version at the row blocks of
    ``x`` over ``n_blocks`` ranks: one step, then ITERS iterations. The
    stream tier also runs on so few blocks that each walks about 64 rows
    (``stream_walk``), so its ring wraps and the online rescale of its
    column accumulators runs; with ``whole``, one stream step on the whole
    of ``x`` on its default plan is held too (the block of a group of
    one)."""
    import torch
    from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy

    v_ref = drive_blocks(x, n_blocks, ITERS, "plain")
    p_ref, e_ref = assignment_and_entropy(x + v_ref[:, None, :])
    rows = -(-x.shape[1] // n_blocks)
    blk = x[:, :rows].contiguous()
    walk = max(1, -(-rows // 64))  # blocks per matrix of stream_walk
    out = {}
    for name, mode, n_ctas in (("fused", "fused", None), ("stream", "stream", None),
                               ("stream_walk", "stream", walk)):
        res = step_errors(blk, v_ref, mode, n_ctas)
        v_k = drive_blocks(x, n_blocks, ITERS, mode, n_ctas)
        p, e = assignment_and_entropy(x + v_k[:, None, :])
        torch.cuda.synchronize()
        res.update(max_abs_dP=float((p - p_ref).abs().max()),
                   max_abs_dentropy=float((e - e_ref).abs().max()),
                   finite=bool(torch.isfinite(p).all()))
        if n_ctas:
            res["blocks_per_matrix"] = n_ctas
        print(f"local step {name} vs plain, {label}: block {tuple(blk.shape)} of "
              f"{tuple(x.shape)} over {n_blocks} ranks, lam={LAM} iters={ITERS}: "
              + json.dumps(res), flush=True)
        if not (step_ok(res) and res["finite"] and res["max_abs_dP"] <= P_TOL
                and res["max_abs_dentropy"] <= ENT_TOL):
            raise AssertionError(f"local step {name} disagrees with its plain version at {label}")
        out[name] = res
    if whole:
        res = step_errors(x, v_ref, "stream")
        print(f"local step stream vs plain, {label}: whole {tuple(x.shape)}, one step: "
              + json.dumps(res), flush=True)
        if not step_ok(res):
            raise AssertionError(f"local step stream disagrees with its plain version on the "
                                 f"whole of {tuple(x.shape)}")
        out["stream_whole"] = res
    return out


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches, from
    ``torch.profiler``. A profile whose trace holds no device event at all
    (the card's trace came back empty, which a later profile in one process
    sometimes gives) is taken again, at most three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def time_local_step(blk, mode: str, bw: float, flops: float, exp_rate: float) -> dict:
    """One step, ITERS steps with the v update between, and the plain step,
    at the rank's block ``blk``; the bounds of a step and of ITERS steps;
    the device kernels of one step (raises unless exactly one)."""
    import torch
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st

    b, n, m = blk.shape
    step = st.make_local_step(blk, mode=mode)
    v0 = torch.zeros((b, m), device="cuda")
    names = device_kernels(lambda: step(v0))
    if len(names) != 1:
        raise AssertionError(f"one {mode} step at {tuple(blk.shape)} launched {names}")
    plain = st.make_local_step(blk, use_kernel=False)

    def loop():
        v = v0
        for _ in range(ITERS):
            m_loc, s_loc = step(v)
            v = -(m_loc + torch.log(s_loc))

    step_bytes = 4 * (b * n * m + 3 * b * m)
    over_iters = loop_bound(step_bytes, b * n * m * ITERS, bw, flops, exp_rate)
    return {
        "ms": cuda_ms(lambda: step(v0), reps=50),
        "plain_ms": cuda_ms(lambda: plain(v0), reps=10),
        **loop_bound(step_bytes, b * n * m, bw, flops, exp_rate),
        "ms_per_500_steps": cuda_ms(loop, reps=3),
        "bound_ms_per_500_steps": over_iters["bound_ms"],
        "bound_by_per_500_steps": over_iters["bound_by"],
        "launches_per_step": len(names),
        "plan": step.plan._asdict(),
        "shape": [b, n, m],
    }


def run_group(cmd, timeout: float, env) -> subprocess.CompletedProcess:
    """Run ``cmd`` in its own process group; on timeout kill the whole group."""
    import signal

    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def ranks_check() -> int:
    """``torchrun --nproc_per_node K chip_smoke.py --ranks`` (K 2 or 4): the
    row-sharded matcher over K GPUs (NCCL) on each rank's rows, gathered,
    against the single-device matcher on rank 0, at batches 5000 and 8000
    and, where K divides both halves of 5000, at the next batch whose halves
    it does not divide (padded halves); whole local halves are compared
    after ``sharded_permutation``. Rank 0 prints one ``ranks_check`` JSON
    line."""
    import torch
    import torch.distributed as dist
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st
    from otgan_tpu_torch.ops.matching import match_two_batch
    from otgan_tpu_torch.parallel.matching_sharded import (
        make_sharded_two_batch_matcher,
        sharded_permutation,
    )
    from otgan_tpu_torch.parallel.mesh import all_gather_rows, init_from_env, local_rows

    init_from_env("cuda")
    rank, size = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = make_sharded_two_batch_matcher(None, LAM, ITERS, use_pallas=True)
    report, failed = {"ranks": size}, []
    batches = [5000, 8000]
    if (5000 // 2) % size == 0:
        batches.insert(1, next(B for B in range(5000, 6000, 2)
                               if B % size == 0 and (B // 2) % size))
    for B in batches:
        fa, fb = unit_features(gen, B, 32768), unit_features(gen, B, 32768)
        mine = (local_rows(fa, rank, size), local_rows(fb, rank, size))
        st.reset_launch_counts()
        got = rows(*mine)
        counts = dict(st.launches)
        outs = [all_gather_rows(t, None) for t in got[:4]]
        ent = float(got.entropy)
        rows_ms = cuda_ms(lambda: rows(*mine), reps=2)
        if rank == 0:
            even = (B // 2) % size == 0
            perm = sharded_permutation(B, size) if even else list(range(B))
            inv = torch.argsort(torch.tensor(perm, device="cuda"))
            ref = match_two_batch(fa[perm], fb[perm], LAM, ITERS, use_pallas=True)
            d_feat = max(float((o - r[inv]).abs().max()) for o, r in zip(outs, ref[:4]))
            d_ent = abs(ent - float(ref.entropy))
            single_ms = cuda_ms(lambda: match_two_batch(fa, fb, LAM, ITERS, use_pallas=True),
                                reps=2)
            tier = st.local_step_mode(-(-(B // 2) // size), size * -(-(B // 2) // size))
            report[str(B)] = dict(path="whole local halves" if even else "padded halves",
                                  tier=tier, launches=counts, max_abs_dfeatures=d_feat,
                                  dentropy=d_ent, row_sharded_matcher_ms=rows_ms,
                                  single_device_matcher_ms=single_ms)
            if counts[tier] < 1 or counts["plain"] != 0 or d_feat > 1e-4 or d_ent > ENT_TOL:
                failed.append(B)
        del fa, fb, mine, got, outs
        torch.cuda.empty_cache()
    if rank == 0:
        print("ranks_check: " + json.dumps(report), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if failed:
        raise AssertionError(f"the row-sharded matcher on {size} GPUs disagrees at {failed}")
    return 0


def train_on_gpus(k: int, preset: str, batch: int, flags, kinds, tier: str, env) -> dict:
    """One cycle of ``otgan_tpu_torch.train --preset preset`` on ``k`` GPUs
    under torchrun, on synthetic data of two batches; checks the cycle, its
    finite dist and entropy, and from rank 0's ``metrics.jsonl`` that the
    matcher ran the ``tier`` kernel and no plain version: a local-step tier
    (``fused``, ``stream``) of the row-sharded matcher, or ``grid`` for the
    matrix-parallel one, which must launch it once per matrix rank 0 owns
    and step, and nothing else."""
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st
    from otgan_tpu_torch.parallel.matching_matrix import _owner_counts

    run_dir = os.path.join(REPO, "runs", f"chip_smoke_{k}gpu_{preset}_{tier}")
    shutil.rmtree(run_dir, ignore_errors=True)  # metrics.jsonl is appended to
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={k}", "-m", "otgan_tpu_torch.train", "--num_devices", str(k),
           "--preset", preset, "--synthetic_data", "--synthetic_size", str(2 * batch),
           "--log_every_steps", "1", "--save_dir", run_dir, *flags]
    t0 = time.time()
    out = run_group(cmd, MULTI_GPU_TIMEOUT, env)
    print(out.stdout[-3000:], flush=True)
    if out.returncode != 0:
        print(out.stderr[-6000:], file=sys.stderr, flush=True)
        raise AssertionError(f"torchrun --preset {preset} on {k} GPUs exited {out.returncode}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "step_ms" in r]
    launches = [r["launches"] for r in recs if "epoch" in r][-1]
    res = dict(gpus=k, preset=preset, batch=batch, matcher=recs[0]["matcher"],
               init_spread=recs[0]["init_spread"], launches=launches,
               wall_s=time.time() - t0,
               steps=[{x: r[x] for x in ("kind", "dist", "entropy", "step_ms")} for r in steps])
    print(f"{k} GPUs, --preset {preset} {' '.join(flags)}: {json.dumps(res)}", flush=True)
    if [r["kind"] for r in steps] != kinds:
        raise AssertionError(f"expected the cycle {kinds}, got {[r['kind'] for r in steps]}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError(f"non-finite dist or entropy on {k} GPUs ({preset})")
    if tier == "grid":
        if not res["matcher"].startswith("matrix-parallel"):
            raise AssertionError(f"the run did not take the matrix-parallel matcher: "
                                 f"{res['matcher']}")
        rounds = _owner_counts(6, k)[0]  # matrices rank 0 owns a step
        check_tier_path(launches, "grid", f"training on {k} GPUs ({preset}, matrices)",
                        want=rounds * len(steps))
        return res
    if not res["matcher"].startswith("row-sharded"):
        raise AssertionError(f"the run did not take the row-sharded matcher: {res['matcher']}")
    if st.local_step_mode(batch // 2 // k, batch // 2) != tier:
        raise AssertionError(f"the tier rule does not pick {tier} at batch {batch} on {k}")
    if (launches[f"local_step_{tier}"] < 1 or launches["local_step_plain"] != 0
            or launches["col_potential_plain"] != 0):
        raise AssertionError(f"training on {k} GPUs did not run the {tier} kernel: {launches}")
    return res


def multi_gpu_phase(n_cards: int) -> dict:
    """With more than one card: the row-sharded matcher over the ranks
    (``--ranks``), then training on the row-sharded matcher once per
    local-step tier, then on the matrix-parallel matcher (the grid tier).
    Returns the runs by tier, or ``{}`` on one card."""
    import torch

    if n_cards < 2:
        print("multi-GPU phase: not run: one card is visible, and torchrun needs a card "
              "per rank (NCCL refuses two ranks on one card). So the launch counts of the "
              "local-step kernels on their own path, training on several GPUs, were not "
              "read; their `launches` below are from phase 6, the row-sharded matcher in "
              "a one-process NCCL group", flush=True)
        return {}
    k = 4 if n_cards >= 4 else 2  # a K that divides the presets' batches
    env = dict(os.environ, PYTHONPATH=REPO)
    torch.cuda.empty_cache()
    check = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                       f"--nproc_per_node={k}", os.path.join(REPO, "chip_smoke.py"),
                       "--ranks"], MULTI_GPU_TIMEOUT, env)
    print(check.stdout[-3000:], flush=True)
    if check.returncode != 0:
        print(check.stderr[-6000:], file=sys.stderr, flush=True)
        raise AssertionError(f"the row-sharded matcher check on {k} GPUs exited "
                             f"{check.returncode}")
    ranks = json.loads(next(line for line in check.stdout.splitlines()
                            if line.startswith("ranks_check: "))[len("ranks_check: "):])
    # model_saving (batch 8000, 3:1, auto -> rows): block (4000/K, 4000), the
    # stream tier; train_py at batch 1000 K, rows: block (500, 500 K), fused
    multi = {"stream": train_on_gpus(k, "model_saving", 8000, ["--max_epochs", "2"],
                                     ["disc"] + ["gen"] * 3, "stream", env)}
    multi["stream"]["ranks"] = ranks
    if "-> rows]" not in multi["stream"]["matcher"]:
        raise AssertionError(f"auto did not resolve to rows: {multi['stream']['matcher']}")
    multi["fused"] = train_on_gpus(
        k, "train_py", 1000 * k, ["--batch_size", str(1000 * k), "--matching_layout", "rows",
                                  "--max_epochs", "3"],
        ["disc"] + ["gen"] * 5, "fused", env)
    multi["grid"] = train_on_gpus(k, "train_py", BATCH, ["--matching_layout", "matrices",
                                                         "--max_epochs", "3"],
                                  ["disc"] + ["gen"] * 5, "grid", env)
    return multi


def reset_all_counts() -> None:
    from otgan_tpu_torch.ops import (
        sinkhorn_cuda,
        sinkhorn_grid_cuda,
        sinkhorn_resident_cuda,
        sinkhorn_step_cuda,
    )

    for mod in (sinkhorn_cuda, sinkhorn_grid_cuda, sinkhorn_resident_cuda, sinkhorn_step_cuda):
        mod.reset_launch_counts()


def epoch_records(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "epoch" in r]


def check_tier_path(launches: dict, tier: str, what: str, want=None) -> None:
    """The run launched the ``tier`` kernel (``want`` times, when given)
    and nothing else: no other kernel, no plain version."""
    others = {k: n for k, n in launches.items() if k != tier}
    if launches[tier] < 1 or (want is not None and launches[tier] != want) or any(
            others.values()):
        raise AssertionError(f"{what} did not run the {tier} tier alone: {launches}")


def toy_phase(card: str) -> dict:
    """The toy MED-GAN as its user runs it: the notebook's settings
    (``tests/test_toy_e2e.py:35-43``; batch 512, lam 50, 10 iterations, G lr
    3e-4, D lr 6e-5, 1:1) for 2 short epochs with a checkpoint after the
    second, every counter zeroed just before and read just after, then a
    resume for one more epoch, then ``sample.py --ema`` on the run."""
    import numpy as np
    from otgan_tpu_torch import sample as sample_mod
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.data.toy import mode_coverage

    run_dir = os.path.join(REPO, "runs", "chip_smoke_toy")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--model", "toy_mlp", "--batch_size", "512", "--sinkhorn_lambda", "50",
            "--nr_sinkhorn_iter", "10", "--learning_rate_gen", "3e-4",
            "--learning_rate_disc", "6e-5", "--nr_gen_per_disc", "1", "--save_every_epochs", "1",
            "--log_every_steps", "1", "--save_dir", run_dir]
    os.environ["OTGAN_TOY_EPOCH_BATCHES"] = str(TOY_EPOCH_BATCHES)
    try:
        reset_all_counts()
        t0 = time.time()
        first = train_mod.main(argv + ["--max_epochs", "2"])
        wall = time.time() - t0
        counts = train_mod.kernel_launches()
        launches = epoch_records(run_dir)[-1]["launches"]
        t0 = time.time()
        resumed = train_mod.main(argv + ["--max_epochs", "3", "--load_params"])
        resume_wall = time.time() - t0
    finally:
        del os.environ["OTGAN_TOY_EPOCH_BATCHES"]
    epochs = epoch_records(run_dir)
    check_tier_path(launches, "resident", "the toy run (rank 0's metrics.jsonl)")
    check_tier_path(counts, "resident", "the toy run (in-process counters)")
    steps_ms = [r["step_ms"] for r in first.steps]
    res = dict(launches=launches, steps=len(first.steps), wall_s=wall,
               median_step_ms=float(np.median(steps_ms)), resume_wall_s=resume_wall,
               resumed_epochs=[r["epoch"] for r in epochs[2:]],
               resumed_steps=[{k: r[k] for k in ("kind", "dist", "entropy")}
                              for r in resumed.steps[:2]])
    if [r["epoch"] for r in epochs] != [0, 1, 2] or resumed.state.step != 3 * TOY_EPOCH_BATCHES:
        raise AssertionError(f"the resume did not start at epoch 2: {res}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"])
               for r in first.steps + resumed.steps):
        raise AssertionError("non-finite dist or entropy on the toy path")
    x = sample_mod.main(["--save_dir", run_dir, "--ema", "--num_samples", "1000"])
    if x.shape != (1000, 2) or not np.isfinite(x).all():
        raise AssertionError(f"sample.py gave {x.shape} samples, finite: {np.isfinite(x).all()}")
    res["ema_mode_coverage"] = mode_coverage(x)  # printed, not held: 3 short epochs
    print(f"toy path (batch 512, {TOY_EPOCH_BATCHES} batches an epoch) on {card}: "
          + json.dumps(res), flush=True)
    return res


def dcgan_b256_phase(card: str) -> dict:
    """One 5:1 cycle of the DCGAN at its default batch 256 (6 x 128^2, the
    resident tier: 6 launches, nothing else), two epochs of 3 batches so a
    checkpoint is written, then ``sample.py`` writes a PNG grid whose
    signature, header and size are checked."""
    import struct

    from otgan_tpu_torch import sample as sample_mod
    from otgan_tpu_torch import train as train_mod

    run_dir = os.path.join(REPO, "runs", "chip_smoke_b256")
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_all_counts()
    t0 = time.time()
    result = train_mod.main(["--synthetic_data", "--synthetic_size", "768", "--max_epochs", "2",
                             "--save_every_epochs", "1", "--log_every_steps", "1",
                             "--save_dir", run_dir])
    wall = time.time() - t0
    counts = train_mod.kernel_launches()
    launches = epoch_records(run_dir)[-1]["launches"]
    steps = result.steps
    if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5:
        raise AssertionError(f"expected one 5:1 cycle, got {[r['kind'] for r in steps]}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError("non-finite dist or entropy at batch 256")
    check_tier_path(launches, "resident", "the batch-256 cycle (rank 0's metrics.jsonl)", want=6)
    check_tier_path(counts, "resident", "the batch-256 cycle (in-process counters)", want=6)
    sample_mod.main(["--save_dir", run_dir, "--num_samples", "100"])
    with open(os.path.join(run_dir, "samples.png"), "rb") as f:
        png = f.read()
    width, height, depth, color = struct.unpack(">IIBB", png[16:26])
    side = 10 * 33 - 1  # 10 x 10 tiles of 32 pixels, 1-pixel borders
    pos, idat = 8, b""
    while pos < len(png):  # the image data: a filter byte and 3 bytes a pixel per row
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            idat += png[pos + 8:pos + 8 + length]
        pos += 12 + length
    res = dict(launches=launches, wall_s=wall, steps_ms=[r["step_ms"] for r in steps],
               cycle_ms=sum(r["step_ms"] for r in steps), png_bytes=len(png),
               png_header=[width, height, depth, color])
    print(f"DCGAN batch 256, one 5:1 cycle on {card}: " + json.dumps(res), flush=True)
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR" or (
            width, height, depth, color) != (side, side, 8, 2) or len(
                zlib.decompress(idat)) != side * (1 + 3 * side):
        raise AssertionError(f"samples.png is malformed: {res['png_header']}, {len(png)} B")
    return res


# the golden pins of tests/test_eval_golden_pins.py: values and tolerances
GOLDEN_PINS = {"is_mean": (1.0160765195518469, 2e-4), "is_std": (0.0010448366920140506, 5e-3),
               "mu_norm": (25.178570896546223, 1e-4), "sig_trace": (0.30917493054585166, 2e-4),
               "ref_mu_norm": (25.237122748069535, 1e-4), "fid": (0.27727853457426554, 1e-3)}
# float32 pool features and logits against float64, relative to the largest
# value: float32 convs read ~1e-6 there (5e-7 against the JAX package on a
# CPU), TF32 convs (10-bit mantissa) ~1e-3; the check proves it fails TF32
F32_TOL = 1e-4
EVAL_SAMPLES = 10000


def eval_precision_check(net, card: str) -> dict:
    """The card's float32 pool features and logits of 16 images, through
    the scorers' own path (``scoring_mode``: TF32 off), against the same
    network in float64 on the CPU on the same 299^2 inputs; then the same
    forward with TF32 allowed, which must miss the tolerance (so the check
    can see TF32). TF32 is switched on for cuDNN and matmuls before, as a
    bf16 training run leaves it, so only the scorers' own switch holds it off."""
    import copy

    import numpy as np
    import torch
    from otgan_tpu_torch.eval import fid as fid_mod
    from otgan_tpu_torch.eval import inception as inc

    imgs = np.random.default_rng(7).integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    keep = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        feats = torch.from_numpy(fid_mod.pool_features(imgs, net=net, batch=16))
        with inc.scoring_mode():
            x = inc.preprocess(torch.from_numpy(imgs).cuda(), net.variant)
            logits = net(x).cpu()
        with torch.inference_mode():
            feats_tf32 = net.pool_features(x).cpu()
            logits_tf32 = net(x).cpu()
            torch.set_num_threads(os.cpu_count() or 1)
            net64 = copy.deepcopy(net).cpu().double()
            x64 = x.cpu().double()
            feats64 = net64.pool_features(x64)
            logits64 = net64.fc(feats64)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    res = {"features_rel_err": rel(feats, feats64), "logits_rel_err": rel(logits, logits64),
           "tf32_features_rel_err": rel(feats_tf32, feats64),
           "tf32_logits_rel_err": rel(logits_tf32, logits64), "tol": F32_TOL}
    print(f"eval: float32 on the card vs float64 on the CPU, 16 images at 299^2 on {card}: "
          + json.dumps(res), flush=True)
    if not (res["features_rel_err"] <= F32_TOL and res["logits_rel_err"] <= F32_TOL):
        raise AssertionError(f"the card's float32 Inception forward is off: {res}")
    if not max(res["tf32_features_rel_err"], res["tf32_logits_rel_err"]) > F32_TOL:
        raise AssertionError(f"the tolerance does not see TF32: {res}")
    return res


def eval_golden_pins(net, card: str) -> dict:
    """``tests/test_eval_golden_pins.py`` on the card: 32 generated images
    in two batches of 16 through the one-pass scorer, 32 reference images
    through ``pool_features``; each pinned value at that file's tolerance."""
    import numpy as np
    import torch
    from otgan_tpu_torch.eval import fid as fid_mod

    img_rng = np.random.default_rng(2025)
    gen_imgs = img_rng.integers(0, 256, (32, 32, 32, 3)).astype(np.float32)
    ref_imgs = img_rng.integers(0, 256, (32, 32, 32, 3)).astype(np.float32)
    batches = [torch.from_numpy(gen_imgs[i * 16:(i + 1) * 16] / 127.5 - 1.0).cuda()
               for i in range(2)]
    (m, s), (mu, sig) = fid_mod.combined_eval_from_sampler(lambda i: batches[i], 32, splits=2,
                                                           net=net, batch=16)
    mu_r, sig_r = fid_mod.feature_statistics(fid_mod.pool_features(ref_imgs, net=net, batch=16))
    got = {"is_mean": m, "is_std": s, "mu_norm": float(np.linalg.norm(mu)),
           "sig_trace": float(np.trace(sig)), "ref_mu_norm": float(np.linalg.norm(mu_r)),
           "fid": fid_mod.frechet_distance(mu, sig, mu_r, sig_r)}
    rel = {k: abs(got[k] - want) / abs(want) for k, (want, _) in GOLDEN_PINS.items()}
    print(f"eval: golden pins on {card}: values {json.dumps(got)}, relative errors "
          f"{json.dumps(rel)}", flush=True)
    bad = [k for k, (_, tol) in GOLDEN_PINS.items() if not rel[k] <= tol]
    if bad:
        raise AssertionError(f"golden pins missed on the card: {bad}")
    return {"values": got, "rel_err": rel}


def eval_phase(card: str, b256_dir: str) -> dict:
    """The eval path: random tf2015 weights (1008 classes) written to a
    temporary npz at ``OTGAN_INCEPTION_WEIGHTS``; the precision check and
    the golden pins; ``python -m otgan_tpu_torch.eval.fid`` on 10 000 of
    the trainer's synthetic images, then ``evaluate`` on phase 10's
    checkpoint at 10 000 samples, 10 splits, FID against those statistics,
    every launch counter zeroed just before (the eval path launches none of
    the Sinkhorn kernels); then one trainer eval event on the DCGAN at
    batch 256 under ``--eval_fid``."""
    import tempfile

    import torch
    from otgan_tpu_torch import evaluate as evaluate_mod
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.eval import fid as fid_mod
    from otgan_tpu_torch.eval import inception as inc
    from otgan_tpu_torch.eval import random_weights as rw

    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    keep_env = os.environ.get("OTGAN_INCEPTION_WEIGHTS")
    try:
        os.environ["OTGAN_INCEPTION_WEIGHTS"] = rw.save_npz(
            os.path.join(tmp, "inception_random.npz"), seed=2024, variant="tf2015",
            num_classes=1008)
        net = inc.load_net(device="cuda")
        res = {"precision": eval_precision_check(net, card), "golden": eval_golden_pins(net, card)}

        stats = os.path.join(tmp, "fid_stats.npz")
        torch.cuda.synchronize()
        t0 = time.time()
        fid_mod.main(["--synthetic_data", "--synthetic_size", str(EVAL_SAMPLES), "--seed", "1",
                      "--out", stats])
        torch.cuda.synchronize()
        res["fid_stats_s"] = time.time() - t0
        reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = evaluate_mod.main(["--save_dir", b256_dir, "--num_samples", str(EVAL_SAMPLES),
                                 "--splits", "10", "--fid_stats_path", stats])
        torch.cuda.synchronize()
        res["evaluate_s"] = time.time() - t0
        launches = train_mod.kernel_launches()
        res.update(evaluate=out, evaluate_img_per_s=EVAL_SAMPLES / res["evaluate_s"],
                   fid_stats_img_per_s=EVAL_SAMPLES / res["fid_stats_s"],
                   evaluate_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   evaluate_launches=launches)
        print(f"eval: fid CLI over {EVAL_SAMPLES} synthetic images {res['fid_stats_s']:.1f} s "
              f"({res['fid_stats_img_per_s']:.0f} img/s); evaluate at {EVAL_SAMPLES} samples, "
              f"10 splits, inception batch {inc.default_batch()}: IS {out['inception_score']} +- "
              f"{out['inception_std']}, FID {out['fid']}, {res['evaluate_s']:.1f} s "
              f"({res['evaluate_img_per_s']:.0f} img/s, generation and two passes included), "
              f"peak {res['evaluate_peak_gb']:.2f} GB; Sinkhorn launches {launches} on {card}",
              flush=True)
        if any(launches.values()):
            raise AssertionError(f"the eval path launched a Sinkhorn kernel: {launches}")
        if not all(math.isfinite(out[k]) for k in ("inception_score", "inception_std", "fid")):
            raise AssertionError(f"evaluate gave non-finite scores: {out}")
        res["train_event"] = train_eval_event(card)
    finally:
        if keep_env is None:
            os.environ.pop("OTGAN_INCEPTION_WEIGHTS", None)
        else:
            os.environ["OTGAN_INCEPTION_WEIGHTS"] = keep_env
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def train_eval_event(card: str) -> dict:
    """One eval event of the trainer: the DCGAN at batch 256, 2 epochs of 2
    batches, ``--eval_every_epochs 2 --eval_fid``, 1000 samples of the raw
    generator and of the EMA; the FID statistics of the 512 training images
    computed at the event and cached beside the run."""
    from otgan_tpu_torch import train as train_mod

    run_dir = os.path.join(REPO, "runs", "chip_smoke_eval")
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.time()
    train_mod.main(["--synthetic_data", "--synthetic_size", "512", "--max_epochs", "2",
                    "--eval_every_epochs", "2", "--inception_samples", "1000",
                    "--inception_splits", "10", "--eval_fid", "--save_every_epochs", "100",
                    "--save_dir", run_dir])
    wall = time.time() - t0
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    got = {k: r[k] for r in recs for k in r if k in (
        "inception_score", "inception_std", "ema_inception_score", "ema_inception_std", "fid",
        "ema_fid", "max_inception_score", "max_inception_epoch")}
    epoch_end = [r["time"] for r in recs if r.get("epoch") == 1]
    event_s = max(r["time"] for r in recs if "max_inception_score" in r) - epoch_end[0] if (
        epoch_end and "max_inception_score" in got) else None
    res = dict(scores=got, wall_s=wall, event_s=event_s,
               launches=epoch_records(run_dir)[-1]["launches"],
               fid_stats_cached=os.path.exists(os.path.join(run_dir, "fid_stats.npz")))
    print(f"eval: the trainer's eval event (DCGAN batch 256, --eval_fid, 1000 samples raw and "
          f"EMA) on {card}: " + json.dumps(res), flush=True)
    want = ("inception_score", "ema_inception_score", "fid", "ema_fid", "max_inception_score")
    if not all(k in got and math.isfinite(got[k]) for k in want) or not res["fid_stats_cached"]:
        raise AssertionError(f"the trainer's eval event is incomplete: {res}")
    if got["max_inception_epoch"] != 1:
        raise AssertionError(f"the eval event was not at epoch 1: {got}")
    check_tier_path(res["launches"], "resident", "the eval run's training (metrics.jsonl)")
    return res


def jax_resume_phase(card: str, b256_dir: str) -> dict:
    """Resume on the card from a checkpoint in the JAX package's format:
    phase 10's state written as the JAX ``TrainState`` leaves
    (``convert.jax_leaves``, the order the CPU tests hold against
    ``otgan_tpu``'s writer) into a new run directory, read back into a
    fresh state (equal, bit for bit, to the port-format restore of the same
    checkpoint), then ``--load_params`` there: the trainer must say it read
    the JAX format, start at epoch 2 and take 3 finite steps."""
    import numpy as np
    import torch
    from otgan_tpu_torch import convert
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.utils import checkpoint as ckpt

    src = ckpt.latest_checkpoint(b256_dir)
    cfg = TrainConfig.load(os.path.join(b256_dir, "config.json"))
    engine = Engine(cfg, "cuda")
    x_init = np.zeros((8, 32, 32, 3), np.uint8)
    port_state, _ = engine.init_state(cfg.seed, x_init)
    ckpt.restore_checkpoint(src, port_state)
    run_dir = os.path.join(REPO, "runs", "chip_smoke_jax_format")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    path = os.path.join(run_dir, os.path.basename(src))
    leaves = convert.jax_leaves(port_state, rng_key=(0, 1))
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    jax_state, _ = engine.init_state(cfg.seed + 1, x_init)
    ckpt.restore_checkpoint(path, jax_state)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(ckpt._named_tensors(port_state),
                                                            ckpt._named_tensors(jax_state)))
    if not (same and jax_state.step == port_state.step and ckpt.checkpoint_format(path) == "jax"):
        raise AssertionError("the JAX-format file did not restore to the state it was made of")
    saved_step = port_state.step
    del engine, port_state, jax_state
    argv = ["--synthetic_data", "--synthetic_size", "768", "--log_every_steps", "1",
            "--save_every_epochs", "100", "--save_dir", run_dir, "--load_params",
            "--max_epochs", "3"]
    result = train_mod.main(argv)
    epochs = [r["epoch"] for r in epoch_records(run_dir)]
    res = dict(leaves=len(leaves), saved_step=saved_step, epochs=epochs,
               steps=[{k: r[k] for k in ("step", "kind", "dist", "entropy")} for r in result.steps])
    print(f"JAX-format resume on {card}: " + json.dumps(res), flush=True)
    if epochs != [2] or result.state.step != saved_step + 3 or not all(
            math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in result.steps):
        raise AssertionError(f"the resume from the JAX-format file is wrong: {res}")
    return res


def trace_phase(card: str) -> dict:
    """One 5:1 cycle of ``--preset train_py`` under ``--profile_dir`` and
    ``--debug_nans``, run as its own process (the CLI, as a user runs it; a
    profile leaves this process's later profiles without device events).
    The trace is read back (``utils/tracing.py``), and the run is taken
    again when the trace holds no device event; the launches are the ones
    rank 0 logs to ``metrics.jsonl``."""
    from otgan_tpu_torch.utils.tracing import PHASE_SPANS, summarize, trace_path

    run_dir = os.path.join(REPO, "runs", "chip_smoke_trace")
    trace_dir = os.path.join(run_dir, "trace")
    for attempt in range(3):
        shutil.rmtree(run_dir, ignore_errors=True)
        out = subprocess.run(
            [sys.executable, "-m", "otgan_tpu_torch.train", "--preset", "train_py",
             "--synthetic_data", "--synthetic_size", "10000", "--max_epochs", "3",
             "--log_every_steps", "1", "--save_dir", run_dir, "--profile_dir", trace_dir,
             "--debug_nans", "--no_fused_cycle"], cwd=REPO, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"the traced cycle failed (rc {out.returncode}):\n"
                                 f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        path = trace_path(trace_dir)
        summary = summarize(path)
        if summary["kernels"]:
            break
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "kind" in r]
    launches = [r for r in records if "epoch" in r][-1]["launches"]
    grid_events = sum(n for name, (n, _) in summary["kernels"].items() if "grid_sinkhorn" in name)
    spans = summary["spans"]
    res = dict(attempts=attempt + 1, trace_bytes=os.path.getsize(path), grid_device_events=grid_events,
               launches=launches, steps_ms=[r["step_ms"] for r in steps],
               spans_host_ms=spans, phase_device_ms=summary["phase_device_ms"],
               device_ms=summary["device_ms"], top=summary["top"])
    print(f"trace of one 5:1 cycle at batch {BATCH} (--profile_dir, --debug_nans) on {card}: "
          f"{res['trace_bytes']} bytes, {grid_events} grid kernel events, device time "
          f"{summary['device_ms']:.1f} ms; device ms of the kernels launched in each phase span "
          + json.dumps(summary["phase_device_ms"]) + "; host ms (count) of each span "
          + json.dumps(spans) + f"; step ms {res['steps_ms']}", flush=True)
    for name, count, ms in summary["top"]:
        print(f"  trace top device kernel: {ms:10.3f} ms {count:6d}x {name[:120]}", flush=True)
    if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5:
        raise AssertionError(f"expected one 5:1 cycle, got {[r['kind'] for r in steps]}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError("non-finite dist or entropy in the traced cycle")
    check_tier_path(launches, "grid", "the traced cycle (rank 0's metrics.jsonl)", want=6)
    if grid_events != 6:
        raise AssertionError(f"the trace holds {grid_events} grid kernel events, not 6")
    if spans["disc_step"][0] != 1 or spans["gen_step"][0] != 5 or any(
            spans[name][0] < 6 for name in PHASE_SPANS):
        raise AssertionError(f"the trace lacks step or phase spans: {spans}")
    return res


def densenet_remat_check(card: str, mb: int = 64) -> dict:
    """One microbatch's gradients of the DenseNet generator and critic (full
    width, float32, cuDNN deterministic) under ``--remat`` and under
    ``REMAT_POLICY``, against the plain models': max relative difference
    (max |a - b| / max |b| over each parameter) <= 1e-6."""
    import torch
    from otgan_tpu_torch.models import densenet
    from otgan_tpu_torch.nn.layers import reset_parameters

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    try:
        variants = {"plain": {}, "remat": dict(remat=True),
                    "policy": dict(remat=True, remat_policy=REMAT_POLICY)}
        models = {k: (densenet.make_generator(**kw), densenet.make_discriminator(**kw))
                  for k, kw in variants.items()}
        rng = torch.Generator().manual_seed(7)
        for module in models["plain"]:
            reset_parameters(module, rng)
        for k, (g, d) in models.items():
            g.load_state_dict(models["plain"][0].state_dict())
            d.load_state_dict(models["plain"][1].state_dict())
            g.cuda(), d.cuda()
        gen = torch.Generator(device="cuda").manual_seed(8)
        z = densenet.sample_latent(mb, gen, "cuda")
        x = torch.rand((mb, 32, 32, 3), generator=gen, device="cuda") * 2.0 - 1.0
        ct_fake, ct_data = (torch.randn((mb, 7296), generator=gen, device="cuda") for _ in range(2))
        grads = {}
        for k, (g, d) in models.items():
            loss = torch.sum(d(g(z)) * ct_fake) + torch.sum(d(x) * ct_data)
            grads[k] = torch.autograd.grad(loss, [*g.parameters(), *d.parameters()])
        rel = {k: max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(grads[k], grads["plain"])) for k in ("remat", "policy")}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = flags
    print(f"DenseNet remat at a microbatch of {mb}, float32, on {card}: max relative gradient "
          f"difference to the plain models: --remat {rel['remat']:.3e}, --remat_policy "
          f"{REMAT_POLICY} {rel['policy']:.3e}", flush=True)
    if not all(v <= 1e-6 for v in rel.values()):
        raise AssertionError(f"remat changes the DenseNet's gradients: {rel}")
    return rel


def dcgan_remat_step_check(card: str, batch: int = 256) -> dict:
    """One DCGAN generator step and one critic step through the engine, no
    microbatches (float32, cuDNN deterministic), under ``--remat`` and under
    ``DCGAN_REMAT_POLICY``, against the plain steps' gradients: max relative
    difference <= 1e-6."""
    import torch
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator().manual_seed(9)
        x = torch.randint(0, 256, (batch, 32, 32, 3), generator=gen, dtype=torch.uint8)
        z = torch.rand((batch, 100), generator=gen) * 2.0 - 1.0
        variants = {"plain": {}, "remat": dict(remat=True),
                    "policy": dict(remat=True, remat_policy=DCGAN_REMAT_POLICY)}
        grads = {}
        for k, kw in variants.items():
            eng = Engine(TrainConfig(model="dcgan", batch_size=batch, num_devices=1,
                                     compute_dtype="float32", **kw))
            state, _ = eng.init_state(0, x)
            captured, update = {}, eng.opt_update

            def spy(params, g, opt, lr, captured=captured, update=update, **okw):
                captured.setdefault("grads", []).extend(t.detach().clone() for t in g.values())
                return update(params, g, opt, lr, **okw)

            eng.opt_update = spy
            eng.gen_step(state, x, z)
            eng.disc_step(state, x, z)
            grads[k] = captured["grads"]
        rel = {k: max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(grads[k], grads["plain"])) for k in ("remat", "policy")}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = flags
    print(f"DCGAN steps through the engine at batch {batch}, no microbatches, float32, on "
          f"{card}: max relative gradient difference to the plain steps: --remat "
          f"{rel['remat']:.3e}, --remat_policy {DCGAN_REMAT_POLICY} {rel['policy']:.3e}",
          flush=True)
    if not all(v <= 1e-6 for v in rel.values()):
        raise AssertionError(f"remat changes the DCGAN steps' gradients: {rel}")
    return rel


def densenet_phase(card: str) -> dict:
    """One 5:1 cycle of ``--preset train_py --model densenet --grad_accum
    DENSENET_ACCUM --no_fused_cycle`` at batch 5000 (the grid tier at 6 x
    2500^2, features d 7296), counters zeroed just before and read just
    after; then :func:`densenet_remat_check` and
    :func:`dcgan_remat_step_check`. The DenseNet at batch 5000 runs unfused:
    fused, its graphs fit a fresh process with little to spare and ran out
    of memory beside a few GB held by earlier work (``measure_fused.py``)."""
    import torch
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.models import densenet

    run_dir = os.path.join(REPO, "runs", "chip_smoke_densenet")
    shutil.rmtree(run_dir, ignore_errors=True)
    gc.collect()  # an earlier engine's graphs, and their pool, must be gone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.time()
    result = train_mod.main(["--preset", "train_py", "--model", "densenet", "--synthetic_data",
                             "--synthetic_size", "10000", "--grad_accum", str(DENSENET_ACCUM),
                             "--init_batch_size", "500", "--max_epochs", "3",
                             "--log_every_steps", "1", "--no_fused_cycle", "--save_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = train_mod.kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    steps = result.steps
    cycle_ms = sum(r["step_ms"] for r in steps)
    for rec in steps:
        print(f"DenseNet step {rec['step']} ({rec['kind']}): dist {rec['dist']:.6f} entropy "
              f"{rec['entropy']:.6f} {rec['step_ms']:.1f} ms/step", flush=True)
    print(f"DenseNet path (batch {BATCH}, --grad_accum {DENSENET_ACCUM}): {len(steps)} steps in "
          f"{wall:.1f} s (init included); cycle {cycle_ms:.1f} ms ({BATCH * len(steps) / cycle_ms * 1e3:.0f}"
          f" img/s); launches {launches}; peak memory {peak_gb:.2f} GB allocated, "
          f"{peak_reserved_gb:.2f} GB reserved on {card}", flush=True)
    if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5:
        raise AssertionError(f"expected one 5:1 cycle, got {[r['kind'] for r in steps]}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError("non-finite dist or entropy on the DenseNet path")
    check_tier_path(launches, "grid", "the DenseNet path (batch 5000, 6 x 2500^2)", want=6)
    with torch.no_grad():
        imgs = result.state.gen(densenet.sample_latent(4, None, "cuda"))
    if imgs.shape != (4, 32, 32, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError("the DenseNet generator's output after training is malformed")
    del result, imgs
    torch.cuda.empty_cache()
    return dict(launches=launches, steps_ms=[r["step_ms"] for r in steps], cycle_ms=cycle_ms,
                img_per_s=BATCH * len(steps) / cycle_ms * 1e3, wall_s=wall, peak_gb=peak_gb,
                peak_reserved_gb=peak_reserved_gb,
                grad_accum=DENSENET_ACCUM, remat_max_rel_diff=densenet_remat_check(card),
                dcgan_remat_max_rel_diff=dcgan_remat_step_check(card))


MULTIHOST_TIMEOUT = 600


def native_phase(card: str) -> dict:
    """12a. The native batch assembler on the card's host against its numpy
    path at batch 5000 of a train_py-sized uint8 set (10 000 CIFAR-shaped
    images): the same bytes in uint8, float32 and bfloat16, each timed (the
    median of 5 calls). Fails when the library did not build."""
    import numpy as np
    import torch
    from otgan_tpu_torch.data import native

    if not native.native_available():
        raise AssertionError("the native batch assembler did not build on the card's host")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (10000, 32, 32, 3)).astype(np.uint8)
    idx = rng.permutation(10000)[:BATCH]
    flips = (rng.random(BATCH) < 0.5).astype(np.uint8)

    def timed(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(times))

    res = {"native_available": True, "cpus": os.cpu_count()}
    for dtype in ("uint8", "float32", "bfloat16"):
        nat, nat_ms = timed(lambda: native.assemble_batch_u8(data, idx, flips, out_dtype=dtype))
        ref, ref_ms = timed(lambda: native.assemble_batch_numpy(data, idx, flips, out_dtype=dtype))
        if dtype == "bfloat16":
            same = torch.equal(nat.view(torch.int16), ref.view(torch.int16))
        else:
            same = nat.dtype == ref.dtype and np.array_equal(nat, ref)
        res[dtype] = {"native_ms": nat_ms, "numpy_ms": ref_ms, "same_bytes": bool(same)}
        if not same:
            raise AssertionError(f"the native and numpy assemblers differ in {dtype}")
    print(f"12a native batch assembly at batch {BATCH} (gather, flip, convert) on the host of "
          f"{card}: " + json.dumps(res), flush=True)
    return res


def train_report(argv) -> int:
    """``chip_smoke.py --train ARGS``: ``otgan_tpu_torch.train ARGS`` in this
    process, then one line ``train_report: {...}``: wall seconds, peak
    device memory, the host path of the batches, and the final state written
    twice for phase 12c: an npz reference (slots in bfloat16) and a timed
    synchronous DCP write of the same state, each under ``<save_dir>``."""
    import torch
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.data import native
    from otgan_tpu_torch.utils import checkpoint as ckpt
    from otgan_tpu_torch.utils import checkpoint_orbax

    save_dir = argv[argv.index("--save_dir") + 1]
    t0 = time.time()
    result = train_mod.main(list(argv))
    torch.cuda.synchronize()
    report = {"wall_s": time.time() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "native": native.native_available(), "step": result.state.step}
    ckpt.save_checkpoint(os.path.join(save_dir, "reference"), result.state, 0,
                         slot_dtype="bfloat16")
    t0 = time.time()
    path = checkpoint_orbax.save_checkpoint(os.path.join(save_dir, "write_timing"), result.state,
                                            0, slot_dtype="bfloat16", async_write=False)
    report["dcp_write_s"] = time.time() - t0
    report["dcp_bytes"] = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    print("train_report: " + json.dumps(report), flush=True)
    return 0


def train_process(argv, what: str) -> dict:
    """``chip_smoke.py --train ARGV`` as its own process; its report."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = run_group([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--train", *argv],
                    MULTIHOST_TIMEOUT, env)
    if out.returncode != 0:
        raise AssertionError(f"{what} failed (rc {out.returncode}):\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-4000:]}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("train_report: "))
    return dict(json.loads(line[len("train_report: "):]), stdout=out.stdout)


def one_process_world() -> list:
    """The manual multi-host flags of a world of one process."""
    return ["--multihost", "--coordinator_address", f"localhost:{free_port()}",
            "--num_processes", "1", "--process_id", "0"]


def prefetch_phase(card: str) -> dict:
    """12b. One 5:1 cycle of ``--preset train_py --synthetic_data
    --multihost`` (a world of one process through the manual flags) with
    ``--host_prefetch`` and with ``--no_host_prefetch``, each its own
    process under ``--profile_dir`` and ``--no_fused_cycle`` (the gaps are
    read between step spans), writing ``orbax/2`` with
    ``--checkpoint_backend orbax --checkpoint_slot_dtype bfloat16``: cycle
    ms, img/s, peak memory, the device-idle ms between consecutive steps
    from the trace, 6 grid launches and no plain one; the two runs see the
    same batches (first step's dist bitwise equal, later ones within 1e-4)."""
    from otgan_tpu_torch.utils.tracing import step_gaps, trace_path

    runs = {}
    for label, flag in (("prefetch", "--host_prefetch"), ("inline", "--no_host_prefetch")):
        run_dir = os.path.join(REPO, "runs", f"chip_smoke_multihost_{label}")
        shutil.rmtree(run_dir, ignore_errors=True)
        argv = ["--preset", "train_py", "--synthetic_data", "--synthetic_size", "10000",
                "--max_epochs", "3", "--log_every_steps", "1", "--save_every_epochs", "3",
                "--checkpoint_backend", "orbax", "--checkpoint_slot_dtype", "bfloat16",
                "--save_dir", run_dir, "--profile_dir", os.path.join(run_dir, "trace"), flag,
                "--no_fused_cycle", *one_process_world()]
        rep = train_process(argv, f"the multihost cycle ({flag})")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = [r for r in recs if "kind" in r]
        launches = [r for r in recs if "epoch" in r][-1]["launches"]
        gaps = step_gaps(trace_path(os.path.join(run_dir, "trace")))
        cycle_ms = sum(r["step_ms"] for r in steps)
        # wall time from the first step's start to the last step's end: the
        # host work between steps (and the epochs' ends) included
        wall_ms = (steps[-1]["time"] - steps[0]["time"]) * 1e3 + steps[0]["step_ms"]
        runs[label] = dict(run_dir=run_dir, cycle_ms=cycle_ms, img_per_s=BATCH * len(steps)
                           / cycle_ms * 1e3, cycle_wall_ms=wall_ms, peak_gb=rep["peak_gb"],
                           native=rep["native"], steps_ms=[r["step_ms"] for r in steps],
                           dist=[r["dist"] for r in steps], entropy=[r["entropy"] for r in steps],
                           idle_ms_between_steps=gaps["idle_ms"],
                           gap_ms_between_steps=gaps["gaps_ms"],
                           h2d_copy_ms_in_gaps=gaps["copy_ms"], launches=launches,
                           dcp_write_s=rep["dcp_write_s"], dcp_bytes=rep["dcp_bytes"],
                           host_line=next((l for l in rep["stdout"].splitlines()
                                           if "host batches:" in l), ""))
        print(f"12b multihost cycle, world of one process, {flag} on {card}: "
              + json.dumps({k: v for k, v in runs[label].items() if k != "run_dir"}), flush=True)
        if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5:
            raise AssertionError(f"expected one 5:1 cycle, got {[r['kind'] for r in steps]}")
        if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
            raise AssertionError(f"non-finite dist or entropy in the multihost cycle ({flag})")
        check_tier_path(launches, "grid", f"the multihost cycle ({flag})", want=6)
        if not rep["native"] or "host batches: native" not in runs[label]["host_line"]:
            raise AssertionError(f"the multihost cycle ({flag}) did not take the native path")
        if len(gaps["idle_ms"]) != 5:
            raise AssertionError(f"the trace of the multihost cycle ({flag}) has "
                                 f"{len(gaps['idle_ms'])} step gaps, not 5")
    on, off = runs["prefetch"]["dist"], runs["inline"]["dist"]
    later = max(abs(a - b) for a, b in zip(on[1:], off[1:]))
    runs["first_dist_equal"], runs["later_dist_max_diff"] = on[0] == off[0], later
    print(f"12b prefetch on / off: cycle {runs['prefetch']['cycle_ms']:.1f} / "
          f"{runs['inline']['cycle_ms']:.1f} ms (wall {runs['prefetch']['cycle_wall_ms']:.1f} / "
          f"{runs['inline']['cycle_wall_ms']:.1f}); device idle between steps "
          f"{runs['prefetch']['idle_ms_between_steps']} / "
          f"{runs['inline']['idle_ms_between_steps']} ms; first dist equal "
          f"{runs['first_dist_equal']}, later max |d dist| {later:.3e}", flush=True)
    if not runs["first_dist_equal"] or later > 1e-4:
        raise AssertionError(f"prefetch changed the batches: dist {on} vs {off}")
    return runs


def dcp_phase(card: str, run_dir: str) -> dict:
    """12c. Phase 12b's ``orbax/2`` (DCP, bfloat16 slots) restored here into a
    fresh state, equal to the npz reference of the same final state (every
    tensor, the step and the optimizers' scalars); a resume in a new process
    with ``--load_params`` that says it read the DCP format, starts at epoch
    3 and takes 3 finite steps; then ``sample.py`` and ``evaluate.py``
    (random InceptionV3 weights, 1000 samples) on the directory."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from otgan_tpu_torch import evaluate as evaluate_mod
    from otgan_tpu_torch import sample as sample_mod
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.eval import random_weights as rw
    from otgan_tpu_torch.utils import checkpoint as ckpt

    step_dir = os.path.join(run_dir, "orbax", "2")
    if ckpt.latest_checkpoint(run_dir) != step_dir or ckpt.checkpoint_format(step_dir) != "dcp":
        raise AssertionError(f"phase 12b did not commit {step_dir}")
    cfg = TrainConfig.load(os.path.join(run_dir, "config.json"))
    engine = Engine(dataclasses.replace(cfg, data_dependent_init=False), "cuda")
    x_init = np.zeros((8, 32, 32, 3), np.uint8)
    restored, _ = engine.init_state(cfg.seed + 1, x_init)
    torch.cuda.synchronize()
    t0 = time.time()
    ckpt.restore_checkpoint(step_dir, restored)
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    reference, _ = engine.init_state(cfg.seed + 2, x_init)
    ckpt.restore_checkpoint(ckpt.latest_checkpoint(os.path.join(run_dir, "reference")), reference)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(ckpt._named_tensors(restored),
                                                            ckpt._named_tensors(reference)))
    scalars = [(getattr(o1, n1), getattr(o2, n2)) for (_, o1, n1), (_, o2, n2) in zip(
        ckpt._opt_scalars(restored), ckpt._opt_scalars(reference))]
    res = dict(restore_s=restore_s, step=restored.step, equal=same,
               dir_bytes=sum(os.path.getsize(os.path.join(step_dir, f))
                             for f in os.listdir(step_dir)))
    del engine, restored, reference
    torch.cuda.empty_cache()
    if not same or res["step"] != 6 or any(a != b for a, b in scalars):
        raise AssertionError(f"the DCP restore differs from the saved state: {res}")
    argv = ["--preset", "train_py", "--synthetic_data", "--synthetic_size", "15000",
            "--max_epochs", "4", "--log_every_steps", "1", "--save_every_epochs", "100",
            "--save_dir", run_dir, "--load_params", *one_process_world()]
    t0 = time.time()
    out = run_group([sys.executable, "-m", "otgan_tpu_torch.train", *argv], MULTIHOST_TIMEOUT,
                    dict(os.environ, PYTHONPATH=REPO))
    res["resume_wall_s"] = time.time() - t0
    if out.returncode != 0:
        raise AssertionError(f"the DCP resume failed (rc {out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-4000:]}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    resumed = [r for r in recs if "kind" in r and r["step"] > 6]
    res["resumed_steps"] = [{k: r[k] for k in ("step", "kind", "dist", "entropy")}
                            for r in resumed]
    if ("(dcp checkpoint format); resuming at epoch 3" not in out.stdout or len(resumed) != 3
            or not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"])
                       for r in resumed)):
        raise AssertionError(f"the DCP resume is wrong: {res}\n{out.stdout[-2000:]}")
    x = sample_mod.main(["--save_dir", run_dir, "--num_samples", "100"])
    if x.shape != (100, 32, 32, 3) or not np.isfinite(x).all():
        raise AssertionError(f"sample.py on the DCP run gave {x.shape}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dcp_eval_")
    keep_env = os.environ.get("OTGAN_INCEPTION_WEIGHTS")
    try:
        os.environ["OTGAN_INCEPTION_WEIGHTS"] = rw.save_npz(
            os.path.join(tmp, "inception_random.npz"), seed=2024, variant="tf2015",
            num_classes=1008)
        t0 = time.time()
        scores = evaluate_mod.main(["--save_dir", run_dir, "--num_samples", "1000",
                                    "--splits", "10"])
        res["evaluate_s"] = time.time() - t0
    finally:
        if keep_env is None:
            os.environ.pop("OTGAN_INCEPTION_WEIGHTS", None)
        else:
            os.environ["OTGAN_INCEPTION_WEIGHTS"] = keep_env
        shutil.rmtree(tmp, ignore_errors=True)
    res["evaluate"] = scores
    print(f"12c DCP checkpoint of the batch-5000 state on {card}: " + json.dumps(res), flush=True)
    if scores["checkpoint"] != step_dir or not math.isfinite(scores["inception_score"]):
        raise AssertionError(f"evaluate.py on the DCP directory: {scores}")
    return res


def two_hosts_phase(n_cards: int) -> dict:
    """12d. With two or more cards: two "hosts", two torchrun agents
    (``--nnodes 2``, c10d rendezvous on localhost), each with half the
    cards, running ``--multihost --matching_layout rows`` at batch 5000 for
    one 5:1 cycle, then a resume for one epoch. Each process must say
    ``process p/2 (local batch 2500)``; the local-step kernel's launches
    are rank 0's in ``metrics.jsonl``. On one card it says why it did not
    run and returns ``{}``."""
    if n_cards < 2:
        print("12d two hosts: not run: one card is visible, and each of the two torchrun "
              "agents needs its own card (NCCL refuses two ranks on one card)", flush=True)
        return {}
    k = n_cards // 2
    run_dir = os.path.join(REPO, "runs", "chip_smoke_two_hosts")
    shutil.rmtree(run_dir, ignore_errors=True)

    def both(extra) -> list:
        port = free_port()
        procs = []
        for node in range(2):
            env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=",".join(
                str(node * k + i) for i in range(k)))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
                   "--node_rank", str(node), f"--nproc_per_node={k}", "--rdzv_backend", "c10d",
                   "--rdzv_endpoint", f"localhost:{port}", "--rdzv_id", "chip_smoke",
                   "-m", "otgan_tpu_torch.train", "--multihost", "--matching_layout", "rows",
                   "--preset", "train_py", "--synthetic_data", "--synthetic_size", "10000",
                   "--log_every_steps", "1", "--save_every_epochs", "3", "--save_dir", run_dir,
                   *extra]
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True,
                                          start_new_session=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MULTIHOST_TIMEOUT)[0])
        finally:
            import signal

            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.communicate()
        for node, (p, out) in enumerate(zip(procs, outs)):
            print(out[-3000:], flush=True)
            if p.returncode != 0:
                raise AssertionError(f"two hosts: agent {node} exited {p.returncode}")
        return outs

    t0 = time.time()
    outs = both(["--max_epochs", "3"])
    wall = time.time() - t0
    joined = "\n".join(outs)
    for p in range(2):
        if f"process {p}/2 (local batch 2500)" not in joined:
            raise AssertionError(f"no process {p}/2 (local batch 2500) line")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "kind" in r]
    launches = [r for r in recs if "epoch" in r][-1]["launches"]
    res = dict(cards=n_cards, ranks_per_host=k, wall_s=wall, matcher=recs[0]["matcher"],
               launches=launches, steps=[{x: r[x] for x in ("kind", "dist", "entropy", "step_ms")}
                                         for r in steps])
    if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5 or not all(
            math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError(f"two hosts: the cycle is wrong: {res}")
    local = {t: n for t, n in launches.items()
             if t.startswith("local_step_") and t != "local_step_plain"}
    if not any(local.values()) or launches["local_step_plain"] or launches["col_potential_plain"]:
        raise AssertionError(f"two hosts: the local-step kernel did not run alone: {launches}")
    outs = both(["--max_epochs", "4", "--load_params"])
    if sum("resuming at epoch 3" in out for out in outs) != 2:
        raise AssertionError("two hosts: the resume did not start at epoch 3 on both hosts")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        resumed = [r for r in map(json.loads, f) if "kind" in r and r["step"] > 6]
    res["resumed_steps"] = [{x: r[x] for x in ("kind", "dist", "entropy")} for r in resumed]
    print(f"12d two hosts of {k} card(s) each: " + json.dumps(res), flush=True)
    if len(resumed) != 2 or not all(math.isfinite(r["dist"]) for r in resumed):
        raise AssertionError(f"two hosts: the resumed epoch is wrong: {res}")
    return res


# ---- 13. the last modules: matching precision, the fused cycle, the research layer ----
PRECISION_BAND = 1e-5  # DESIGN.md section 7: high against highest (the TPU's bf16_3x read 9.6e-7)
FUSED_REL = 1e-6  # the one allowed miss of bitwise: a library call that picks another algorithm


def precision_phase(card: str) -> dict:
    """13a. ``match_two_batch`` at batch 5000 (d 32768, lam 500, the grid
    tier) under ``--matching_precision highest``, ``high`` (3xTF32) and
    ``default`` (one TF32 pass): ms per match, and the matched features',
    ``dist``'s and entropy's deltas against ``highest`` and against the
    match on float64 costs; ``high`` must be within PRECISION_BAND of
    ``highest``, and TF32 must be off again after every match. Then one
    train_py cycle under ``--matching_precision high``."""
    import torch
    from otgan_tpu_torch import train as train_mod
    from otgan_tpu_torch.ops import costs
    from otgan_tpu_torch.ops.matching import calc_distance, match_two_batch

    gen = torch.Generator(device="cuda").manual_seed(13)
    fa, fb = unit_features(gen, BATCH, 32768), unit_features(gen, BATCH, 32768)

    def cost64(a, b):
        return (1.0 - a.double() @ b.double().T).float()

    def run(precision=None, cost_fn=None):
        kw = {"cost_fn": cost_fn} if cost_fn else {"precision": precision}
        m = match_two_batch(fa, fb, LAM, ITERS, use_pallas=True, **kw)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f"TF32 left on after a {precision or 'float64-cost'} match")
        return m, calc_distance(fa, fb, m)

    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {"highest": run("highest"), "float64_costs": run(cost_fn=cost64)}
    res = {}
    for p in ("highest", "high", "default"):
        m, dist = run(p)
        row = {"ms": cuda_ms(lambda: match_two_batch(fa, fb, LAM, ITERS, use_pallas=True,
                                                     precision=p), reps=3)}
        for against, (m0, d0) in ref.items():
            row[f"features_vs_{against}"] = max(float((a - b).abs().max())
                                                for a, b in zip(m[:4], m0[:4]))
            row[f"dist_vs_{against}"] = abs(float(dist) - float(d0))
            row[f"entropy_vs_{against}"] = abs(float(m.entropy) - float(m0.entropy))
        res[p] = row
    res["tf32_off_after"] = not torch.backends.cuda.matmul.allow_tf32
    # where high's time and error come from: one split of a (2500, 32768)
    # half, one product of two halves per precision, and each cost
    # matrix's error against float64 (the matched features' error follows)
    half_a, half_b = fa[:BATCH // 2], fb[:BATCH // 2]
    exact = 1.0 - half_a.double() @ half_b.double().T
    res["split_ms"] = cuda_ms(lambda: costs.tf32_split(half_a), reps=5)
    res["high_k_chunk"] = costs.HIGH_K_CHUNK
    for p in ("highest", "high", "default"):  # one cost matrix, operands split per call
        res[p]["cost_matmul_ms"] = cuda_ms(lambda: costs.cosine_cost(half_a, half_b, p), reps=5)
        res[p]["cost_vs_float64"] = float(
            (costs.cosine_cost(half_a, half_b, p).double() - exact).abs().max())
    del fa, fb, ref, half_a, half_b, exact
    torch.cuda.empty_cache()
    run_dir = os.path.join(REPO, "runs", "chip_smoke_high")
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_all_counts()
    result = train_mod.main(["--preset", "train_py", "--synthetic_data", "--synthetic_size",
                             "10000", "--max_epochs", "3", "--log_every_steps", "1",
                             "--matching_precision", "high", "--save_dir", run_dir])
    steps = result.steps
    res["train_py_high"] = {"steps_ms": [r["step_ms"] for r in steps],
                            "cycle_ms": sum(r["step_ms"] for r in steps),
                            "launches": train_mod.kernel_launches()}
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError("non-finite dist or entropy under --matching_precision high")
    check_tier_path(res["train_py_high"]["launches"], "grid", "the train_py cycle under high",
                    want=len(steps))
    del result
    torch.cuda.empty_cache()
    print(f"13a matching precision at batch {BATCH}, d 32768 on {card}: " + json.dumps(res),
          flush=True)
    if not res["high"]["features_vs_highest"] <= PRECISION_BAND:
        raise AssertionError(f"high misses the {PRECISION_BAND} band: {res['high']}")
    return res


def fused_run(argv, fused: bool) -> dict:
    """One trainer run in this process, fused or not: its steps, step ms,
    peak memory and launches."""
    import torch
    from otgan_tpu_torch import train as train_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.time()
    result = train_mod.main(argv + ([] if fused else ["--no_fused_cycle"]))
    torch.cuda.synchronize()
    out = {"wall_s": time.time() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "launches": train_mod.kernel_launches(),
           "steps": [(r["kind"], r["dist"], r["entropy"], r["step_ms"]) for r in result.steps]}
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fused_compare(label: str, argv, period: int, tier: str, card: str) -> dict:
    """13b for one configuration: unfused, then fused; per-step dist and
    entropy equal bit for bit (else within FUSED_REL, reported), the same
    launches, and each run's peak memory (allocated and reserved). The
    trainer's ``step_ms`` reads back once a cycle fused and once a step
    unfused, so its means are reported, not compared: the like-for-like
    times are :func:`replay_check`'s."""
    runs = {"unfused": fused_run(argv, False), "fused": fused_run(argv, True)}
    a, b = runs["unfused"]["steps"], runs["fused"]["steps"]
    if [s[0] for s in a] != [s[0] for s in b] or len(a) < 3 * period:
        raise AssertionError(f"{label}: schedules differ or too few steps: {len(a)} / {len(b)}")
    worst = max(abs(x - y) / max(abs(x), 1e-30) for s, t in zip(a, b) for x, y in
                ((s[1], t[1]), (s[2], t[2])))
    res = {"steps": len(a), "bitwise_equal": worst == 0.0, "max_rel_diff": worst,
           "launches": {k: {t: n for t, n in r["launches"].items() if n}
                        for k, r in runs.items()}}
    for k, r in runs.items():
        later = [s[3] for s in r["steps"][period:]]
        res[f"{k}_trainer_step_ms"] = sum(later) / len(later)
        res[f"{k}_peak_gb"] = r["peak_gb"]
        res[f"{k}_peak_reserved_gb"] = r["peak_reserved_gb"]
        res[f"{k}_wall_s"] = r["wall_s"]
    print(f"13b {label}, fused against unfused on {card}: " + json.dumps(res), flush=True)
    if worst > FUSED_REL:
        raise AssertionError(f"{label}: fused per-step dist/entropy differ by {worst:.3e}")
    if runs["unfused"]["launches"] != runs["fused"]["launches"]:
        raise AssertionError(f"{label}: launches differ: {res['launches']}")
    check_tier_path(runs["fused"]["launches"], tier, f"{label} fused", want=len(b))
    return res


def replay_check(card: str, label: str, cfg, batch_fn, kernel: str, reps: int) -> dict:
    """13b, through the engine: the eager warm-up cycle, ``reps`` eager
    cycles and ``reps`` replays of the captured cycle, each read back once
    at its end (ms a step both ways, the like-for-like comparison); the
    latents drawn in the graph differ between two replays, and a profiled
    replay shows one device event of ``kernel`` a step."""
    import statistics

    import numpy as np
    import torch
    from otgan_tpu_torch.engine import Engine

    eng = Engine(cfg, "cuda")
    rng = np.random.default_rng(0)
    period = cfg.nr_gen_per_disc + 1
    xs = [batch_fn(rng) for _ in range(period)]
    state, _ = eng.init_state(1, xs[0])
    drawn, latents = [], eng.latents

    def spy(batch, generator=None):
        z = latents(batch, generator)
        drawn.append(z.clone())  # under capture, the clone is the graph's
        return z

    cycle = [torch.from_numpy(x).cuda() for x in xs]
    state, _ = eng.cycle_step(state, cycle)  # the eager warm-up
    times = {"eager": [], "replay": []}
    for way, run in (("eager", eng.cycle), ("replay", eng.cycle_step)):
        if way == "replay":
            eng.latents = spy
            state, _ = run(state, cycle)  # the capture, then its first replay
            first = [z.clone() for z in drawn]
            state, _ = run(state, cycle)
            if any(torch.equal(a, b) for a, b in zip(first, drawn)):
                raise AssertionError(f"{label}: a replay drew the previous replay's latents")
            del eng.latents  # the spy out, and with it the cycle spy -> eng
        for _ in range(reps):
            t0 = time.perf_counter()
            state, mets = run(state, cycle)
            float(mets[-1].dist)
            times[way].append((time.perf_counter() - t0) * 1e3 / period)
    names = device_kernels(lambda: eng.cycle_step(state, cycle))
    events = [n for n in names if kernel in n]
    res = {"eager_ms_per_step": statistics.median(times["eager"]),
           "replay_ms_per_step": statistics.median(times["replay"]), "cycles_timed": reps,
           "device_kernels_in_replay": len(names), f"{kernel}_device_events": len(events),
           "latents_advance": True, "graphs": len(eng._graphs)}
    print(f"13b one cycle of {label} through the engine on {card}: " + json.dumps(res),
          flush=True)
    if len(events) != period:
        raise AssertionError(f"{label}: a profiled replay shows {len(events)} {kernel} events: "
                             f"{sorted(set(names))[:20]}")
    return res  # the engine, its graphs and their pool go with this frame


def fused_phase(card: str) -> dict:
    """13b. The trainer with and without ``--fused_cycle``: the toy (2
    epochs of TOY_EPOCH_BATCHES, 1:1), the DCGAN at batch 256 (three epochs
    of one 5:1 cycle) and train_py at batch 5000 (four epochs of 10
    batches: the eager warm-up, then the graphs of six schedules, full
    cycles and leftovers of 4, in one pool); then :func:`replay_check` for
    each of the three."""
    import numpy as np
    import torch
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.data.toy import sample_8gaussians

    toy_dir = os.path.join(REPO, "runs", "chip_smoke_fused_toy")
    os.environ["OTGAN_TOY_EPOCH_BATCHES"] = str(TOY_EPOCH_BATCHES)
    try:
        toy = fused_compare("toy", [
            "--model", "toy_mlp", "--batch_size", "512", "--sinkhorn_lambda", "50",
            "--nr_sinkhorn_iter", "10", "--nr_gen_per_disc", "1", "--max_epochs", "2",
            "--save_every_epochs", "100", "--log_every_steps", "1", "--save_dir", toy_dir],
            2, "resident", card)
    finally:
        del os.environ["OTGAN_TOY_EPOCH_BATCHES"]
    b256 = fused_compare("DCGAN batch 256", [
        "--synthetic_data", "--synthetic_size", "1536", "--max_epochs", "3",
        "--save_every_epochs", "100", "--log_every_steps", "1",
        "--save_dir", os.path.join(REPO, "runs", "chip_smoke_fused_b256")], 6, "resident", card)
    b5000 = fused_compare("train_py batch 5000", [
        "--preset", "train_py", "--synthetic_data", "--synthetic_size", "50000",
        "--max_epochs", "4", "--save_every_epochs", "100", "--log_every_steps", "1",
        "--save_dir", os.path.join(REPO, "runs", "chip_smoke_fused_b5000")], 6, "grid", card)

    def images(batch):
        return lambda rng: rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8)

    def released(res):
        gc.collect()
        torch.cuda.empty_cache()
        return res

    replays = {
        "toy": released(replay_check(card, "the toy", TrainConfig(
            model="toy_mlp", batch_size=512, sinkhorn_lambda=50.0, nr_sinkhorn_iter=10,
            nr_gen_per_disc=1), lambda rng: sample_8gaussians(rng, 512), "resident", 20)),
        "b256": released(replay_check(card, "the DCGAN at batch 256", TrainConfig(batch_size=256),
                                      images(256), "resident", 5)),
        "b5000": released(replay_check(card, "train_py at batch 5000", TrainConfig(
            batch_size=5000, nr_gen_per_disc=5), images(5000), "grid_sinkhorn", 2)),
    }
    return {"toy": toy, "b256": b256, "b5000": b5000, "replay": replays}


def research_phase(card: str) -> dict:
    """13c. ``ops/energy.py`` at (2500, 32768) on the card against the same
    call on the CPU (the residuals bit for bit, the loss to float32's
    reduction order), and ``examples/toy_baselines.py`` for 20 steps of each
    objective (finite; ``med_gan`` launches the resident kernel, 2 a step)."""
    import torch
    from otgan_tpu_torch.examples import toy_baselines
    from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc
    from otgan_tpu_torch.ops.energy import energy_distance

    gen = torch.Generator(device="cuda").manual_seed(7)
    fs = torch.randn((2500, 32768), generator=gen, device="cuda")
    fd = torch.randn((2500, 32768), generator=gen, device="cuda")
    loss, grads = energy_distance(fs, fd)
    loss_c, grads_c = energy_distance(fs.cpu(), fd.cpu())
    res = {"energy": {"ms": cuda_ms(lambda: energy_distance(fs, fd), reps=3),
                      "grads_equal": bool(torch.equal(grads.cpu(), grads_c)),
                      "loss_rel_diff": abs(float(loss) - float(loss_c)) / float(loss_c)}}
    del fs, fd, grads, grads_c
    if not res["energy"]["grads_equal"] or res["energy"]["loss_rel_diff"] > 1e-5:
        raise AssertionError(f"energy_distance on the card differs from the CPU: {res}")
    for model in toy_baselines.MODELS:
        reset_all_counts()
        t0 = time.time()
        gp, dp = toy_baselines.main(["--model", model, "--steps", "20", "--save_dir",
                                     os.path.join(REPO, "runs", "chip_smoke_baselines")])
        finite = all(bool(torch.isfinite(t).all()) for p in gp + dp for t in p.values())
        res[model] = {"s": time.time() - t0, "finite": finite,
                      "resident": rc.launches["kernel"]}
        if not finite or rc.launches["kernel"] != (40 if model == "med_gan" else 0):
            raise AssertionError(f"toy_baselines --model {model}: {res[model]}")
    print(f"13c the research layer on {card}: " + json.dumps(res), flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from otgan_tpu_torch.kernels.build import build_all
    from otgan_tpu_torch.ops import sinkhorn_cuda as sk
    from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
    from otgan_tpu_torch.ops.costs import cosine_cost
    from otgan_tpu_torch.ops.matching import match_two_batch, two_batch_costs
    from otgan_tpu_torch.ops.sinkhorn import sinkhorn_assignment
    from otgan_tpu_torch.ops.sinkhorn_resident_cuda import sinkhorn_resident_plain
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
    compare_with_plain(costs, "main-path")
    # ragged edges in both dims (100 rows of 16-row panels, 228 columns of
    # 256-thread blocks), from critic-width features like the main path's
    ragged = torch.stack([
        cosine_cost(unit_features(gen, 100, 32768), unit_features(gen, 228, 32768))
        for _ in range(6)
    ])
    ragged_x = compare_with_plain(ragged, "ragged")["x"]

    exp_rate = sfu_rate()
    b, n, m = costs.shape
    matcher_ms = cuda_ms(
        lambda: match_two_batch(feats_a, feats_b, LAM, ITERS, use_pallas=True), reps=2
    )
    print(f"matcher (6 costs, Sinkhorn kernel of the grid tier, softmax, 12 matched-feature "
          f"matmuls) at batch {BATCH}, d 32768: {matcher_ms:.3f} ms per match on {card}",
          flush=True)
    del feats_a, feats_b

    small = two_batch_costs(unit_features(gen, 128, 64), unit_features(gen, 128, 64))
    p_o, e_o = sinkhorn_f64(small, LAM, 200)
    # kernel 1's path, the public entry, which takes the resident tier here,
    # and the grid kernel on 132 blocks of one row
    for label, (p_k, e_k) in (("kernel 1 path", sk.sinkhorn_assignment_kernel(small, LAM, 200)),
                              ("resident tier", sinkhorn_assignment(small, LAM, 200,
                                                                    use_pallas=True)),
                              ("grid kernel", gc.sinkhorn_grid_cuda(small, LAM, 200))):
        d_or = float((p_k.double() - p_o).abs().max())
        de_or = float((e_k.double() - e_o).abs().max())
        print(f"{label} vs float64 Sinkhorn {tuple(small.shape)} lam={LAM}: "
              f"max|dP| {d_or:.3e}, max|d entropy| {de_or:.3e}", flush=True)
        if not (d_or <= P_TOL and de_or <= ENT_TOL):
            raise AssertionError(f"the {label} disagrees with the float64 Sinkhorn")

    # ---- 3b. the grid kernel vs plain and kernel 1 at its tier's shapes ----
    grid_held = {label: hold_grid(c, label, blocks)
                 for label, (c, blocks) in grid_shapes(gen, costs).items()}
    grid_t = {"ms": cuda_ms(lambda: gc.sinkhorn_grid_cuda(costs, LAM, ITERS), reps=10),
              "kernel1_path_ms": cuda_ms(lambda: sk.sinkhorn_assignment_kernel(costs, LAM, ITERS),
                                         reps=3),
              "plain_ms": cuda_ms(lambda: sinkhorn_resident_plain(costs, LAM, ITERS), reps=1),
              **match_bound(b, n, m, bw, flops, exp_rate), "matcher_ms": matcher_ms}
    print(f"grid tier at {tuple(costs.shape)} x {ITERS} iters on {card}: kernel "
          f"{grid_t['ms']:.3f} ms per match, kernel 1's path {grid_t['kernel1_path_ms']:.3f} ms, "
          f"plain {grid_t['plain_ms']:.3f} ms; bound {grid_t['bound_ms']:.4f} ms by "
          f"{grid_t['bound_by']} (expf alone at the MUFU rate {grid_t['sfu_floor_ms']:.4f} ms); "
          f"matcher at batch {BATCH} {matcher_ms:.3f} ms", flush=True)
    del costs
    torch.cuda.empty_cache()

    # ---- 4. the main path, counters zeroed just before ----
    save_dir = os.path.join(REPO, "runs", "chip_smoke")
    argv = ["--preset", "train_py", "--synthetic_data", "--synthetic_size", "10000",
            "--max_epochs", "3", "--log_every_steps", "1", "--save_dir", save_dir]
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.time()
    result = train_mod.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = train_mod.kernel_launches()
    steps = result.steps
    for rec in steps:
        print(f"step {rec['step']} ({rec['kind']}): dist {rec['dist']:.6f} "
              f"entropy {rec['entropy']:.6f} {rec['step_ms']:.1f} ms/step", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cycle_ms = sum(r["step_ms"] for r in steps)
    print(f"main path: {len(steps)} steps in {wall:.1f} s (init included); step ms "
          f"{[r['step_ms'] for r in steps]}, cycle {cycle_ms:.1f} ms "
          f"({BATCH * len(steps) / cycle_ms * 1e3:.0f} img/s); launches {launches}; peak "
          f"memory {peak_gb:.2f} GB on {card}", flush=True)
    if [r["kind"] for r in steps] != ["disc"] + ["gen"] * 5:
        raise AssertionError(f"expected one 5:1 cycle, got {[r['kind'] for r in steps]}")
    if not all(math.isfinite(r["dist"]) and math.isfinite(r["entropy"]) for r in steps):
        raise AssertionError("non-finite dist or entropy on the main path")
    check_tier_path(launches, "grid", "the main path (batch 5000, 6 x 2500^2)", want=len(steps))
    with torch.no_grad():
        imgs = result.state.gen(torch.zeros((4, 100), device="cuda"))
    if imgs.shape != (4, 32, 32, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError("generator output after training is malformed")

    del result, imgs
    torch.cuda.empty_cache()

    # ---- 4b. the traced cycle; 4c. the DenseNet path ----
    traced = trace_phase(card)
    torch.cuda.empty_cache()
    dn = densenet_phase(card)

    # ---- 5. the local-step kernels vs plain at one rank's blocks ----
    from otgan_tpu_torch.ops import sinkhorn_step_cuda as st

    costs = two_batch_costs(unit_features(gen, BATCH, 32768), unit_features(gen, BATCH, 32768))
    x5000 = sk.scaled_logits(costs, LAM)  # batch 5000: (6, 2500, 2500)
    del costs
    held = {"b5000_8gpu": hold_local_step(x5000, 8, "batch 5000 on 8 GPUs")}
    rank_b5000 = x5000[:, :313].contiguous()
    del x5000
    costs = two_batch_costs(unit_features(gen, 4000, 32768), unit_features(gen, 4000, 32768))
    x4000 = sk.scaled_logits(costs, LAM)  # batch 4000: (6, 2000, 2000)
    del costs
    held["b4000_4gpu"] = hold_local_step(x4000, 4, "batch 4000 on 4 GPUs")
    rank_fused = x4000[:, :500].contiguous()
    del x4000
    costs = two_batch_costs(unit_features(gen, 8000, 32768), unit_features(gen, 8000, 32768))
    x8000 = sk.scaled_logits(costs, LAM)  # batch 8000: (6, 4000, 4000)
    del costs
    held["b8000_4gpu"] = hold_local_step(x8000, 4, "batch 8000 on 4 GPUs", whole=True)
    rank_stream = x8000[:, :1000].contiguous()
    held["ragged"] = hold_local_step(ragged_x, 3, "ragged")
    if [st.local_step_mode(*s) for s in ((313, 2500), (500, 2000), (1000, 4000))] != [
            "fused", "fused", "stream"]:
        raise AssertionError("the tier rule no longer picks fused at (313, 2500) and (500, "
                             "2000) and stream at (1000, 4000)")
    # each tier at every rank's block, and the stream tier on the whole (6,
    # 4000, 4000) of a group of one; a tier's own numbers are at the block
    # its launches come from: (6, 500, 2000) fused, (6, 1000, 4000) stream
    blocks = {"6x313x2500": rank_b5000, "6x500x2000": rank_fused, "6x1000x4000": rank_stream}
    timing = {mode: {label: time_local_step(blk, mode, bw, flops, exp_rate)
                     for label, blk in blocks.items()}
              for mode in ("fused", "stream")}
    timing["stream"]["6x4000x4000"] = time_local_step(x8000, "stream", bw, flops, exp_rate)
    del x8000, blocks
    for mode, by_shape in timing.items():
        for label, t in by_shape.items():
            print(f"local step {mode} at {label} on {card}: {t['ms']:.4f} ms per step "
                  f"(plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
                  f"{t['bound_by']}); {t['ms_per_500_steps']:.3f} ms per {ITERS} steps with "
                  f"the v update (bound {t['bound_ms_per_500_steps']:.3f} ms); "
                  f"{t['launches_per_step']} device kernel a step; plan {t['plan']}", flush=True)
    del rank_b5000, rank_fused, rank_stream

    # ---- 6. the row-sharded matcher in a one-process NCCL group ----
    import torch.distributed as dist
    from otgan_tpu_torch.parallel.matching_sharded import make_sharded_two_batch_matcher

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    sharded, single_counts = {}, {}
    try:
        rows_matcher = make_sharded_two_batch_matcher(None, LAM, ITERS, use_pallas=True)
        for B in (2000, 8000):
            fa, fb = unit_features(gen, B, 32768), unit_features(gen, B, 32768)
            # the single-device matcher: the grid tier at batch 2000 (6 x
            # 1000^2), kernel 1 at batch 8000 (6 x 4000^2, above the grid
            # tier's ceiling), counters zeroed just before
            reset_all_counts()
            ref = match_two_batch(fa, fb, LAM, ITERS, use_pallas=True)
            torch.cuda.synchronize()
            single_counts[B] = train_mod.kernel_launches()
            want = "grid" if B == 2000 else "col_potential"
            check_tier_path(single_counts[B], want, f"the single-device matcher at batch {B}",
                            want=1)
            if B == 8000:
                # and at a ragged shape above the ceiling: (2, 2700, 2650)
                ragged_k1 = torch.stack([cosine_cost(unit_features(gen, 2700, 32768),
                                                     unit_features(gen, 2650, 32768))
                                         for _ in range(2)])
                k1 = time_kernel1(two_batch_costs(fa, fb), ragged_k1, bw, flops, exp_rate)
                del ragged_k1
                print(f"kernel 1 (the local-step kernel's v mode) at {k1['shape']} x {ITERS} "
                      f"iters, the single-device matcher's "
                      f"costs at batch {B}, on {card}: kernel {k1['ms']:.3f} ms, plain "
                      f"{k1['plain_ms']:.3f} ms; bound {k1['bound_ms']:.4f} ms by "
                      f"{k1['bound_by']} at {peak_key} peaks (expf alone "
                      f"{k1['sfu_floor_ms']:.4f} ms); streaming x every iteration needs "
                      f"{k1['stream_ms']:.3f} ms", flush=True)
            st.reset_launch_counts()
            sk.reset_launch_counts()
            got = rows_matcher(fa, fb)
            torch.cuda.synchronize()
            counts = {**{f"step_{k}": v for k, v in st.launches.items()},
                      "col_potential": sk.launches["kernel"],
                      "col_potential_plain": sk.launches["plain"]}
            tier = st.local_step_mode(B // 2, B // 2)
            d_feat = max(float((g - w).abs().max()) for g, w in zip(got[:4], ref[:4]))
            d_ent = abs(float(got.entropy) - float(ref.entropy))
            finite = all(bool(torch.isfinite(t).all()) for t in got[:4])
            rows_ms = cuda_ms(lambda: rows_matcher(fa, fb), reps=2)
            single_ms = cuda_ms(lambda: match_two_batch(fa, fb, LAM, ITERS, use_pallas=True),
                                reps=2)
            sharded[tier] = dict(batch=B, launches=counts[f"step_{tier}"], counts=counts,
                                 max_abs_dfeatures=d_feat, dentropy=d_ent,
                                 row_sharded_matcher_ms=rows_ms, single_device_matcher_ms=single_ms)
            print(f"row-sharded matcher, NCCL group of 1, batch {B} (block "
                  f"({6}, {B // 2}, {B // 2}), tier {tier}): launches {counts}; vs the "
                  f"single-device matcher max|d features| {d_feat:.3e}, |d entropy| "
                  f"{d_ent:.3e}; {rows_ms:.3f} ms per match vs {single_ms:.3f} ms on {card}",
                  flush=True)
            if counts[f"step_{tier}"] < 1 or counts["step_plain"] != 0:
                raise AssertionError(f"the row-sharded matcher did not run the {tier} kernel: "
                                     f"{counts}")
            if not (finite and d_feat <= 1e-4 and d_ent <= ENT_TOL):
                raise AssertionError(f"row-sharded matcher disagrees at batch {B}")
            del fa, fb, ref, got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- 7. several GPUs ----
    multi = multi_gpu_phase(torch.cuda.device_count())

    # ---- 8. the resident kernel vs plain and kernel 1 at its tier's shapes ----
    torch.cuda.empty_cache()
    resident = {label: hold_resident(c, label, bw, flops, exp_rate)
                for label, c in resident_shapes(gen).items()}
    clusters = resident_clusters(two_batch_costs(unit_features(gen, 256, 32768),
                                                 unit_features(gen, 256, 32768)),
                                 bw, flops, exp_rate)

    # ---- 9. the toy path: train, resume, sample; 10. the DCGAN at batch 256 ----
    toy = toy_phase(card)
    b256 = dcgan_b256_phase(card)

    # ---- 10b. the eval path; 10c. resume from a JAX-format checkpoint ----
    b256_dir = os.path.join(REPO, "runs", "chip_smoke_b256")
    torch.cuda.empty_cache()
    evaluation = eval_phase(card, b256_dir)
    jax_resume = jax_resume_phase(card, b256_dir)

    # ---- 12a-12d. several hosts: the native assembler, prefetch, DCP ----
    torch.cuda.empty_cache()
    native = native_phase(card)
    multihost = prefetch_phase(card)
    dcp = dcp_phase(card, multihost["prefetch"]["run_dir"])
    two_hosts = two_hosts_phase(torch.cuda.device_count())

    # ---- 13a-13c. matching precision, the fused cycle, the research layer ----
    precision = precision_phase(card)
    fused = fused_phase(card)
    research = research_phase(card)

    # ---- 11. the kernels line ----
    no_loop_library = "no single PyTorch call runs n Sinkhorn iterations"
    kernels = [{
        "name": "sinkhorn_grid",
        "route": "cuda",
        "source": "otgan_tpu_torch/csrc/sinkhorn_grid.cu",
        "replaces": "otgan_tpu/ops/sinkhorn_pallas_tiled.py:64",
        "launches": launches["grid"],
        "launches_from": "phase 4: the main path, one 5:1 cycle of --preset train_py at batch "
                         "5000 in epochs of 2 batches (in-process counters); phase 4c: "
                         "launches_densenet in one 5:1 cycle of the DenseNet at batch 5000, "
                         "unfused; phase 4b: trace_device_events in the traced cycle; phase "
                         "12b: launches_multihost in the --multihost cycles with and without "
                         "--host_prefetch (rank 0's metrics.jsonl); phase 13b: "
                         "launches_fused_b5000 in 4 epochs of 10 batches of train_py, fused, "
                         "and replay_device_events in one profiled replay. Under --fused_cycle "
                         "a replay's launches are its capture's counted launches, added once "
                         "per replay: bookkeeping, which replay_device_events confirms on the "
                         "card",
        "launches_densenet": dn["launches"]["grid"],
        "launches_multihost": [multihost[k]["launches"]["grid"] for k in ("prefetch", "inline")],
        "trace_device_events": traced["grid_device_events"],
        "launches_per_step": launches["grid"] / len(steps),
        "max_abs_err": max(r["max_abs_dP"] for r in grid_held.values()),
        **grid_t,
        "library_ms": None,
        "library_null_reason": no_loop_library,
        "shape": [b, n, m],
        "n_iters": ITERS,
        "plan": grid_held["main_6x2500"]["plan"],
        "held": grid_held,
        "main_path_ms_per_step": [r["step_ms"] for r in steps],
        "main_path_cycle_ms": cycle_ms,
        "main_path_peak_gb": peak_gb,
        "trace_phase_device_ms": traced["phase_device_ms"],
        "densenet_b5000": dn,
        "launches_fused_b5000": fused["b5000"]["launches"]["fused"].get("grid", 0),
        "replay_device_events": fused["replay"]["b5000"]["grid_sinkhorn_device_events"],
        "fused_b5000": fused["b5000"],
        "replay_b5000": fused["replay"]["b5000"],
        "matching_precision_b5000": precision,
    }, {
        "name": "sinkhorn_col_potential",
        "route": "cuda",
        "source": "otgan_tpu_torch/csrc/sinkhorn_step.cu",
        "replaces": "otgan_tpu/ops/sinkhorn_pallas_tiled.py:64",
        "design": "the local-step kernel in its v mode, one launch an iteration, one C call "
                  "a match (otgan_col_potential)",
        "launches": single_counts[8000]["col_potential"],
        "launches_from": "phase 6: the single-device matcher at batch 8000 (6 x 4000^2, above "
                         "the grid tier's ceiling), counters zeroed just before; the main path "
                         "takes the grid tier. Every time of this entry is at that shape, on "
                         "the matcher's costs; held also at a ragged (2, 2700, 2650)",
        "at_6x2500_ms": grid_t["kernel1_path_ms"],
        **k1,
        "library_ms": None,
        "library_null_reason": no_loop_library,
        "n_iters": ITERS,
    }]
    no_library = ("no single PyTorch call computes the (m, s) column partials of a "
                  "Sinkhorn row step")
    for mode, line, own, shapes, names in (
            ("fused", 113, "6x500x2000", ["b5000_8gpu", "b4000_4gpu", "ragged"], ["fused"]),
            ("stream", 218, "6x1000x4000", ["b8000_4gpu", "ragged"],
             ["stream", "stream_walk", "stream_whole"])):
        kernels.append({
            "name": f"sinkhorn_local_step_{mode}",
            "route": "cuda",
            "source": "otgan_tpu_torch/csrc/sinkhorn_step.cu",
            "replaces": f"otgan_tpu/ops/sinkhorn_pallas_step.py:{line}",
            "launches": (multi[mode]["launches"][f"local_step_{mode}"] if multi
                         else sharded[mode]["launches"]),
            "launches_from": (f"rank 0 of training on {multi[mode]['gpus']} GPUs "
                              f"({multi[mode]['preset']})" if multi else
                              "phase 6: the row-sharded matcher in a one-process NCCL group "
                              "(one card: the training path's own counts were not read)"),
            "max_abs_err": max(held[k][n]["max_abs_dP"] for k in shapes for n in names
                               if "max_abs_dP" in held[k].get(n, {})),
            **timing[mode][own],
            "at_both_rank_blocks": timing[mode],
            "library_ms": None,
            "library_null_reason": no_library,
            "held": {k: {n: held[k][n] for n in names if n in held[k]} for k in held},
            "path": sharded[mode],
            "multi_gpu_training": multi.get(mode),
            "launches_two_hosts": (two_hosts["launches"][f"local_step_{mode}"] if two_hosts
                                   else None),
        })
    own = resident["toy_b512"]  # the shape of the slice's path
    from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc

    planned = rc.resident_plan(*own["shape"][1:]).cluster  # ITERS barriers at the toy's plan
    resident_floor = {"barrier_floor_ms": cuda_ms(
        lambda: rc.barrier_loop_cuda(planned, own["shape"][0], ITERS), reps=10),
        "shape": own["shape"], "cluster": planned}
    kernels.append({
        "name": "sinkhorn_resident",
        "route": "cuda",
        "source": "otgan_tpu_torch/csrc/sinkhorn_resident.cu",
        "replaces": "otgan_tpu/ops/sinkhorn_pallas.py:58",
        "launches": toy["launches"]["resident"],
        "launches_from": (f"phase 9: the toy run, 2 epochs of {TOY_EPOCH_BATCHES} steps at batch "
                          "512 (rank 0's metrics.jsonl); phase 10: "
                          f"{b256['launches']['resident']} in the DCGAN's 5:1 cycle at batch 256; "
                          "phase 13b: launches_fused in the fused toy and batch-256 runs, "
                          "replay_device_events in one profiled replay of each. Under "
                          "--fused_cycle a replay's launches are its capture's counted launches, "
                          "added once per replay: bookkeeping, which replay_device_events "
                          "confirms on the card"),
        "max_abs_err": max(r["max_abs_dP"] for r in resident.values()),
        "ms": own["ms"],
        "plain_ms": own["plain_ms"],
        "bound_ms": own["bound_ms"],
        "bound_by": own["bound_by"],
        "sfu_floor_ms": own["sfu_floor_ms"],
        "library_ms": None,
        "library_null_reason": no_loop_library,
        "shape": own["shape"],
        "n_iters": ITERS,
        "plan": own["plan"],
        "barrier_floor_ms": resident_floor["barrier_floor_ms"],
        "barrier_floor_at": resident_floor["shape"],
        "held": resident,
        "clusters_6x128": clusters,
        "toy_path": toy,
        "dcgan_b256": b256,
        "launches_fused": {k: fused[k]["launches"]["fused"].get("resident", 0)
                           for k in ("toy", "b256")},
        "replay_device_events": {k: fused["replay"][k]["resident_device_events"]
                                 for k in ("toy", "b256")},
        "launches_toy_baselines_med_gan": research["med_gan"]["resident"],
        "fused": {k: fused[k] for k in ("toy", "b256")},
        "replay": {k: fused["replay"][k] for k in ("toy", "b256")},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--ranks"]:
        sys.exit(ranks_check())
    if sys.argv[1:2] == ["--train"]:
        sys.exit(train_report(sys.argv[2:]))
    sys.exit(main())
