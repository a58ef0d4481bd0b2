"""The yardstick: the card's published peaks, and the work of one training
step counted from the shapes a configuration file states.

Nothing here reads the program. The operations of a step are counted from
the layer table of the configuration (``flops`` in its JSON file), the
matcher's from the batch and the feature width, and the Sinkhorn loop's
least time from the matching problem, so every count stays valid whatever
kernel a later change puts on the path.

Peaks (NVIDIA's data sheets, dense, SXM part at its 700 W limit unless the
name says otherwise): bf16 tensor cores, float32 outside the tensor cores,
memory bytes a second. The special-function units' ``expf`` rate is the
card's SMs x 16 MUFU.EX2 a clock x its maximum SM clock.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Sequence

# name fragment -> (bf16 FLOP/s, float32 FLOP/s, bytes/s); the first match wins
PEAKS = (
    ("H100 PCIe", (756e12, 51e12, 2.0e12)),
    ("H100 NVL", (835e12, 60e12, 3.9e12)),
    ("H100", (989e12, 67e12, 3.35e12)),
)
# float32 operations per matrix cell and Sinkhorn iteration: the row step's
# add, max, subtract and sum, and the column step's four; beside them one
# expf per cell and half-step on the special-function units
OPS_PER_CELL_ITER = 8
EXPS_PER_CELL_ITER = 2
MUFU_PER_SM_CLOCK = 16


def peaks(device_name: str) -> Dict[str, float]:
    for key, (bf16, f32, bw) in PEAKS:
        if key in device_name:
            return {"bf16": bf16, "f32": f32, "bytes": bw}
    raise RuntimeError(f"no published peaks known for {device_name!r}")


def exp_rate(sm_count: int) -> float:
    """expf a second at the card's peak, from ``nvidia-smi``'s maximum SM
    clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return sm_count * MUFU_PER_SM_CLOCK * mhz * 1e6


def conv_flops(layer: Sequence[int]) -> float:
    """Forward FLOPs of one image through ``[c_in, c_out, k_h, k_w, h_out,
    w_out]`` (a dense layer is ``[n_in, n_out, 1, 1, 1, 1]``); c_in counts
    the channels the layer reads after its pre-activation (CReLU doubles
    them)."""
    c_in, c_out, kh, kw, ho, wo = layer
    return 2.0 * c_in * c_out * kh * kw * ho * wo


def model_flops(table: Dict[str, Sequence[Sequence[int]]], disc_step: bool) -> float:
    """bf16 model FLOPs per image of one step, forward and backward, no
    recomputation. A generator step: G forward, D forward on the fakes
    (input gradient through every D layer, no D weight gradient) and on the
    data, then G's weight gradients and its input gradients but the first
    layer's (the latent needs none). A critic step: G forward, D forward on
    both batches, D's weight gradients on both and its input gradients but
    the first layer's (images need none)."""
    gen = [conv_flops(layer) for layer in table["gen"]]
    disc = [conv_flops(layer) for layer in table["disc"]]
    g, d = sum(gen), sum(disc)
    if disc_step:
        return g + 2 * d + 2 * d + 2 * (d - disc[0])
    return g + 2 * d + d + g + (g - gen[0])


def gemm_flops(batch: int, feature_dim: int, ranks: int = 1) -> float:
    """float32 GEMM FLOPs of one two-batch match on one of ``ranks`` ranks:
    6 cost matrices of (B/2)^2 cells over d, and 12 matched-feature products
    of the same size, each rank computing its rows."""
    n = batch // 2
    return 18 * 2.0 * n * n * feature_dim / ranks


def sinkhorn_bound_s(n_mats: int, rows: int, cols: int, iters: int, pk: Dict[str, float],
                     exp_per_s: float) -> float:
    """Least time of one match's Sinkhorn loop on ``(n_mats, rows, cols)``
    (this rank's rows): the costs read once and P and the entropies written
    once at the memory rate, or the loop's float32 operations at their peak
    and its expf on the special-function units, the largest."""
    cells = n_mats * rows * cols
    bytes_s = 4.0 * (2 * cells + n_mats * rows) / pk["bytes"]
    ops_s = OPS_PER_CELL_ITER * cells * iters / pk["f32"]
    sfu_s = EXPS_PER_CELL_ITER * cells * iters / exp_per_s
    return max(bytes_s, ops_s, sfu_s)


def step_least_s(cfg: dict, disc_step: bool, ranks: int, pk: Dict[str, float],
                 exp_per_s: float) -> Dict[str, float]:
    """The least time of one step on one of ``ranks`` ranks, by part:
    ``model`` (bf16 at the tensor cores' peak), ``gemm`` (the matcher's
    float32 products, TF32 being barred) and ``sinkhorn``."""
    batch, d = cfg["batch_size"], cfg["feature_dim"]
    n = batch // 2
    return {
        "model": model_flops(cfg["flops"], disc_step) * batch / ranks / pk["bf16"],
        "gemm": gemm_flops(batch, d, ranks) / pk["f32"],
        "sinkhorn": sinkhorn_bound_s(6, n // ranks, n, cfg["nr_sinkhorn_iter"], pk, exp_per_s),
    }
