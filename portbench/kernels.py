"""Classes of device kernels by name, for the per-layer readers.

* ``sinkhorn``: the hand-written Sinkhorn kernels of every tier (the grid
  kernel, the local-step kernel that the row-sharded matcher and the
  column-potential loop launch, the resident kernel);
* ``nccl``: NCCL's collectives;
* ``gemm_f32``: cuBLAS's float32 (and TF32) matrix products: in these
  configurations only the matcher multiplies in float32, the models
  multiply in bf16;
* ``model``: everything else (bf16 convs and products, their casts and
  layout copies, elementwise work, the optimizer, the EMA).
"""

from __future__ import annotations

import functools
import re

SINKHORN = re.compile(r"grid_sinkhorn|local_step|resident_sinkhorn")
NCCL = re.compile(r"^nccl", re.IGNORECASE)
# a product kernel (cuBLAS's sgemm, xmma, cutlass and nvjet families) that
# multiplies float32 or TF32 operands
GEMM = re.compile(r"gemm|nvjet", re.IGNORECASE)
HALF = re.compile(r"bf16|f16|fp16|half|bfloat|hsh|bhb|_h_|tst", re.IGNORECASE)
CONV = re.compile(r"conv|fprop|dgrad|wgrad|implicit", re.IGNORECASE)
CLASSES = ("sinkhorn", "nccl", "gemm_f32", "model")


@functools.lru_cache(maxsize=None)
def category(name: str) -> str:
    if SINKHORN.search(name):
        return "sinkhorn"
    if NCCL.search(name):
        return "nccl"
    if GEMM.search(name) and not HALF.search(name) and not CONV.search(name):
        return "gemm_f32"
    return "model"
