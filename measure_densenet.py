#!/usr/bin/env python3
"""The DenseNet at the reference batch on one card: ``python3 measure_densenet.py``.

Run from the root of a checkout on a machine with a CUDA card. At full
width (``--model densenet``: 16 layers a block, 16 filters), batch 5000,
bf16 model compute, the grid tier's Sinkhorn (lam 500, 500 iterations), it
builds one engine, then for each step kind (critic, generator) and each
``--grad_accum`` M in ``ACCUMS`` (microbatches of 5000 / M, the largest
first), without and with ``--remat``, runs two steps and prints the second
step's time and the peak device memory of both
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``), or
that the step ran out of memory. The last line is one JSON object with the
table and the card's ``nvidia-smi`` name and power limit; the largest
microbatch that fits each kind is what ``chip_smoke.py``'s DenseNet phase
rests on.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

BATCH = 5000
ACCUMS = (2, 4, 5, 10)  # microbatches 2500, 1250, 1000, 500


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("measure_densenet: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.kernels.build import build_all

    card = card_line()
    print(card, flush=True)
    build_all()
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    table = {}
    for remat in (False, True):
        cfg = TrainConfig(model="densenet", batch_size=BATCH, grad_accum=5, remat=remat)
        eng = Engine(cfg)
        state, nf = eng.init_state(0, x[:500])
        for kind in ("disc", "gen"):
            step = eng.disc_step if kind == "disc" else eng.gen_step
            for m in ACCUMS:
                eng.cfg = dataclasses.replace(cfg, grad_accum=m)
                label = f"{kind} remat={remat} mb={BATCH // m}"
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                try:
                    times = []
                    for _ in range(2):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, met = step(state, x)
                        dist = float(met.dist)
                        times.append((time.perf_counter() - t0) * 1e3)
                except torch.cuda.OutOfMemoryError:
                    table[label] = "out of memory"
                    print(f"{label}: out of memory on {card}", flush=True)
                    continue
                peak = torch.cuda.max_memory_allocated() / 1e9
                ms = times[-1]
                table[label] = {"ms": ms, "first_ms": times[0], "img_per_s": BATCH / ms * 1e3,
                                "peak_gb": peak, "dist": dist}
                print(f"{label}: {ms:.1f} ms a step ({BATCH / ms * 1e3:.0f} img/s), peak "
                      f"{peak:.2f} GB on {card}", flush=True)
        del eng, state
    print(json.dumps({"card": card, "batch": BATCH, "features": nf, "table": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
