#!/usr/bin/env python3
"""train_py and the DenseNet fused and unfused over CIFAR-10's epochs: ``python3 measure_fused.py``.

Run from the root of a checkout on a machine with a CUDA card. The trainer
at ``--preset train_py`` (the DCGAN) and at ``--preset train_py --model
densenet --grad_accum 4`` (the reference's DenseNet at full width), both
at batch 5000 on 50 000 synthetic images, so epochs of 10 batches as on
CIFAR-10: four epochs start at step offsets 0, 4, 2 and 0 of the 5:1
schedule, so the fused run captures the graphs of six schedules (full
cycles and leftovers of 4) into one memory pool. Each configuration runs
once with ``--no_fused_cycle`` and once with ``--fused_cycle``, in this
process: the peak device memory allocated and reserved of each run,
whether every step's dist and entropy are equal bit for bit, the grid
kernel's launches and the trainer's mean ``step_ms`` after the first
epoch (read back once a cycle fused, once a step unfused). Whether the
DenseNet fits on one card fused is what ``chip_smoke.py``'s phase 4c rests
on. The last line is one JSON object with every run and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
EPOCHS = 4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("measure_fused: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import DENSENET_ACCUM, card_line, fused_run
    from otgan_tpu_torch.kernels.build import build_all

    card = card_line()
    print(card, flush=True)
    build_all()
    common = ["--preset", "train_py", "--synthetic_data", "--synthetic_size", "50000",
              "--max_epochs", str(EPOCHS), "--save_every_epochs", "100", "--log_every_steps",
              "1"]
    configs = {"train_py": [],
               "densenet": ["--model", "densenet", "--grad_accum", str(DENSENET_ACCUM),
                            "--init_batch_size", "500"]}
    res = {"card": card}
    for name, extra in configs.items():
        argv = common + extra + ["--save_dir", os.path.join(REPO, "runs", f"measure_fused_{name}")]
        runs = {k: fused_run(argv, k == "fused") for k in ("unfused", "fused")}
        a, b = runs["unfused"]["steps"], runs["fused"]["steps"]
        res[name] = {"bitwise_equal": [s[:3] for s in a] == [s[:3] for s in b]}
        for k, r in runs.items():
            later = [s[3] for s in r["steps"][10:]]
            res[name][k] = {"peak_gb": r["peak_gb"], "peak_reserved_gb": r["peak_reserved_gb"],
                            "wall_s": r["wall_s"], "trainer_step_ms": sum(later) / len(later),
                            "grid": r["launches"]["grid"], "steps": len(r["steps"])}
        print(f"{name}: {json.dumps(res[name])}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
