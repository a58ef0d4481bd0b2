#!/usr/bin/env python3
"""Which flags fit ``--preset model_saving`` (batch 8000, 3:1) on one card: ``python3 measure_fit_b8000.py``.

Run from the root of a checkout on a machine with a CUDA card. The trainer
at ``--preset model_saving --synthetic_data --synthetic_size 32000``, so an
epoch is one whole 3:1 cycle (a critic step and three generator steps),
three epochs, fused (``--fused_cycle``: the first cycle eager, the second
captured and replayed, the third replayed) and with ``--no_fused_cycle``,
with and without ``--remat``, at ``--grad_accum`` 1, 2, 4 and 8, each in
this process after the last one's memory is handed back. For each: whether
it ran to its end, whether the fused cycle held (a capture that runs out of
memory turns the run eager and says so), the peak device memory allocated
and reserved, and ms a cycle: the third epoch's steps, the sum of the
trainer's ``step_ms`` (one group's wall time over its steps, one readback a
cycle fused, one a step unfused). The trainer's output goes to
``runs/measure_fit_b8000/<config>.log``. The last line is one JSON object
with every configuration and the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
EPOCHS = 3
ACCUMS = (1, 2, 4, 8)


def release() -> None:
    """Hand the last run's memory back to the card."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()


def run(name: str, argv: list) -> dict:
    """One trainer run in this process, its output to a log file."""
    import torch
    from otgan_tpu_torch import train as train_mod

    release()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_reserved() / 1e9
    out_dir = os.path.join(REPO, "runs", "measure_fit_b8000")
    os.makedirs(out_dir, exist_ok=True)
    save_dir = os.path.join(out_dir, name)
    t0 = time.time()
    res = {"reserved_before_gb": base_gb}
    try:
        with open(os.path.join(out_dir, f"{name}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            result = train_mod.main(argv + ["--save_dir", save_dir])
        torch.cuda.synchronize()
        steps = result.steps
        recs = [json.loads(line) for line in open(os.path.join(save_dir, "metrics.jsonl"))]
        fused = [r["fused_cycle_effective"] for r in recs if "fused_cycle_effective" in r]
        res.update(fits=True, steps=len(steps), fused_cycle_effective=fused[-1],
                   fused_cycle_reason=[r["fused_cycle_reason"] for r in recs
                                       if "fused_cycle_reason" in r][-1],
                   cycle_ms=sum(r["step_ms"] for r in steps[-4:]),
                   step_ms=[r["step_ms"] for r in steps])
        del result
    except RuntimeError as e:  # the allocator's, or a library's "CUDA error: out of memory"
        if "out of memory" not in str(e):
            raise
        res.update(fits=False, error=str(e).splitlines()[0][:300])
    res.update(wall_s=time.time() - t0, peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("measure_fit_b8000: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    from otgan_tpu_torch.kernels.build import build_all

    card = card_line()
    print(card, flush=True)
    build_all()
    common = ["--preset", "model_saving", "--synthetic_data", "--synthetic_size", "32000",
              "--max_epochs", str(EPOCHS), "--save_every_epochs", "100", "--eval_every_epochs",
              "100", "--log_every_steps", "1"]
    table = {"card": card}
    for remat in (True, False):
        for fused in (True, False):
            for accum in reversed(ACCUMS):
                name = (f"{'fused' if fused else 'unfused'}_{'remat' if remat else 'plain'}"
                        f"_accum{accum}")
                argv = common + ["--grad_accum", str(accum)] + (["--remat"] if remat else []) \
                    + ([] if fused else ["--no_fused_cycle"])
                table[name] = run(name, argv)
                print(f"{name} on {card}: {json.dumps(table[name])}", flush=True)
    release()
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
