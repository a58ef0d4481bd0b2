"""Readings that set a cell's limits (``workloads/<cell>.json``): the
check's numbers for the program, for its lower-precision path (the
control) and for the program with a fault planted, on many seeds in one
process (rank 0 prints one JSON line a reading).

``python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --variants
program,control,stale [--seconds 1]``

* ``control``: ``--matching_precision default`` (the matcher's products in
  one TF32 pass), the precision below the configuration's float32;
* ``unchanged``: every step returns its state unchanged (no optimizer
  update);
* ``half``: each step leaves out half of its batch and takes the mean over
  the rest (the gradient of the first half, doubled);
* ``stale``: a graph replays on the batches of its capture, not on the
  call's (a fault of replays alone: the eager first cycle and each graph's
  first replay read the right batches);
* ``no_exchange``: on K ranks, the gradients are not summed over the ranks;
* ``f32_reference``: the program as it is, against a reference whose
  models compute in float32 instead of the configuration's bf16.

Each reading is a whole run of the cell (``harness.run``), with a window of
``--seconds``, and prints the check's numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from portbench.run import ROOT, cache_env


class _StaleGraphs(dict):
    """An engine's graphs, each handed out to replay on its capture's
    batches."""

    def get(self, key, default=None):
        graph = super().get(key, default)
        return None if graph is None else _Stale(graph)


class _Stale:
    def __init__(self, graph):
        self.graph = graph

    def replay(self, state, xs):
        return self.graph.replay(state, self.graph.static_xs)


def plant(variant: str):
    """``(extra flags, engine patch)`` of a variant."""
    if variant in ("program", "f32_reference"):
        return (), None
    if variant == "control":
        return ("--matching_precision", "default"), None
    if variant == "unchanged":
        def patch(engine):
            engine.opt_update = lambda *a, **k: None
        return (), patch
    if variant == "half":
        def patch(engine):
            for name in ("_gen_grads", "_disc_grads"):
                orig = getattr(engine, name)

                def halved(state, x, z, orig=orig):
                    h = x.shape[0] // 2
                    grads, loss, dist, m = orig(state, x[:h], z[:h])
                    return [2.0 * g for g in grads], loss, dist, m

                setattr(engine, name, halved)
        return (), patch
    if variant == "stale":
        def patch(engine):
            engine._graphs = _StaleGraphs()
        return (), patch
    if variant == "no_exchange":
        def patch(engine):
            engine._sum_grads = lambda grads: grads
        return (), patch
    raise ValueError(f"unknown variant {variant!r}")


def readings(cell, seeds, variants, seconds: float) -> None:
    import torch

    from otgan_tpu_torch.config import parse_args
    from otgan_tpu_torch.train import maybe_init_distributed
    from portbench import harness

    device = maybe_init_distributed(parse_args(cell.config["argv"]), "cuda")
    for variant in variants:
        extra, patch = plant(variant)
        ref_cell = None
        if variant == "f32_reference":
            ref_cell = dataclasses.replace(cell, config=dict(cell.config, compute_dtype="float32"))
        for seed in seeds:
            t = time.time()
            out = harness.run(cell, seed, seconds, False, t, device, extra, patch, ref_cell)
            harness.free_device(device)
            if out is not None:
                info = out["info"]
                print(json.dumps({"cell": cell.name, "variant": variant, "seed": seed,
                                  "numbers": info["numbers"], "readings": info["readings"],
                                  "steps": info["steps"],
                                  "run_s": time.time() - t, "setup_s": info["setup_s"],
                                  "card": torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--worker", action="store_true")
    args = p.parse_args(argv)
    cache_env(ROOT)
    from portbench import spec

    cell = spec.load(ROOT, args.workload)
    if cell.chips > 1 and not args.worker:
        from portbench.launch import ranks

        proc = ranks("portbench.calibrate", ["--workload", args.workload, "--seeds", args.seeds,
                                             "--variants", args.variants, "--seconds",
                                             str(args.seconds)], cell.chips, 3000, ROOT)
        print(proc.stdout, flush=True)
        print(proc.stderr[-8000:], file=sys.stderr, flush=True)
        return proc.returncode
    readings(cell, [int(s) for s in args.seeds.split(",")], args.variants.split(","),
             args.seconds)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
