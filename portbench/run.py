"""The port's benchmark: ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Runs one cell of ``BENCHMARK.json`` on the cards of this machine and
prints, as its last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those whose distance
or entropy came back non-finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number of the
check with its limit, which also close standard error. An earlier line
gives the window's calls, launch counters and replays a call.

Without a card, or with fewer than the cell asks for, it fails and prints
no result. A cell on K > 1 chips runs K rank processes under ``torchrun``;
rank 0 prints. Caches go under ``.portbench_cache/`` in the checkout, and
the program builds its kernels into its own ``_build/`` there.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "otgan_tpu")
RESULT = "portbench-result "
FIRST_RUN_S = 1150  # a checkout's first run builds the kernels


def cache_env(root: str) -> None:
    """Every cache of the program at a fixed path inside the checkout."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description="the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def emit(out: dict) -> int:
    """Print a run's lines; refuse the result where JAX was loaded."""
    print(json.dumps({"info": out["info"]}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules {found} were loaded; no result", file=sys.stderr, flush=True)
        return 3
    print(json.dumps(out["result"]), flush=True)
    for name, c in out["result"]["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g}) {ok}", file=sys.stderr,
              flush=True)
    return 0


def worker(args) -> int:
    """One rank of a K-rank cell under torchrun; rank 0 prints the lines."""
    import torch.distributed as dist

    from portbench import harness, spec

    cell = spec.load(ROOT, args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      float(os.environ["PORTBENCH_T0"]))
    if dist.is_initialized():
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"portbench: modules {found} were loaded", file=sys.stderr, flush=True)
        return 3
    if out is not None:
        print(RESULT + json.dumps(out), flush=True)
    return 0


def launch(args, chips: int) -> int:
    from portbench.launch import ranks

    proc = ranks("portbench.run", ["--workload", args.workload, "--seed", str(args.seed),
                                   "--seconds", str(args.seconds), "--trace", str(args.trace)],
                 chips, FIRST_RUN_S - (time.time() - T0), ROOT,
                 dict(os.environ, PORTBENCH_T0=repr(T0)))
    lines = proc.stdout.splitlines()
    found = [ln for ln in lines if ln.startswith(RESULT)]
    for ln in lines:
        if not ln.startswith(RESULT):
            print(ln, flush=True)
    print(proc.stderr[-20000:], file=sys.stderr, flush=True)
    if proc.returncode != 0 or len(found) != 1:
        print(f"portbench: the {chips} ranks exited {proc.returncode}", file=sys.stderr,
              flush=True)
        return proc.returncode or 4
    return emit(json.loads(found[0][len(RESULT):]))


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    import torch

    from portbench import spec

    if args.worker:
        return worker(args)
    cell = spec.load(ROOT, args.workload)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), this machine has {n}",
              file=sys.stderr, flush=True)
        return 2
    if cell.chips > 1:
        return launch(args, cell.chips)
    from portbench import harness

    return emit(harness.run(cell, args.seed, args.seconds, bool(args.trace), T0))


if __name__ == "__main__":
    sys.exit(main())
