"""One run of a cell: set-up, the measured window, the traced stretch and
the check.

Set-up builds the program (``otgan_tpu_torch``) from the seed as its
trainer does: the flags of the configuration through the port's own
``config.parse_args``, the synthetic CIFAR-shaped set and its loader
(``train.make_loader``), the models through ``Engine.init_state`` with its
data-dependent init, and the batches placed on the card as
``--host_prefetch`` places them. The first G:D cycle goes through
``Engine.cycle_step`` as every later one does (it runs eagerly, as the
program's first call always does); what it produced is kept for the check.
Set-up then runs calls until every schedule the window will meet (full
cycles and epoch leftovers) has been captured as a CUDA graph, so nothing
is captured or built in the window; an engine that runs eagerly captures
nothing, and its set-up ends once each kind of step has run.

The window runs the loop as ``train.py`` runs it under these
configurations (``log_every_steps`` 0): calls are dispatched one after
another, and the steps' distances and entropies are read back once at each
epoch's end, plus once when the window closes so that its wall time holds
all its work. The loop is a copy of the trainer's (``train.py::train``
has no entry that stops after a given time); its loader, placement and
prefetch are the trainer's own functions. It runs until ``seconds`` have
passed and counts every step it dispatched. A traced run profiles its first
``trace_groups`` calls with ``torch.profiler``.

After the window one more call runs: the next call that ends an epoch, a
replay of a graph that set-up captured and replayed, or an eager call
where the engine runs eagerly (``replay_check``). The program's state is
copied to the host before it and read after it. Then the program's graphs
and state are freed, and the plain reference (``reference/train.py``, with
the configuration's model family, ``reference/<model>.py``) follows the
first cycle from the seed and the check call from that copied state, on
the same batches; ``check.py`` compares the two.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from otgan_tpu_torch.config import parse_args
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.train import (
    HostToDevice,
    _prefetch_placed,
    kernel_launches,
    make_loader,
    maybe_init_distributed,
)
from portbench import check, counts, kernels, trace
from portbench.reference import train as reference

# the configuration file's keys that the parsed flags must equal
STATED = ("model", "batch_size", "nr_gen_per_disc", "sinkhorn_lambda", "nr_sinkhorn_iter",
          "compute_dtype", "matching_precision", "learning_rate_gen", "learning_rate_disc",
          "adam_mom1", "adam_mom2", "ema_decay", "grad_accum", "remat", "fused_cycle")
# the reference's settings, taken from the configuration file
REFERENCE_KEYS = STATED + ("feature_dim",)


def program_config(cell, seed: int, extra: Sequence[str] = ()):
    """The trainer's config of ``cell`` at ``seed``: the configuration's
    flags, the traffic's, then ``extra`` (a calibration's variant)."""
    argv = [*cell.config["argv"], "--synthetic_size", str(cell.traffic["synthetic_size"]),
            "--seed", str(seed), *extra]
    if cell.chips > 1:
        argv += ["--num_devices", str(cell.chips)]
    cfg = parse_args(argv)
    changed = {a.lstrip("-").split("=")[0] for a in extra if a.startswith("--")}
    for key in STATED:
        if key not in changed and getattr(cfg, key) != cell.config[key]:
            raise ValueError(f"{cell.config['name']}: the flags give {key}={getattr(cfg, key)!r}, "
                             f"the configuration states {cell.config[key]!r}")
    return cfg


def schedules(is_disc: Callable[[int], bool], per_epoch: int, group: int, period: int) -> set:
    """Every schedule (the kinds of a call's steps) that epochs of
    ``per_epoch`` batches taken ``group`` at a time meet under a G:D
    schedule of ``period`` steps."""
    out, step = set(), 0
    for _ in range(math.lcm(per_epoch, period) // per_epoch + 1):
        left = per_epoch
        while left:
            n = min(group, left)
            out.add(tuple(is_disc(step + i) for i in range(n)))
            step, left = step + n, left - n
    return out


def leaves(state) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"disc": dict(state.disc.named_parameters()),
            "gen": dict(state.gen.named_parameters()), "ema": state.gen_ema}


def state_copy(state) -> dict:
    """The program's state on the host, in the reference's layout: both
    nets, the EMA, each Adam state (``t``, ``v``, ``mg``) and the step."""
    out = {net: reference.snapshot(p) for net, p in leaves(state).items()}
    for net, opt in (("disc_opt", state.disc_opt), ("gen_opt", state.gen_opt)):
        out[net] = {"t": float(opt.t), "v": reference.snapshot(opt.v),
                    "mg": reference.snapshot(opt.mg)}
    out["step"] = state.step
    return out


class Spans:
    """The harness's own host spans: seconds summed by name, and named for
    the profiler."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            with record_function(f"portbench.{name}"):
                yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t


class Program:
    """The system under test at ``seed``, driven as its trainer drives it.
    ``patch`` changes the engine before its first step (a calibration's
    fault)."""

    def __init__(self, cell, seed: int, device, extra: Sequence[str] = (),
                 patch: Optional[Callable] = None):
        self.cfg = program_config(cell, seed, extra)
        self.engine = Engine(self.cfg, device)
        if patch is not None:
            patch(self.engine)
        self.loader = make_loader(self.cfg, np.random.default_rng(self.cfg.seed))
        self.x_init = self.loader.init_batch()
        self.state, self.num_features = self.engine.init_state(self.cfg.seed, self.x_init)
        rows = self.engine.matcher_desc.startswith("row-sharded")
        if cell.chips > 1 and rows != (halves_ranks(cell) > 1):
            raise ValueError(f"the matcher is {self.engine.matcher_desc!r}; the traffic states "
                             f"halves {cell.traffic.get('halves', 'global')!r}")
        if self.num_features != cell.config["feature_dim"]:
            raise ValueError(f"critic features {self.num_features}, configuration states "
                             f"{cell.config['feature_dim']}")
        self.start = {net: reference.snapshot(p) for net, p in leaves(self.state).items()}
        dev = self.engine.device
        one = (HostToDevice(dev) if self.cfg.host_prefetch and dev.type == "cuda"
               else (lambda x: x))
        # a call's payload: its host batches (kept for the check) and their placement
        self.items = _prefetch_placed(self._work(), lambda hosts: (hosts, [one(x) for x in hosts]),
                                      depth=1 if self.cfg.host_prefetch else 0)
        self.per_epoch = self.loader.common_num_batches
        self.hosts: List[np.ndarray] = []  # the last call's host batches
        self.taken = 0  # batches of the current epoch taken so far
        self.unread: list = []  # the steps' metrics not read back yet
        self.readings: List[Tuple[float, float]] = []  # every step's (dist, entropy)

    def _work(self):
        """``(epoch, [host batches])`` a call at a time, an epoch's leftover
        as one call, then ``(epoch, None)`` at the epoch's end (the
        trainer's ``work_items``)."""
        group, epoch = self.engine.cycle_batches, 0
        while True:
            pending = []
            for x in self.loader.epoch():
                pending.append(x)
                if len(pending) == group:
                    yield epoch, pending
                    pending = []
            if pending:
                yield epoch, pending
            yield epoch, None
            epoch += 1

    def call(self, spans: Spans) -> Optional[int]:
        """The loop's next item: a call's steps dispatched (their count), or
        at an epoch's end the read-back of the epoch's steps (None)."""
        with spans("data_wait"):
            _, item = next(self.items)
            if item is not None:
                self.hosts, placed = item
                xs = [p.wait() if hasattr(p, "wait") else p for p in placed]
        if item is None:
            self.taken = 0
            with spans("epoch_end"):
                self.read()
            return None
        with spans("dispatch"):
            self.state, mets = self.engine.cycle_step(self.state, xs)
        self.unread += mets
        self.taken += len(xs)
        return len(xs)

    def read(self) -> List[Tuple[float, float]]:
        """Reads back the steps dispatched since the last read (waits for
        them): their ``(dist, entropy)``, also added to ``readings``."""
        n = len(self.unread)
        if not n:
            return []
        vals = torch.stack([m.dist for m in self.unread]
                           + [m.entropy for m in self.unread]).tolist()
        self.unread = []
        got = list(zip(vals[:n], vals[n:]))
        self.readings += got
        return got

    def last_schedule(self, n: int) -> tuple:
        """The kinds of the ``n`` steps just taken."""
        return tuple(self.engine.is_disc_step(self.state.step - n + i) for i in range(n))

    def first_reading(self, steps: list) -> dict:
        """What the first cycle produced: its steps' dist and entropy, the
        critic's first gradient from Adam's first moment, and every leaf's
        change since init."""
        mom1 = self.cfg.adam_mom1
        grad = {k: float(torch.linalg.vector_norm(v)) / (1.0 - mom1)
                for k, v in self.state.disc_opt.v.items()}
        now = leaves(self.state)
        return {"dist": [d for d, _ in steps], "entropy": [e for _, e in steps],
                "first_grad": {"disc": grad},
                "change": {net: reference.change_norms(self.start[net], now[net])
                           for net in self.start}}

    def close(self) -> None:
        """Stop the prefetch and free the graphs (NCCL keeps a communicator
        while a graph of its work lives)."""
        self.items.close()
        self.engine.drop_graphs()


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
        torch.cuda.empty_cache()


def reference_config(cell) -> dict:
    return {k: cell.config[k] for k in REFERENCE_KEYS}


def first_cycle(prog: Program, spans: Spans) -> Tuple[dict, List[np.ndarray]]:
    """The program's first call, read back: its reading and host batches."""
    while prog.call(spans) is None:
        pass
    return prog.first_reading(prog.read()), prog.hosts


def replay_check(prog: Program, spans: Spans) -> Tuple[dict, dict, List[np.ndarray]]:
    """After the window: the next call that ends an epoch, a replay of a
    graph that set-up captured and replayed (where the engine runs eagerly,
    an eager call from the copied state). Returns the program's state
    before it (on the host), its reading (each step's dist and entropy, each
    leaf's change) and its host batches."""
    group = prog.engine.cycle_batches
    last = (prog.per_epoch - 1) // group * group  # where an epoch's last call starts
    while prog.taken != last:
        prog.call(spans)
    prog.read()
    before = state_copy(prog.state)
    if prog.call(spans) is None:
        raise RuntimeError("the check call found an epoch's end")
    steps = prog.read()
    now = leaves(prog.state)
    reading = {"dist": [d for d, _ in steps], "entropy": [e for _, e in steps],
               "change": {net: reference.change_norms(before[net], now[net])
                          for net in ("disc", "gen", "ema")}}
    return before, reading, prog.hosts


def halves_ranks(cell) -> int:
    """The ranks whose own rows the two-batch halves come from: on K ranks
    the row-sharded matcher splits each rank's rows (``"halves": "per_rank"``
    in the traffic), the matrix-parallel one the global batch."""
    return cell.chips if cell.traffic.get("halves") == "per_rank" else 1


def reference_reading(cell, seed: int, x_init, batches, device) -> dict:
    return reference.follow(reference_config(cell), cell.family, seed, torch.from_numpy(x_init),
                            [torch.from_numpy(b) for b in batches], device, halves_ranks(cell),
                            cell.chips)


def reference_replay(cell, seed: int, state: dict, batches, device) -> dict:
    return reference.resume(reference_config(cell), cell.family, seed, state,
                            [torch.from_numpy(b) for b in batches], device, halves_ranks(cell),
                            cell.chips)


def gather(values: List[float], device) -> List[List[float]]:
    """Every rank's ``values`` (one rank: its own)."""
    if not (dist.is_available() and dist.is_initialized()):
        return [values]
    t = torch.tensor(values, dtype=torch.float64, device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def least_times(cell, kinds: List[bool], device_name: str, device) -> Dict[str, float]:
    """The least time of the traced steps, by part (``counts.py``)."""
    pk = counts.peaks(device_name)
    rate = counts.exp_rate(torch.cuda.get_device_properties(device).multi_processor_count)
    out = {"model": 0.0, "gemm": 0.0, "sinkhorn": 0.0}
    for k in kinds:
        for part, s in counts.step_least_s(cell.config, k, cell.chips, pk, rate).items():
            out[part] += s
    return out


@dataclass
class Window:
    """What the measured window did: its calls and steps (``kinds``: critic
    step or not), the steps whose readback was not finite, its wall time,
    the launch counters and replays a call, the harness's host spans, the
    process's reserved peak, and for a traced run the trace's reading of
    its first calls with their steps, wall time and data wait."""

    calls: int
    kinds: List[bool]
    failed: int
    wall_s: float
    launches: Dict[str, float]
    replays: float
    spans: Dict[str, float]
    peak_bytes: int
    trace: Optional[dict] = None
    traced_calls: int = 0
    traced_kinds: List[bool] = field(default_factory=list)
    traced_wall_s: float = 0.0
    traced_wait_s: float = 0.0


def setup(prog: Program, spans: Spans) -> None:
    """Calls until every schedule the window meets has been run (so
    captured) since the first call; then waits for them. An engine that
    runs eagerly (``cycle_graphs`` off: ``--no_fused_cycle``, the CPU, or a
    capture that ran out of memory; ``fused_cycle_reason`` says which)
    captures nothing, so its set-up ends once each kind of step the window
    meets has run: after the first call where that call held a whole
    cycle."""
    eng = prog.engine
    needed = schedules(eng.is_disc_step, prog.per_epoch, eng.cycle_batches,
                       prog.cfg.nr_gen_per_disc + 1)
    kinds = {k for schedule in needed for k in schedule}
    seen: set = set()
    while not (needed <= seen if eng.cycle_graphs
               else kinds <= {eng.is_disc_step(i) for i in range(prog.state.step)}):
        n = prog.call(spans)
        if n is not None:
            seen.add(prog.last_schedule(n))
    prog.read()


def measure(prog: Program, seconds: float, trace_calls: int, rank: int) -> Window:
    """Whole calls until ``seconds`` have passed, then the read-back of what
    is still unread; the first ``trace_calls`` under ``torch.profiler``,
    whose trace is read once the window closed."""
    dev = prog.engine.device
    spans = Spans()
    launches0, replays0 = kernel_launches(), prog.engine.replays
    read0 = len(prog.readings)
    kinds: List[bool] = []
    calls = 0
    prof = marker = None
    traced = {}
    t0 = time.perf_counter()
    if trace_calls:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        marker = record_function(trace.WINDOW)
        marker.__enter__()
        t_trace = time.perf_counter()
    while True:
        n = prog.call(spans)
        if n is None:
            continue
        kinds += prog.last_schedule(n)
        calls += 1
        if marker is not None and calls == trace_calls:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marker.__exit__(None, None, None)
            prof.stop()
            marker = None
            traced = {"traced_calls": calls, "traced_kinds": list(kinds),
                      "traced_wait_s": spans.seconds.get("data_wait", 0.0),
                      "traced_wall_s": time.perf_counter() - t_trace}
        if marker is None and time.perf_counter() - t0 >= seconds:
            break
    with spans("readback"):
        prog.read()
    wall = time.perf_counter() - t0
    failed = sum(1 for d, e in prog.readings[read0:] if not (math.isfinite(d) and math.isfinite(e)))
    launches1 = kernel_launches()
    win = Window(calls, kinds, failed, wall,
                 {k: (launches1[k] - launches0[k]) / calls
                  for k in launches1 if launches1[k] != launches0[k]},
                 (prog.engine.replays - replays0) / calls, spans.seconds,
                 torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0, **traced)
    if prof is not None:
        tmp = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(tmp, f"trace_rank{rank}.json")
            prof.export_chrome_trace(path)
            win.trace = trace.read(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return win


def report(cell, seed: int, setup_s: float, win: Window, ranks: List[List[float]],
           values: Dict[str, float], dev: torch.device, traced: bool, fused_reason: str) -> dict:
    """The run's last line (``result``) and its earlier one (``info``)."""
    verdict = check.verdict(values, cell.limits)
    steps = len(win.kinds)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": int(max(r[0] for r in ranks))}
    metrics, breakdown = {}, None
    tr = win.trace
    if traced:
        device["busy_s"] = sum(r[1] for r in ranks) / len(ranks) if tr else 0.0
        device["window_s"] = sum(r[2] for r in ranks) / len(ranks) if tr else 0.0
        if tr:
            ctx = Context(tr, win, least_times(cell, win.traced_kinds, name, dev)
                          if cuda else None)
            for m in cell.per_layer:
                v = cell.readers[m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])
            breakdown = {"device_ops": [[k, s] for k, s in top[:10]],
                         "idle_gaps": [[lab, s] for s, lab in tr["gaps"][:10]]}
    else:
        e2e = {"train_img_per_s": steps * cell.config["batch_size"] / win.wall_s,
               "peak_mem_gb": device["memory_peak_bytes"] / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(all(v["ok"] for v in verdict.values()) and win.failed == 0
                              and steps > 0),
              "attempted": steps, "failed": win.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # JSON has no infinity: a non-finite reading prints as the largest float
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else sys.float_info.max,
                            "limit": v["limit"]} for k, v in verdict.items()}
    info = {"cell": cell.name, "seed": seed, "calls": win.calls, "steps": steps,
            "window_s": win.wall_s, "setup_s": setup_s, "launches_per_call": win.launches,
            "replays_per_call": win.replays, "fused_cycle_reason": fused_reason,
            "numbers": values, "host_spans_s": win.spans}
    if tr:
        info["kernels_by_class"] = by_class(tr["kernels"])
        info["kernel_names"] = [[k, s, kernels.category(k)] for k, s in sorted(
            tr["kernels"].items(), key=lambda kv: -kv[1])[:40]]
    return {"result": result, "info": info}


def run(cell, seed: int, seconds: float, traced: bool, t0: float,
        device: Optional[torch.device] = None, extra: Sequence[str] = (),
        patch: Optional[Callable] = None, ref_cell=None) -> Optional[dict]:
    """One run from ``t0``, the epoch second it began; rank 0 returns
    ``{"result": last line, "info": earlier line}``, other ranks None.
    ``extra``, ``patch`` and ``ref_cell`` are a calibration's: flags and a
    fault for the program, another configuration for the reference."""
    if device is None:
        device = maybe_init_distributed(parse_args(cell.config["argv"]), "cuda")
    rank = dist.get_rank() if dist.is_initialized() else 0
    spans = Spans()
    prog = Program(cell, seed, device, extra, patch)
    dev = prog.engine.device
    first, first_hosts = first_cycle(prog, spans)
    setup(prog, spans)
    if dist.is_initialized():
        dist.barrier()
    setup_s = time.time() - t0
    win = measure(prog, seconds, cell.traffic["trace_groups"] if traced else 0, rank)
    tr = win.trace
    ranks = gather([float(win.peak_bytes)] + ([tr["busy_s"], tr["window_s"]] if tr else []), dev)
    before, replay, replay_hosts = replay_check(prog, spans)
    x_init, fused_reason = prog.x_init, prog.engine.fused_cycle_reason
    prog.close()
    del prog
    free_device(dev)
    out = None
    if rank == 0:
        ref_cell = ref_cell or cell
        first_ref = reference_reading(ref_cell, seed, x_init, first_hosts, dev)
        free_device(dev)
        replay_ref = reference_replay(ref_cell, seed, before, replay_hosts, dev)
        values = check.numbers(first, first_ref, replay, replay_ref)
        out = report(cell, seed, setup_s, win, ranks, values, dev, traced, fused_reason)
        out["info"]["readings"] = readings(first, first_ref, replay, replay_ref)
    if dist.is_initialized():
        dist.barrier()
    return out


def readings(first: dict, first_ref: dict, replay: dict, replay_ref: dict) -> dict:
    """What the check's distance and entropy numbers were taken from: each
    step's value on both sides, and the size of the terms that the
    reference's distance is the difference of."""
    out = {}
    for name, prog, ref in (("first", first, first_ref), ("replay", replay, replay_ref)):
        out[name] = {"dist": prog["dist"], "dist_ref": ref["dist"],
                     "dist_scale_ref": ref["dist_scale"], "entropy": prog["entropy"],
                     "entropy_ref": ref["entropy"]}
    return out


def by_class(kernel_s: Dict[str, float]) -> Dict[str, float]:
    out = {c: 0.0 for c in kernels.CLASSES}
    for name, s in kernel_s.items():
        out[kernels.category(name)] += s
    return out


class Context:
    """What a per-layer reader reads of the traced stretch: its steps and
    calls, wall time, the host's data wait, the device's busy time and
    window, the device seconds by kernel class (``kernels.py``), and the
    yardstick's least times of its steps (None off the card)."""

    def __init__(self, tr: dict, win: Window, least: Optional[dict]):
        self.steps = len(win.traced_kinds)
        self.calls = win.traced_calls
        self.wall_s = win.traced_wall_s
        self.data_wait_s = win.traced_wait_s
        self.window_s = tr["window_s"]
        self.busy_s = tr["busy_s"]
        self.class_s = by_class(tr["kernels"])
        self.least = least
