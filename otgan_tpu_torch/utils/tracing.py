"""``--profile_dir`` (counterpart of ``jax.profiler.start_trace`` /
``stop_trace`` in ``otgan_tpu/train.py:361-362, 592-593``) and a reader of
the trace it writes.

:func:`profiled` traces the training loop with ``torch.profiler`` (host
activity, and the card's when the run is on one) and writes a Chrome trace,
``trace_rank<r>.json``, into the directory when the loop ends, also when it
raises. The engine names its spans with ``record_function`` (``gen_step``,
``disc_step``; inside them ``features``, ``match``, ``loss_backward``,
``update``; ``microbatch`` under ``--grad_accum``). :func:`summarize` reads
a trace back: device kernels by total time, the host time of each span,
and the device time of the kernels launched inside each step span;
:func:`step_gaps` the card's idle time between consecutive steps.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

STEP_SPANS = ("gen_step", "disc_step")
PHASE_SPANS = ("features", "match", "loss_backward", "update")


def trace_path(profile_dir: str, rank: int = 0) -> str:
    return os.path.join(profile_dir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def profiled(profile_dir: str, device: torch.device, rank: int = 0):
    """Trace the body into ``trace_path(profile_dir, rank)``; a no-op when
    ``profile_dir`` is empty."""
    if not profile_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_path(profile_dir, rank))


def summarize(path: str, top: int = 10) -> dict:
    """What a trace of :func:`profiled` says: ``kernels`` (name -> [count,
    total ms] of every device kernel), ``top`` (the ``top`` kernels by total
    time), ``spans`` (name -> [count, total host ms] of each step and phase
    span), ``phase_device_ms`` (the device time of the kernels whose launch
    falls in each phase span, ``other`` for the rest) and ``device_ms``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = defaultdict(lambda: [0, 0.0])
    spans = {name: [0, 0.0] for name in STEP_SPANS + PHASE_SPANS}
    phases, launches = [], {}
    for e in events:
        cat, name, dur = e.get("cat", ""), e["name"], float(e.get("dur", 0.0))
        if cat == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += dur / 1e3
        elif cat == "user_annotation" and name in spans:
            spans[name][0] += 1
            spans[name][1] += dur / 1e3
            if name in PHASE_SPANS:
                phases.append((float(e["ts"]), float(e["ts"]) + dur, name))
        elif cat.startswith("cuda_") and "correlation" in e.get("args", {}):
            # the host-side launch (runtime or lower-level API call) of a kernel
            launches[e["args"]["correlation"]] = float(e["ts"])
    phases.sort()
    starts = [p[0] for p in phases]
    phase_ms = {name: 0.0 for name in PHASE_SPANS + ("other",)}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        phase = _phase_at(phases, starts, launches.get(e.get("args", {}).get("correlation")))
        phase_ms[phase] += float(e.get("dur", 0.0)) / 1e3
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": dict(kernels),
        "top": [[name, count, ms] for name, (count, ms) in ranked[:top]],
        "spans": spans,
        "phase_device_ms": phase_ms,
        "device_ms": sum(ms for _, ms in kernels.values()),
    }


def _phase_at(phases, starts, ts: Optional[float]) -> str:
    """The phase span that holds host time ``ts`` (they do not nest)."""
    if ts is None:
        return "other"
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and ts <= phases[i][1]:
        return phases[i][2]
    return "other"


def step_gaps(path: str) -> dict:
    """The card's idle time between consecutive steps in a trace of
    :func:`profiled`, for each pair of consecutive step spans: ``gaps_ms``,
    from the end of the last device kernel launched in the first to the
    start of the first kernel launched in the second; ``idle_ms``, that gap
    less the time any device activity ran inside it (kernels launched
    outside the steps, such as an epoch's samples, copies, memsets, on any
    stream); ``copy_ms``, the host-to-device copies' time inside it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events
                   if e.get("cat") == "user_annotation" and e["name"] in STEP_SPANS)
    starts = [a for a, _ in steps]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    first, last, busy, copies = {}, {}, [], []
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        begin, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        busy.append((begin, end))
        if cat == "gpu_memcpy" and "HtoD" in e["name"]:
            copies.append((begin, end))
        if cat != "kernel":
            continue
        ts = launches.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        if i < 0 or ts > steps[i][1]:
            continue  # launched outside every step
        first[i] = min(first.get(i, begin), begin)
        last[i] = max(last.get(i, end), end)
    out = {"gaps_ms": [], "idle_ms": [], "copy_ms": []}
    for i in range(len(steps) - 1):
        if i in last and i + 1 in first:
            a, b = last[i], first[i + 1]
            out["gaps_ms"].append((b - a) / 1e3)
            out["idle_ms"].append((b - a - _covered(busy, a, b)) / 1e3)
            out["copy_ms"].append(_covered(copies, a, b) / 1e3)
    return out


def _covered(intervals, a: float, b: float) -> float:
    """Length of ``[a, b]`` that the union of ``intervals`` covers."""
    clipped = sorted((max(x, a), min(y, b)) for x, y in intervals if y > a and x < b)
    total, reach = 0.0, a
    for x, y in clipped:
        if y > reach:
            total += y - max(x, reach)
            reach = y
    return total
