"""``--profile_dir`` (counterpart of ``jax.profiler.start_trace`` /
``stop_trace`` in ``otgan_tpu/train.py:361-362, 592-593``), the engine's
step and phase marks, and a reader of the trace.

:func:`profiled` traces the training loop with ``torch.profiler`` (host
activity, and the card's when the run is on one) and writes a Chrome trace,
``trace_rank<r>.json``, into the directory when the loop ends, also when it
raises. The trainer names what its loop does with host spans
(``TRAINER_SPANS``: ``data_wait``, ``dispatch``, ``epoch_end`` and inside
it ``readback``, ``samples``, ``eval``, ``checkpoint``).

:func:`phase` names a step of the engine (``gen_step``, ``disc_step``) or,
inside one, a phase (``features``, ``match``, ``loss_backward``,
``update``). It opens the ``record_function`` host span of that name and
puts a mark on the device at its start and at its end: on the card a kernel
of ``csrc/phase_marks.cu`` on the current stream, which a CUDA graph records
at capture and runs in every replay, so a replayed cycle (one host span,
``cycle``) is counted as an eager one; on the CPU the same state machine on
the host clock. A device's tally holds, for each kind of step (``KINDS``)
and each slot (``SLOTS``: the four phases, the whole step, from its first
mark to its last, and ``refeatures``, each microbatch's forward under
autograd inside ``loss_backward``, so a part of it, marked only under
``--grad_accum`` > 1), the time between the slot's marks and their count.
:func:`device_ms` reads the running totals; :func:`profiled_device_ms` those
of the calls made while a profiler recorded: :func:`note_call`, at the
start of each ``Engine.cycle_step``, copies the tally on the device at the
first call after a profiler starts and at the first after it stops, so no
call waits for the host.

:func:`summarize` reads a trace back: device kernels by total time, the host
time of each span, the device time of the kernels between each phase's
marks on the device timeline (a kernel goes to the innermost slot whose
marks hold it), each slot's marked time, and the card's idle
intervals, each named by the trainer's span that covers it; :func:`step_gaps`
the card's idle time between consecutive steps, delimited by their marks.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import json
import os
import re
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STEP_SPANS = ("gen_step", "disc_step")
PHASE_SPANS = ("features", "match", "loss_backward", "update")
# marked inside a phase: each microbatch's forward under autograd, inside
# loss_backward (``--grad_accum`` > 1 only)
NESTED_SPANS = ("refeatures",)
KINDS = ("gen", "disc")  # a step span's kind: its name without "_step"
SLOTS = PHASE_SPANS + ("step",) + NESTED_SPANS  # csrc/phase_marks.cu's slot order
TRAINER_SPANS = ("data_wait", "dispatch", "epoch_end", "readback", "samples", "eval",
                 "checkpoint")
# what the main path did, beyond the kernels' launches (``train.kernel_launches``;
# a replay adds its capture's counts): ``microbatch``, each microbatch pass of
# a step's loss_backward; ``dense_concat``, each list input a conv concatenates
counts = {"microbatch": 0, "dense_concat": 0}
# a mark's kernel name in a trace, e.g. "void otgan_mark<disc, match, begin>(...)"
MARK = re.compile(r"otgan_mark<\s*(\w+)\s*,\s*(\w+)\s*,\s*(begin|end)\s*>")


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


# -- marks and their tally --

class Tally:
    """One device's marks: ``acc[kind, slot]`` holds (begin ns, total ns,
    count), on the card for a CUDA device (allocated once, outside any
    graph's pool, and only ever changed in place), on the host for the CPU;
    ``start`` and ``stop`` are its copies at the first call after a
    profiler started and after it stopped."""

    def __init__(self, device: torch.device):
        self.device = device
        self.acc = torch.zeros((len(KINDS), len(SLOTS), 3), dtype=torch.int64, device=device)
        self.start = torch.zeros_like(self.acc)
        self.stop = torch.zeros_like(self.acc)
        self.started = False  # a call has run under a profiler
        self.profiling = False  # the last call ran under a profiler
        self.stopped = False  # ``stop`` holds the totals at the profiler's stop

    def mark(self, kind: int, slot: int, edge: int) -> None:
        """``edge`` 0 stores the clock in the slot, 1 adds the time since to
        its total and one to its count."""
        if self.device.type == "cuda":
            _mark_cuda(self.acc, kind, slot, edge)
            return
        now = time.perf_counter_ns()
        row = self.acc[kind, slot]
        if edge == 0:
            row[0] = now
        else:
            row[1] += now - int(row[0])
            row[2] += 1

    def note_call(self) -> None:
        on = torch._C._autograd._profiler_enabled()
        if on and not self.profiling:
            self.start.copy_(self.acc)
            self.started, self.stopped = True, False
        elif self.profiling and not on:
            self.stop.copy_(self.acc)
            self.stopped = True
        self.profiling = on

    def profiled(self) -> torch.Tensor:
        if not self.started:
            return torch.zeros_like(self.acc)
        return (self.stop if self.stopped else self.acc) - self.start

    def reset(self) -> None:
        for t in (self.acc, self.start, self.stop):
            t.zero_()
        self.started = self.profiling = self.stopped = False


# one tally a device, for the life of the process: a graph holds its address
_tallies: Dict[torch.device, Tally] = {}
_open = threading.local()  # the steps open on this thread: [(tally, kind)]
CPU = torch.device("cpu")


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def tally(device) -> Tally:
    """The tally of ``device``, made at its first use. A capture must not
    make it (it would live in the graph's pool): the engine makes its
    device's when it is built."""
    key = _key(device)
    t = _tallies.get(key)
    if t is None:
        if key.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the phase marks' tally of {key} must exist before a capture")
        t = _tallies[key] = Tally(key)
    return t


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("phase_marks")
    lib.otgan_phase_mark.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.otgan_phase_mark.restype = ctypes.c_int
    lib.otgan_phase_mark_error_string.argtypes = [ctypes.c_int]
    lib.otgan_phase_mark_error_string.restype = ctypes.c_char_p
    return lib


def _mark_cuda(acc: torch.Tensor, kind: int, slot: int, edge: int) -> None:
    lib = _bind()
    with torch.cuda.device(acc.device):
        err = lib.otgan_phase_mark(kind, slot, edge, acc.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the mark {KINDS[kind]}.{SLOTS[slot]}.{('begin', 'end')[edge]} "
                           f"failed to launch: "
                           f"{lib.otgan_phase_mark_error_string(err).decode()} ({err})")


@contextlib.contextmanager
def phase(name: str, device=None):
    """The host span ``name`` and, for a step (``STEP_SPANS``, on
    ``device``) or a phase of the step open on this thread
    (``PHASE_SPANS``, ``NESTED_SPANS``), a mark at its start and at its
    end. A body that raises leaves its end unmarked: the slot counts only
    what completed."""
    if name in STEP_SPANS:
        where = (tally(device), KINDS.index(name[:-len("_step")]))
    else:
        steps = getattr(_open, "steps", None)
        where = steps[-1] if steps and name in PHASE_SPANS + NESTED_SPANS else None
    with record_function(name):
        if where is None:
            yield
            return
        t, kind = where
        slot = SLOTS.index("step" if name in STEP_SPANS else name)
        t.mark(kind, slot, 0)
        if name in STEP_SPANS:
            _open.steps = getattr(_open, "steps", []) + [where]
            try:
                yield
            finally:
                _open.steps = _open.steps[:-1]
        else:
            yield
        t.mark(kind, slot, 1)


def note_call(device) -> None:
    """At the start of each ``Engine.cycle_step``: whether a profiler
    records is checked once a call (:func:`profiled_device_ms`)."""
    tally(device).note_call()


def _totals(acc: torch.Tensor) -> dict:
    """``{kind: {slot: {"ms", "count"}}}`` of a tally."""
    a = acc.cpu().tolist()
    return {kind: {slot: {"ms": a[k][s][1] / 1e6, "count": a[k][s][2]}
                   for s, slot in enumerate(SLOTS)} for k, kind in enumerate(KINDS)}


def device_ms(device) -> dict:
    """The running totals of ``device``'s marks: ``{kind: {slot: {"ms":
    total, "count": n}}}``. Waits for the device: read it where the host
    waits anyway."""
    return _totals(tally(device).acc)


def profiled_device_ms(device) -> dict:
    """:func:`device_ms` of only the calls that ran while a profiler
    recorded (the last time one did): from the first such call to the
    first call after the profiler stopped, or, with no call since, to the
    totals as they stand."""
    return _totals(tally(device).profiled())


def per_step(now: dict, before: dict) -> dict:
    """Device ms a step of each kind and slot between two readings of
    :func:`device_ms`, for the kinds that took a step."""
    out = {}
    for kind, slots in now.items():
        n = slots["step"]["count"] - before[kind]["step"]["count"]
        if n:
            out[kind] = {s: (v["ms"] - before[kind][s]["ms"]) / n for s, v in slots.items()}
    return out


def reset_counts() -> None:
    """Zero the main path's counts (``counts``)."""
    for k in counts:
        counts[k] = 0


def reset() -> None:
    """Zero every tally in place (a graph keeps their addresses)."""
    for t in _tallies.values():
        t.reset()


def host_marks() -> Optional[torch.Tensor]:
    """A copy of the CPU's tally. On the card a capture runs no mark and a
    replay runs the graph's; a capture on the CPU (a test's stub graph runs
    the cycle) counts its marks on the host, so ``cycle_graph.py`` takes
    them back (:func:`take_back`) and adds them once a replay
    (:func:`add_marks`)."""
    t = _tallies.get(CPU)
    return None if t is None else t.acc.clone()


def take_back(before: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Puts the CPU's tally back to ``before`` and returns the totals and
    counts added since (None when nothing was)."""
    if before is None:
        return None
    acc = _tallies[CPU].acc
    delta = acc - before
    delta[..., 0] = 0
    acc.copy_(before)
    return delta if bool(delta.any()) else None


def add_marks(delta: Optional[torch.Tensor]) -> None:
    if delta is not None:
        _tallies[CPU].acc.add_(delta)


# -- reading a trace --

def _events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _span(e) -> tuple:
    ts = float(e.get("ts", 0.0))
    return ts, ts + float(e.get("dur", 0.0))


def _marked(events) -> list:
    """Every slot's marked interval on the device timeline: ``(begin mark's
    start, end mark's start, end mark's end, kind, slot)``, in time order."""
    marks = sorted((e for e in events if e.get("cat") == "kernel" and MARK.search(e["name"])),
                   key=lambda e: float(e["ts"]))
    open_, out = {}, []
    for e in marks:
        ts = float(e["ts"])
        kind, slot, edge = MARK.search(e["name"]).groups()
        if edge == "begin":
            open_[kind, slot] = ts
        elif (kind, slot) in open_:
            out.append((open_.pop((kind, slot)), ts, _span(e)[1], kind, slot))
    return sorted(out)


def summarize(path: str, top: int = 10) -> dict:
    """What a trace of :func:`profiled` says: ``kernels`` (name -> [count,
    total ms] of every device kernel), ``top`` (the ``top`` kernels by total
    time), ``spans`` (name -> [count, total host ms] of each step and phase
    span), ``phase_device_ms`` (the device time of the kernels that start
    between each phase's marks on the device timeline, eager or replayed,
    each kernel given to the innermost slot that holds it, so
    ``loss_backward`` leaves out its ``refeatures``; ``other`` for the
    rest, the marks included), ``marks`` (``kind.slot``
    -> [count, ms from its begin mark's start to its end mark's start]),
    ``device_ms``, and ``idle_gaps`` (:func:`idle_gaps`)."""
    events = _events(path)
    kernels = defaultdict(lambda: [0, 0.0])
    spans = {name: [0, 0.0] for name in STEP_SPANS + PHASE_SPANS + NESTED_SPANS}
    for e in events:
        cat, name, dur = e.get("cat", ""), e["name"], float(e.get("dur", 0.0))
        if cat == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += dur / 1e3
        elif cat == "user_annotation" and name in spans:
            spans[name][0] += 1
            spans[name][1] += dur / 1e3
    marked = _marked(events)
    # innermost first: slots of one level do not overlap
    levels = []
    for names in (NESTED_SPANS, PHASE_SPANS):
        phases = [(a, b, slot) for a, b, _, _, slot in marked if slot in names]
        levels.append(([p[0] for p in phases], phases))
    marks = defaultdict(lambda: [0, 0.0])
    for a, b, _, kind, slot in marked:
        marks[f"{kind}.{slot}"][0] += 1
        marks[f"{kind}.{slot}"][1] += (b - a) / 1e3
    phase_ms = {name: 0.0 for name in PHASE_SPANS + NESTED_SPANS + ("other",)}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        where = "other" if MARK.search(e["name"]) else _phase_at(levels, float(e["ts"]))
        phase_ms[where] += float(e.get("dur", 0.0)) / 1e3
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": dict(kernels),
        "top": [[name, count, ms] for name, (count, ms) in ranked[:top]],
        "spans": spans,
        "phase_device_ms": phase_ms,
        "marks": dict(marks),
        "device_ms": sum(ms for _, ms in kernels.values()),
        "idle_gaps": idle_gaps(events),
    }


def _phase_at(levels, ts: float) -> str:
    """The innermost slot whose marks hold device time ``ts``: ``levels``
    lists each level's begins and ``(begin, end, slot)`` in time order,
    innermost first."""
    for starts, phases in levels:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < phases[i][1]:
            return phases[i][2]
    return "other"


def _device_busy(events) -> list:
    return [_span(e) for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def idle_gaps(events) -> list:
    """The card's idle intervals between its first and last activity
    (kernels, copies, memsets), longest first: ``[span, ms]``, ``span``
    being the trainer's host span (``TRAINER_SPANS``) that covers most of
    the interval (the innermost of those that cover it alike), else
    ``other``."""
    busy = _union(_device_busy(events))
    host = [(*_span(e), e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] in TRAINER_SPANS]
    gaps = [[_label(host, a, b), (b - a) / 1e3] for (_, a), (b, _) in zip(busy, busy[1:])]
    return sorted(gaps, key=lambda g: -g[1])


def _label(host, a: float, b: float) -> str:
    best, label = (0.0, 0.0), "other"
    for s0, s1, name in host:
        cover = (min(s1, b) - max(s0, a), s0 - s1)  # then the shorter span
        if cover[0] > 0 and cover > best:
            best, label = cover, name
    return label


def step_gaps(path: str) -> dict:
    """The card's idle time between consecutive steps in a trace of
    :func:`profiled`, each step running on the device from its first mark
    to its last, eager or replayed: ``gaps_ms``, from the end of one step's
    last mark to the start of the next one's first; ``idle_ms``, that gap
    less the time any device activity ran inside it (an epoch's samples,
    copies, memsets, on any stream); ``copy_ms``, the host-to-device copies'
    time inside it."""
    events = _events(path)
    steps = [(a, end) for a, _, end, _, slot in _marked(events) if slot == "step"]
    busy = _device_busy(events)
    copies = [_span(e) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    out = {"gaps_ms": [], "idle_ms": [], "copy_ms": []}
    for (_, a), (b, _) in zip(steps, steps[1:]):
        out["gaps_ms"].append((b - a) / 1e3)
        out["idle_ms"].append((b - a - _covered(busy, a, b)) / 1e3)
        out["copy_ms"].append(_covered(copies, a, b) / 1e3)
    return out


def _union(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(intervals, a: float, b: float) -> float:
    """Length of ``[a, b]`` that the union of ``intervals`` covers."""
    clipped = [(max(x, a), min(y, b)) for x, y in intervals if y > a and x < b]
    return sum(y - x for x, y in _union(clipped))
