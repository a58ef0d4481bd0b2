"""Reading a ``torch.profiler`` Chrome trace of the traced stretch.

The stretch is the host span ``portbench.window``; inside it the harness
names what the host does with its own spans (``portbench.data_wait``,
``portbench.dispatch``, ``portbench.readback``, ``portbench.epoch_end``).
Device activity is every kernel, memcpy and memset. :func:`read` gives the
device time of each kernel name, the card's busy time (the union of its
activity) inside the stretch, and the idle gaps, each labelled with the
host span that covers most of it.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _label(spans, a: float, b: float) -> str:
    """The host span that covers most of ``[a, b]``, else ``other``."""
    best, label = 0.0, "other"
    for s0, s1, name in spans:
        cover = min(s1, b) - max(s0, a)
        if cover > best:
            best, label = cover, name
    return label


def read(path: str) -> dict:
    """``{"window_s", "busy_s", "kernels": {name: s}, "gaps": [(s, span)]}``
    of the stretch in the trace at ``path``; all times in seconds."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise RuntimeError(f"{path}: no {WINDOW} span in the trace")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0].get("dur", 0.0))
    kernels: Dict[str, float] = defaultdict(float)
    busy = []
    spans = []
    for e in events:
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                busy.append((a, b))
                if cat == "kernel":
                    kernels[e["name"]] += (b - a) / 1e6
        elif (cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX)
              and e["name"] != WINDOW):
            spans.append((ts, ts + dur, e["name"][len(SPAN_PREFIX):]))
    merged = _union(busy)
    busy_us = sum(b - a for a, b in merged)
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append(((b - a) / 1e6, _label(spans, a, b)))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "kernels": dict(kernels),
            "gaps": sorted(gaps, reverse=True)}
