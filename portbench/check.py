"""The numbers that decide ``correct``: the program's first cycle held
against the plain reference's (``reference/train.py``) from the same seed
and batches, and the check call after the window (a graph replay, as every
call of the window is) held against the reference's steps from the
program's state before it.

* ``dist_first``, ``entropy_first``: the relative gap of the first step's
  reported transport distance and Sinkhorn entropy: the models' forward
  passes from the data-dependent init and the whole matcher, before any
  update;
* ``dist``: the largest relative gap of the distance over the cycle's
  steps, so through every update of the cycle;
* ``grad``: the critic's first gradient as its optimizer got it (worked
  out from Adam's first moment after its one step: ``v / (1 - mom1)``),
  by its worst leaf: the gap between the program's leaf norm and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
* ``change``: the same gap for the change of every leaf of both nets and
  of the EMA over the cycle. Leaves whose first gradient in the reference
  is under a thousandth of the median leaf's move under Adam by rounding
  alone and are left out.
* ``replay_dist_first``, ``replay_entropy_first``, ``replay_dist``,
  ``replay_change``: the same for the check call, its first step from the
  state both sides start at; a leaf moves by the rule above on the
  reference's first gradient of that net in the call (every leaf of a net
  that the call does not step, which neither side may then move). The two
  distance numbers are the gap over the size of the terms that the
  reference's distance is the difference of (``dist_scale``), not over the
  distance: by the check call training has brought the distance anywhere
  from ~0.9 of those terms down to a few thousandths of them, depending
  on the seed, and the same rounding of the terms reads up to a thousand
  times larger relative to the distance where it is small.

The later steps' distances drift apart by rounding that the updates
amplify (the first gradient is itself a sum in another order), so only
the first step is held tight enough to see the matcher's precision.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

NUMBERS = ("dist_first", "entropy_first", "dist", "grad", "change", "replay_dist_first",
           "replay_entropy_first", "replay_dist", "replay_change")
ROUNDING_GRAD = 1e-3  # a leaf's first gradient below this share of the median leaf's


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / abs(b) if b else abs(a)


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / scale if scale else abs(a - b)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    keep = [k for k in keep if k in ref]
    if not keep:
        return 0.0
    median = statistics.median(ref[k] for k in keep)
    worst = 0.0
    for k in keep:
        p = prog.get(k, math.nan)
        if not math.isfinite(p):
            return math.inf
        scale = max(ref[k], median)
        worst = max(worst, abs(p - ref[k]) / scale if scale else abs(p))
    return worst


def moving_leaves(first_grad: Dict[str, float]) -> list:
    median = statistics.median(first_grad.values())
    return [k for k, g in first_grad.items() if g >= ROUNDING_GRAD * median]


def _changes(prog: dict, ref: dict) -> float:
    """The worst leaf's change over nets and EMA, of the leaves that move."""
    worst = 0.0
    for net, grads in (("disc", "disc"), ("gen", "gen"), ("ema", "gen")):
        first = ref["first_grad"].get(grads)
        keep = moving_leaves(first) if first else list(ref["change"][net])
        worst = max(worst, worst_leaf(prog["change"][net], ref["change"][net], keep))
    return worst


def numbers(prog: dict, ref: dict, replay: dict, replay_ref: dict) -> Dict[str, float]:
    """The check's numbers from the program's and the reference's readings
    (``reference.train``'s layout) of the first cycle and of the check
    call."""
    if len(prog["dist"]) < len(ref["dist"]) or len(replay["dist"]) < len(replay_ref["dist"]):
        return {k: math.inf for k in NUMBERS}
    return {
        "dist_first": _rel(prog["dist"][0], ref["dist"][0]),
        "entropy_first": _rel(prog["entropy"][0], ref["entropy"][0]),
        "dist": max(_rel(p, r) for p, r in zip(prog["dist"], ref["dist"])),
        "grad": worst_leaf(prog["first_grad"]["disc"], ref["first_grad"]["disc"],
                           ref["first_grad"]["disc"]),
        "change": _changes(prog, ref),
        "replay_dist_first": _gap(replay["dist"][0], replay_ref["dist"][0],
                                  replay_ref["dist_scale"][0]),
        "replay_entropy_first": _rel(replay["entropy"][0], replay_ref["entropy"][0]),
        "replay_dist": max(_gap(p, r, s) for p, r, s in zip(
            replay["dist"], replay_ref["dist"], replay_ref["dist_scale"])),
        "replay_change": _changes(replay, replay_ref),
    }


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit", "ok"}}`` of every number with a limit."""
    return {k: {"value": values[k], "limit": lim, "ok": values[k] <= lim}
            for k, lim in limits.items()}
