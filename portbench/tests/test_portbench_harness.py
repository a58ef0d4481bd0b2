"""The harness end to end on the CPU at a tiny size: the pieces of a cell
are found by name in a benchmark root (a new configuration, cell and
per-layer metric are files, with no code edit), the last line has the
contract's shape, and a run whose timed path is broken underneath comes out
not correct, once for each fault a one-chip training cell can have and for
the control's lower precision."""

from __future__ import annotations

import json
import math
import os
import time

import pytest
import torch

from portbench import calibrate, harness, spec
from portbench.tests.conftest import TINY, emulated_graphs

SEED = 1


def run(root: str, traced: bool = False, variant: str = "program", seed: int = SEED):
    """One run of the tiny cell on the CPU, the chip's look skipped, its
    calls after the first replays of emulated graphs as on the card;
    ``variant`` breaks the timed path as that calibration variant does."""
    cell = spec.load(root, TINY)
    extra, fault = calibrate.plant(variant)
    with emulated_graphs() as graphs_on:
        def patch(engine):
            graphs_on(engine)
            if fault is not None:
                fault(engine)

        return harness.run(cell, seed, 0.5, traced, time.time(), torch.device("cpu"), extra,
                           patch)


def test_new_pieces_are_found_by_name(tiny_root):
    """A metric added as a file beside the others, and listed in
    BENCHMARK.json, is read and reported with no edit of the harness."""
    metrics = os.path.join(tiny_root, "portbench", "metrics")
    with open(os.path.join(metrics, "calls_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.calls)\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "lower",
                               "source": "host_clock", "layer": "test", "moves": "setup_s"})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.load(tiny_root, TINY)
    assert cell.config["batch_size"] == 4 and cell.traffic["synthetic_size"] == 8
    assert "calls_traced" in cell.readers
    out = run(tiny_root, traced=True)
    assert out["result"]["metrics"]["calls_traced"] == {"value": 2.0, "unit": "calls"}


def test_last_line_shape(tiny_root):
    out = run(tiny_root)
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"train_img_per_s", "peak_mem_gb", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["info"]["replays_per_call"] == 1.0  # every call of the window replays
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] <= c["limit"], name
    json.dumps(res)  # one JSON line


def test_traced_line_shape(tiny_root):
    res = run(tiny_root, traced=True)["result"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "train_img_per_s" not in res["metrics"]
    # the CPU runs no device kernel: no device metric is reported from it
    assert not {"model_device_ms", "sinkhorn_roofline", "step_mfu"} & set(res["metrics"])


@pytest.mark.parametrize("variant", ["unchanged", "half", "control", "stale"])
def test_broken_timed_path_is_not_correct(tiny_root, variant):
    """``stale`` breaks the replays alone: the first cycle, which runs
    eagerly, reads right, and the check call after the window catches it."""
    res = run(tiny_root, variant=variant)["result"]
    assert res["correct"] is False
    failed = {k for k, c in res["checks"].items()
              if c["value"] > c["limit"] or not math.isfinite(c["value"])}
    assert failed
    if variant == "stale":
        assert failed <= {k for k in res["checks"] if k.startswith("replay_")}


def test_replay_distance_gap_is_over_the_terms():
    """The check call's distance numbers divide the gap by the size of the
    terms the distance is the difference of, so one rounding of those terms
    reads alike whether training has brought the distance near them or far
    under them; the distance never exceeds that size."""
    from portbench import check
    from portbench.reference import train as reference

    g = torch.Generator().manual_seed(0)
    fa, fb = torch.nn.functional.normalize(torch.randn(8, 5, generator=g), dim=1), \
        torch.nn.functional.normalize(torch.randn(8, 5, generator=g), dim=1)
    a_a, b_b, a_b, _, _ = reference.match(fa, fb, 2.0, 20)
    scale = reference.distance_scale(fa, fb, a_a, b_b, a_b)
    assert abs(float(reference.distance(fa, fb, a_a, b_b, a_b))) <= scale
    first = {"dist": [0.3], "entropy": [1.0], "first_grad": {"disc": {"w": 1.0}},
             "change": {net: {"w": 1.0} for net in ("disc", "gen", "ema")}}
    for d in (0.9, 0.003):
        replay = {"dist": [d + 1e-7], "entropy": [1.0], "change": first["change"]}
        replay_ref = dict(replay, dist=[d], dist_scale=[2.0], first_grad={})
        n = check.numbers(first, first, replay, replay_ref)
        assert n["replay_dist_first"] == pytest.approx(5e-8, rel=1e-6)
        assert n["replay_dist"] == n["replay_dist_first"]
