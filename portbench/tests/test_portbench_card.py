"""On a card (``cuda`` marker): a whole run of each one-card cell, at its own
size and with a short window, comes out not correct, on three seeds, under
the control (the matcher's products in one TF32 pass,
``--matching_precision default``) and under a fault of the graph replays
alone (``stale``: a graph replays on the batches of its capture).

``python -m pytest portbench/tests -m cuda`` from the root of a checkout on
a machine with an H100."""

from __future__ import annotations

import time

import pytest

from portbench import calibrate, harness, spec
from portbench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103])
@pytest.mark.parametrize("variant", ["control", "stale"])
@pytest.mark.parametrize("workload", ["train_py.b5000", "model_saving.b8000"])
def test_broken_run_is_not_correct(card, workload, variant, seed):
    cell = spec.load(ROOT, workload)
    extra, patch = calibrate.plant(variant)
    out = harness.run(cell, seed, 1.0, False, time.time(), card, extra, patch)
    harness.free_device(card)
    assert out["result"]["correct"] is False, out["result"]["checks"]
