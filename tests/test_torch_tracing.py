"""The trainer's ``--profile_dir`` and ``--debug_nans`` on the CPU, on the
toy (batch 16, 1:1 schedule, short epochs).

``--profile_dir`` writes a Chrome trace of the run that holds the step
spans and their phase spans, also when the run raises. ``--debug_nans``
raises ``FloatingPointError`` at the step whose batch carries a NaN, naming
it, and not before; without the flag the same run ends with the NaN
visible in ``dist`` (the JAX package's probe: NaN in, NaN out, not masked).
"""

import json
import math
import os

import numpy as np
import pytest

from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.utils.tracing import PHASE_SPANS, summarize, trace_path

POISONED = 3  # 0-based index of the step whose batch holds a NaN


@pytest.fixture
def toy_run(tmp_path, monkeypatch):
    """argv of a toy run of 6 steps whose 4th batch holds a NaN."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "3")
    seen = []

    def poisoned_epoch(rng, batch_size, n_batches=78):
        for _ in range(n_batches):
            x = sample_8gaussians(rng, batch_size)
            if len(seen) == POISONED:
                x[0, 0] = np.nan
            seen.append(1)
            yield x

    monkeypatch.setattr(train_mod, "_toy_epoch", poisoned_epoch)
    return ["--model", "toy_mlp", "--batch_size", "16", "--sinkhorn_lambda", "50",
            "--nr_sinkhorn_iter", "10", "--nr_gen_per_disc", "1", "--max_epochs", "2",
            "--log_every_steps", "1", "--save_dir", str(tmp_path / "run"), "--device", "cpu"]


def test_profile_dir_writes_a_trace_with_the_step_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "1")
    trace_dir = str(tmp_path / "trace")
    result = train_mod.main(["--model", "toy_mlp", "--batch_size", "16", "--nr_sinkhorn_iter",
                             "10", "--nr_gen_per_disc", "1", "--max_epochs", "2",
                             "--save_dir", str(tmp_path / "run"), "--device", "cpu",
                             "--profile_dir", trace_dir])
    assert result.state.step == 2
    summary = summarize(trace_path(trace_dir))
    spans = summary["spans"]
    assert spans["disc_step"][0] == 1 and spans["gen_step"][0] == 1
    assert all(spans[name][0] == 2 for name in PHASE_SPANS), spans
    assert summary["kernels"] == {}  # no card: the trace holds host activity only


def test_debug_nans_raises_at_the_poisoned_step(toy_run, tmp_path):
    trace_dir = str(tmp_path / "trace")
    with pytest.raises(FloatingPointError, match=f"non-finite loss at step {POISONED} "):
        train_mod.main(toy_run + ["--debug_nans", "--profile_dir", trace_dir])
    with open(os.path.join(tmp_path / "run", "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "dist" in r and "epoch" not in r]
    # the steps before it ran, were checked and logged finite values
    assert [r["step"] for r in steps] == list(range(1, POISONED + 1))
    assert all(math.isfinite(r["dist"]) for r in steps)
    # the trace is written when the run raises too
    assert summarize(trace_path(trace_dir))["spans"]["gen_step"][0] >= 1


def test_without_debug_nans_the_nan_stays_visible(toy_run):
    result = train_mod.main(toy_run)
    dists = [r["dist"] for r in result.steps]
    assert len(dists) == 6 and all(math.isfinite(d) for d in dists[:POISONED])
    assert math.isnan(dists[POISONED]) and math.isnan(dists[-1])
