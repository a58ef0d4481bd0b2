"""The cell ``densenet.b5000`` is found by name: its configuration, its
model family's plain reference, its limits and its readers; and the
yardstick counts its model from the configuration's conv table."""

from __future__ import annotations

import os

import pytest

from portbench import counts, spec
from portbench.tests.conftest import ROOT

CELL = "densenet.b5000"
H100 = counts.peaks("NVIDIA H100 80GB HBM3")
EXP = 132 * 16 * 1980e6  # 132 SMs x 16 MUFU.EX2 a clock x 1980 MHz


def test_cell_is_found_by_name():
    cell = spec.load(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["synthetic_size"] == 50000
    assert cell.config["name"] == "densenet_train_py" and cell.config["model"] == "densenet"
    assert (cell.config["batch_size"], cell.config["grad_accum"], cell.config["feature_dim"]) == (
        5000, 4, 7296)
    assert cell.family.__file__ == os.path.join(ROOT, "portbench", "reference", "densenet.py")
    for name in ("draw", "images", "critic", "generator", "init_latent", "latent"):
        assert callable(getattr(cell.family, name)), name
    assert set(cell.limits) == {"dist_first", "entropy_first", "dist", "grad", "change",
                                "replay_dist_first", "replay_entropy_first", "replay_dist",
                                "replay_change"}
    assert "refeatures_device_ms" in cell.readers
    # every per-layer metric without a list of cells is read here too
    assert {"step_mfu", "backward_device_ms", "sinkhorn_roofline"} <= set(cell.readers)


def test_refeatures_is_read_in_no_other_cell():
    for name in ("train_py.b5000", "model_saving.b8000"):
        assert "refeatures_device_ms" not in spec.load(ROOT, name).readers


def test_least_time_of_a_step():
    """A generator step at batch 5000 on an H100: ~159 ms of bf16 model
    work (3 x 7.622 + 3 x 2.874 GFLOP an image, less the dense layer's
    input gradient), 24.5 ms of float32 matcher products (18 x 2500^2 x
    7296 x 2 FLOP) and the Sinkhorn loop's 8.97 ms MUFU bound."""
    cfg = spec.load(ROOT, CELL).config
    gen = counts.step_least_s(cfg, False, 1, H100, EXP)
    assert gen["model"] * 1e3 == pytest.approx(159.2, abs=0.1)
    assert gen["gemm"] * 1e3 == pytest.approx(24.5, abs=0.05)
    assert gen["sinkhorn"] * 1e3 == pytest.approx(8.97, abs=0.01)
    disc = counts.step_least_s(cfg, True, 1, H100, EXP)
    assert disc["model"] < gen["model"]
