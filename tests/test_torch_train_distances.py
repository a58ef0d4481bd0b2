"""The port's trainer keeps the per-epoch distance history as the JAX
trainer does: the twin of the JAX package's own
``test_short_epochs_never_log_nan_metrics``. Epochs too short to hold a
critic step under the 5:1 schedule carry the last epoch mean forward,
flagged ``dist_disc_carried``, and every checkpoint writes a NaN-free
``distances.npz`` with one entry an epoch.
"""

import json
import os

import numpy as np
import pytest
import torch

from otgan_tpu.utils.metrics import MetricLogger as JaxMetricLogger
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.train import train
from otgan_tpu_torch.utils.metrics import MetricLogger


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made such tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_short_epochs_never_log_nan_metrics(tmp_path, monkeypatch):
    """The toy on the CPU, 2 steps an epoch, 5:1, 4 epochs, saving at
    epoch 4: critic steps at steps 0 and 6, so epochs 1-2 have none."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "2")
    cfg = TrainConfig(model="toy_mlp", batch_size=64, sinkhorn_lambda=50.0, nr_sinkhorn_iter=5,
                      nr_gen_per_disc=5, max_epochs=4, save_every_epochs=4,
                      save_dir=str(tmp_path))
    train(cfg, "cpu")
    recs = [json.loads(line) for line in open(os.path.join(tmp_path, "metrics.jsonl"))]
    epochs = [r for r in recs if "epoch" in r]
    assert len(epochs) == 4
    for r in recs:  # no record anywhere carries a NaN
        for k, v in r.items():
            if isinstance(v, float):
                assert np.isfinite(v), (k, r)
    assert "dist_disc_carried" not in epochs[0]
    for r in epochs[1:3]:
        assert r["dist_disc_carried"] is True
        assert r["dist_disc"] == epochs[0]["dist_disc"]
    assert "dist_disc_carried" not in epochs[3]
    assert all("dist_gen_carried" not in r for r in epochs)
    hist = np.load(os.path.join(tmp_path, "distances.npz"))
    for key in ("mean_dist_gen", "mean_dist_disc"):
        assert hist[key].shape == (4,)
        assert np.isfinite(hist[key]).all()
    np.testing.assert_array_equal(hist["mean_dist_disc"][:3], epochs[0]["dist_disc"])
    np.testing.assert_array_equal(hist["mean_dist_gen"], [r["dist_gen"] for r in epochs])


@pytest.mark.parametrize("gen,disc", [
    ([None, None, 0.5, 0.25], [0.75, 0.75, 0.75, 0.5]),
    ([0.1, 0.2], [None, None]),
    ([], [None, 0.3])], ids=["backfill", "all-none", "empty"])
def test_nan_free_and_save_distances_match_jax(tmp_path, gen, disc):
    """The same ``None``-holding histories give equal arrays in both
    packages, through ``_nan_free`` and through ``distances.npz``."""
    for hist in (gen, disc):
        np.testing.assert_array_equal(MetricLogger._nan_free(hist),
                                      JaxMetricLogger._nan_free(hist))
    with MetricLogger(str(tmp_path / "port"), echo=False) as port:
        port_npz = np.load(port.save_distances(gen, disc))
    jax_logger = JaxMetricLogger(str(tmp_path / "jax"), echo=False)
    try:
        jax_npz = np.load(jax_logger.save_distances(gen, disc))
    finally:
        jax_logger.close()
    assert sorted(port_npz.files) == sorted(jax_npz.files)
    for key in jax_npz.files:
        assert port_npz[key].dtype == jax_npz[key].dtype
        np.testing.assert_array_equal(port_npz[key], jax_npz[key])
