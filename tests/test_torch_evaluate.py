"""The port's eval entry points on the CPU: twins of the JAX package's
trainer-CLI tests (``tests/test_train_driver.py``) for the evaluate CLI, the
classifier-batch flag, the trainer's eval events (running max, FID, the
host-reduce protocol), the rule that a user's ``--fid_stats_path`` is never
written, launch validation, and the statistics CLI's input check.

Each run uses fixed-seed random InceptionV3 weights written to a temporary
npz (``OTGAN_INCEPTION_WEIGHTS``), tiny image counts, classifier batches of
2 and the tiny DenseNet, as the JAX tests do.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the numpy BLAS pool then keeps its own size
    threadpool_limits = None

from otgan_tpu_torch import evaluate as ev
from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig, parse_args
from otgan_tpu_torch.eval import fid as fid_mod
from otgan_tpu_torch.eval import inception as inc
from otgan_tpu_torch.eval import random_weights as rw
from otgan_tpu_torch.eval.inception_net import InceptionV3


@pytest.fixture(autouse=True)
def _two_threads():
    """InceptionV3 forwards at 299^2: two intra-op threads. The suite runs
    several pytest workers at once, and oversubscribed thread pools made
    such tests several times slower than alone. numpy's BLAS pool (the FID's 2048^2
    eigendecompositions) is held to two threads too."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2) if threadpool_limits else contextlib.nullcontext():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def _weights_file(tmp_path_factory):
    """Random torchvision-variant weights with 8 classes, written once."""
    return rw.save_npz(str(tmp_path_factory.mktemp("inception") / "inception.npz"), seed=0,
                       variant="torchvision", num_classes=8)


@pytest.fixture
def weights(_weights_file, monkeypatch):
    """The random weights at the weights path."""
    monkeypatch.setenv("OTGAN_INCEPTION_WEIGHTS", _weights_file)
    return _weights_file


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tiny_densenet(save_dir, **kw):
    base = dict(model="densenet", layers_per_block=1, filters_per_layer=4, synthetic_data=True,
                synthetic_size=16, batch_size=8, sinkhorn_lambda=50.0, nr_sinkhorn_iter=5,
                max_epochs=2, eval_every_epochs=2, inception_samples=4, inception_splits=2,
                inception_batch=2, save_every_epochs=100, save_dir=str(save_dir),
                compute_dtype="float32")
    base.update(kw)
    return TrainConfig(**base)


def test_evaluate_cli(tmp_path, weights, monkeypatch):
    """A toy checkpoint through the CLI with the scorer stubbed (toy
    samples are 2-D points); then FID against precomputed statistics with
    the features stubbed, as the JAX package's test does."""
    run = tmp_path / "run"
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "2")
    train_mod.train(TrainConfig(model="toy_mlp", batch_size=64, sinkhorn_lambda=50.0,
                                nr_sinkhorn_iter=5, max_epochs=2, save_every_epochs=1,
                                save_dir=str(run)), device="cpu")
    calls = []

    def fake_score(images, splits=10, net=None, **kw):
        assert images.shape[0] == 128 and splits == 2 and isinstance(net, InceptionV3)
        calls.append(images.shape)
        return 5.5, 0.25

    monkeypatch.setattr(inc, "get_inception_score", fake_score)
    argv = ["--save_dir", str(run), "--model", "toy_mlp", "--batch_size", "64",
            "--num_samples", "128", "--splits", "2", "--device", "cpu"]
    res = ev.main(argv)
    assert res["inception_score"] == 5.5 and res["num_samples"] == 128 and calls
    assert res["checkpoint"].endswith("otgan_state-1.npz")

    monkeypatch.setattr(fid_mod, "pool_features", lambda imgs, **kw: np.random.default_rng(
        0).normal(size=(imgs.shape[0], 4)))
    stats = str(tmp_path / "ref_stats.npz")
    fid_mod.save_reference_statistics(stats, np.zeros(4), np.eye(4), "torchvision", 100)
    res2 = ev.main(argv + ["--fid_stats_path", stats, "--fid_samples", "64"])
    assert "fid" in res2 and np.isfinite(res2["fid"]) and res2["fid"] >= 0.0
    fid_mod.save_reference_statistics(stats, np.zeros(4), np.eye(4), "tf2015", 100)
    with pytest.raises(ValueError, match="variant"):
        ev.main(argv + ["--fid_stats_path", stats])


def test_evaluate_cli_without_weights_fails_before_sampling(tmp_path, monkeypatch):
    monkeypatch.setenv("OTGAN_INCEPTION_WEIGHTS", str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError, match="Inception weights"):
        ev.main(["--save_dir", str(tmp_path), "--checkpoint", "unused.npz", "--device", "cpu"])


def test_inception_batch_flag():
    cfg = parse_args(["--inception_batch", "500"])
    assert cfg.inception_batch == 500
    assert parse_args([]).inception_batch == 0  # the module default
    assert parse_args(["--eval_fid"]).eval_fid


def test_inception_eval_running_max_in_train(tmp_path, weights):
    """One eval event at epoch 1 (not at the run's first epoch 0): raw and
    EMA scores, and the reference's running max over both with its epoch."""
    train_mod.train(_tiny_densenet(tmp_path), device="cpu")
    recs = _records(tmp_path)
    raw = [r for r in recs if "inception_score" in r]
    ema = [r for r in recs if "ema_inception_score" in r]
    mx = [r for r in recs if "max_inception_score" in r]
    assert len(raw) == 1 and len(ema) == 1 and len(mx) == 1
    assert mx[0]["max_inception_score"] == max(raw[0]["inception_score"],
                                               ema[0]["ema_inception_score"])
    assert mx[0]["max_inception_epoch"] == 1
    assert all(np.isfinite(r[k]) for r in raw + ema for k in r if "inception" in k)
    assert not [r for r in recs if "fid" in r]  # FID only under --eval_fid


def test_eval_skipped_without_weights_and_for_the_toy(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OTGAN_INCEPTION_WEIGHTS", str(tmp_path / "nope.npz"))
    train_mod.train(_tiny_densenet(tmp_path / "a"), device="cpu")
    assert "inception weights unavailable, skipping eval" in capsys.readouterr().out
    assert not [r for r in _records(tmp_path / "a") if "inception_score" in r]
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "2")
    train_mod.train(TrainConfig(model="toy_mlp", batch_size=64, sinkhorn_lambda=50.0,
                                nr_sinkhorn_iter=5, max_epochs=2, eval_every_epochs=1,
                                save_dir=str(tmp_path / "b")), device="cpu")
    assert "skipping eval" not in capsys.readouterr().out


def test_fid_eval_in_train(tmp_path, weights):
    """--eval_fid: the real data's statistics are computed once and cached
    to <save_dir>/fid_stats.npz (readable by the JAX package), and raw and
    EMA FIDs are logged beside the scores; a later run reads the cache
    (with no loader: it must not compute) and leaves it as it is."""
    from otgan_tpu.eval import fid as jax_fid

    train_mod.train(_tiny_densenet(tmp_path, eval_fid=True), device="cpu")
    stats_path = os.path.join(str(tmp_path), "fid_stats.npz")
    assert os.path.exists(stats_path), "reference statistics not cached"
    mu, sigma = jax_fid.load_reference_statistics(stats_path, expect_variant="torchvision")
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    recs = _records(tmp_path)
    fids = [r for r in recs if "fid" in r]
    ema_fids = [r for r in recs if "ema_fid" in r]
    assert len(fids) == 1 and len(ema_fids) == 1
    assert np.isfinite(fids[0]["fid"]) and fids[0]["fid"] >= 0.0
    assert np.isfinite(ema_fids[0]["ema_fid"])
    before = open(stats_path, "rb").read()
    cached = train_mod._fid_reference_stats(_tiny_densenet(tmp_path, eval_fid=True), None,
                                            InceptionV3(8, "torchvision"), train_mod.EvalCache())
    np.testing.assert_array_equal(cached[0], mu)
    assert open(stats_path, "rb").read() == before


class _Log:
    def __init__(self):
        self.recs = []

    def log(self, step, **kw):
        self.recs.append(kw)


class _Loader:
    def images_255(self, limit=None):
        return np.random.default_rng(1).integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)


class _Engine:
    device = torch.device("cpu")

    def latents(self, batch, gen):
        return torch.rand((batch, 3), generator=gen)

    def sample(self, state, z, ema=False):
        return torch.rand((z.shape[0], 16, 16, 3), generator=torch.Generator().manual_seed(
            int(z.sum() * 1e6) + ema)) * 2 - 1


def test_eval_fid_host_reduce_protocol(tmp_path, weights, monkeypatch):
    """OTGAN_EVAL_DEVICE_REDUCE=0 with --eval_fid: the host-float64 score
    protocol holds (the combined device-reduced scorer does not run) and
    the FIDs are still logged."""
    monkeypatch.setenv("OTGAN_EVAL_DEVICE_REDUCE", "0")

    def _boom(*a, **kw):
        raise AssertionError("combined scorer ran under the host-reduce protocol")

    monkeypatch.setattr(fid_mod, "combined_eval_from_sampler", _boom)
    cfg = TrainConfig(eval_fid=True, inception_samples=4, inception_splits=2, batch_size=4,
                      inception_batch=2, save_dir=str(tmp_path))
    log = _Log()
    best = train_mod._maybe_inception_eval(cfg, _Engine(), None, log, 0, _Loader(),
                                           train_mod.EvalCache())
    keys = set().union(*[set(r) for r in log.recs])
    assert {"fid", "ema_fid", "inception_score", "ema_inception_score"} <= keys
    fid_vals = [r["fid"] for r in log.recs if "fid" in r]
    assert np.isfinite(fid_vals[0]) and fid_vals[0] >= 0.0
    scores = [r[k] for r in log.recs for k in ("inception_score", "ema_inception_score") if k in r]
    assert best == max(scores)


def test_fid_stats_path_never_clobbered(tmp_path):
    """A --fid_stats_path that cannot be used (another weight variant, a
    foreign archive) turns FID off and is left byte for byte; the decision
    is kept per path and run."""
    net = InceptionV3(8, "torchvision")
    p = str(tmp_path / "stats.npz")
    fid_mod.save_reference_statistics(p, np.zeros(4), np.eye(4), "tf2015", 7)
    before = open(p, "rb").read()
    cfg = TrainConfig(fid_stats_path=p, save_dir=str(tmp_path))
    cache = train_mod.EvalCache()
    assert train_mod._fid_reference_stats(cfg, None, net, cache) is None
    assert open(p, "rb").read() == before
    assert train_mod._fid_reference_stats(cfg, None, net, cache) is None  # kept

    p2 = str(tmp_path / "foreign.npz")
    np.savez(p2, mu=np.zeros(4), sigma=np.eye(4))  # no variant key
    before2 = open(p2, "rb").read()
    cfg2 = TrainConfig(fid_stats_path=p2, save_dir=str(tmp_path))
    assert train_mod._fid_reference_stats(cfg2, None, net, train_mod.EvalCache()) is None
    assert open(p2, "rb").read() == before2


def test_launch_validation_rejects_missing_fid_stats_and_bad_batch(tmp_path):
    cfg = TrainConfig(model="toy_mlp", batch_size=16, save_dir=str(tmp_path), eval_fid=True,
                      fid_stats_path=str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError, match="fid_stats_path"):
        train_mod.train(cfg, device="cpu")
    cfg2 = TrainConfig(model="toy_mlp", batch_size=16, save_dir=str(tmp_path),
                       inception_batch=-100)
    with pytest.raises(ValueError, match="inception_batch"):
        train_mod.train(cfg2, device="cpu")
    assert not os.path.exists(tmp_path / "config.json")  # rejected before anything ran


def test_fid_reference_stats_disabled_when_user_path_vanishes(tmp_path):
    p = str(tmp_path / "gone.npz")
    cfg = TrainConfig(fid_stats_path=p, save_dir=str(tmp_path))
    assert train_mod._fid_reference_stats(cfg, None, InceptionV3(8), train_mod.EvalCache()) is None
    assert not os.path.exists(p)


@pytest.mark.parametrize("low", [0.0, -1.0])
def test_fid_cli_rejects_normalized_image_stack(tmp_path, low):
    """A [0, 1] or [-1, 1] stack is refused, not scored as near-black
    [0, 255] images, and no file is written."""
    p = str(tmp_path / "norm.npy")
    np.save(p, np.random.default_rng(0).uniform(low, 1, (8, 32, 32, 3)))
    with pytest.raises(ValueError, match="uint8-range"):
        fid_mod.main(["--images", p, "--out", str(tmp_path / "o.npz"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "o.npz")


def test_fid_cli_synthetic_set_is_the_trainers(tmp_path, weights, monkeypatch):
    """--synthetic_data --synthetic_size N --seed S: the statistics of the
    images the trainer's --synthetic_data run draws for the same seed and
    size; the file works as a trainer's --fid_stats_path and is not written
    by the run."""
    out = str(tmp_path / "syn.npz")
    monkeypatch.setenv("OTGAN_INCEPTION_BATCH", "3")
    fid_mod.main(["--synthetic_data", "--synthetic_size", "4", "--seed", "3", "--out", out,
                  "--device", "cpu"])
    cfg = _tiny_densenet(tmp_path / "run", seed=3, synthetic_size=4)
    loader = train_mod.make_loader(cfg, np.random.default_rng(cfg.seed))
    want = fid_mod.reference_statistics(loader.images_255(), net=inc.load_net(device="cpu"),
                                        batch=2)
    mu, sigma = fid_mod.load_reference_statistics(out, expect_variant="torchvision")
    np.testing.assert_allclose(mu, want[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sigma, want[1], rtol=1e-4, atol=1e-7)
    before = open(out, "rb").read()
    train_mod.train(_tiny_densenet(tmp_path / "run2", synthetic_size=16, eval_fid=True,
                                   fid_stats_path=out), device="cpu")
    assert open(out, "rb").read() == before
    assert [r for r in _records(tmp_path / "run2") if "fid" in r]
    with pytest.raises(SystemExit):
        fid_mod.main(["--synthetic_data", "--images", "x.npy", "--out", out])
