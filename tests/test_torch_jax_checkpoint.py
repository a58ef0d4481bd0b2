"""Reading the JAX package's checkpoint files into the port, on the CPU.

``otgan_tpu.utils.checkpoint.save_checkpoint`` writes the file (leaves of
the ``TrainState`` pytree as ``leaf_<i>``, bfloat16 slots as
``leaf_<i>__bf16``); the port's ``restore_checkpoint`` must then give the
state that ``convert.state_from_jax`` makes of the JAX package's own restore
of the same file, bit for bit (every leaf is float32 there; bfloat16 slots
decode exactly). Each leaf is filled with its own random values first, so a
leaf read in the wrong place cannot pass. Also: ``convert.jax_leaves``
against the JAX writer's leaves, the trainer resuming a JAX run's directory
at the next epoch, ``evaluate`` scoring a JAX run's checkpoint, and the
port's own files, which still restore as before.
"""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the numpy BLAS pool then keeps its own size
    threadpool_limits = None

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu.utils import checkpoint as jax_ckpt
from otgan_tpu_torch import convert
from otgan_tpu_torch import evaluate as ev
from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.eval import random_weights as rw
from otgan_tpu_torch.utils import checkpoint as ckpt

B = 8


@pytest.fixture(autouse=True)
def _two_threads():
    """Full-width DCGAN states: two intra-op threads. The suite runs several
    pytest workers at once, and oversubscribed thread pools made such tests
    several times slower than alone. numpy's BLAS pool (the FID's 2048^2
    eigendecompositions) is held to two threads too."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2) if threadpool_limits else contextlib.nullcontext():
        yield
    torch.set_num_threads(n)


def _kw(model, optimizer="adam", **extra):
    return dict(model=model, batch_size=B, optimizer=optimizer, data_dependent_init=False,
                compute_dtype="float32", num_devices=1, **extra)


def _x_init(model):
    rng = np.random.default_rng(0)
    if model == "toy_mlp":
        return rng.normal(size=(B, 2)).astype(np.float32)
    return rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)


def _jax_state(model, optimizer, seed=1, **extra):
    """A JAX TrainState of the configuration with every float leaf random,
    step 7 and a random key."""
    eng = JaxEngine(JaxConfig(**_kw(model, optimizer, **extra)))
    state, _ = eng.init_state(0, eng.shard(_x_init(model)))
    leaves, treedef = jax.tree.flatten(jax.device_get(state))
    rng = np.random.default_rng(seed)
    out = []
    for leaf in leaves:
        leaf = np.asarray(leaf)
        if leaf.dtype == np.float32:
            out.append(rng.standard_normal(leaf.shape, dtype=np.float32))
        elif leaf.dtype == np.uint32:  # the PRNG key
            out.append(rng.integers(0, 2**32, leaf.shape, dtype=np.uint32))
        else:
            out.append(np.full(leaf.shape, 7, leaf.dtype))  # the step
    return jax.tree.unflatten(treedef, out)


def _port_state(model, optimizer="adam"):
    eng = Engine(TrainConfig(**_kw(model, optimizer)), device="cpu")
    state, _ = eng.init_state(0, _x_init(model))
    return eng, state


def _tensors(state):
    return {k: t.detach().clone() for k, t in ckpt._named_tensors(state)}


@pytest.mark.parametrize("model,optimizer,slot_dtype", [
    ("toy_mlp", "adam", "float32"),
    ("toy_mlp", "adamax", "bfloat16"),
    ("toy_mlp", "nesterov", "bfloat16"),
    ("dcgan", "adam", "bfloat16"),
    ("dcgan", "adamax", "float32"),
])
def test_jax_file_restores_as_state_from_jax(tmp_path, model, optimizer, slot_dtype):
    js = _jax_state(model, optimizer)
    path = jax_ckpt.save_checkpoint(str(tmp_path), js, 3, slot_dtype=slot_dtype)
    back = jax.device_get(jax_ckpt.restore_checkpoint(path, js))
    del js
    assert ckpt.checkpoint_format(path) == "jax"

    eng, want = _port_state(model, optimizer)
    convert.state_from_jax(eng, want, back)
    _, got = _port_state(model, optimizer)
    ckpt.restore_checkpoint(path, got)
    tw, tg = _tensors(want), _tensors(got)
    assert tw.keys() == tg.keys()
    for k in tw:
        assert tg[k].dtype == torch.float32 and torch.equal(tg[k], tw[k]), k
    assert got.step == want.step == 7
    if optimizer == "adam":
        assert got.gen_opt.t == want.gen_opt.t and got.disc_opt.t == want.disc_opt.t
    # the generator is seeded from the JAX key's words, deterministically
    seed = convert.seed_from_jax_key(back.rng)
    assert torch.equal(got.rng.get_state(), torch.Generator().manual_seed(seed).get_state())

    # the port's leaf order and layouts are the JAX writer's, leaf for leaf
    mine = convert.jax_leaves(got, rng_key=np.asarray(back.rng))
    theirs = [np.asarray(x) for x in jax.tree.leaves(back)]
    assert len(mine) == len(theirs) == len(convert.jax_leaf_names(got))
    for name, a, b in zip(convert.jax_leaf_names(got), mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_jax_leaves_written_by_the_port_restore_in_jax(tmp_path):
    """A file the port writes from ``jax_leaves`` (what ``chip_smoke.py``
    builds on the card) restores in the JAX package into the template's
    structure, every leaf equal."""
    _, state = _port_state("toy_mlp", "adam")
    state.step = 5
    leaves = convert.jax_leaves(state, rng_key=(3, 4))
    path = tmp_path / "otgan_state-2.npz"
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    js = _jax_state("toy_mlp", "adam")
    back = jax.device_get(jax_ckpt.restore_checkpoint(str(path), js))
    for a, b in zip(leaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(back.step) == 5 and list(np.asarray(back.rng)) == [3, 4]


def test_wrong_configuration_and_formats_are_refused(tmp_path):
    js = _jax_state("toy_mlp", "adam")
    path = jax_ckpt.save_checkpoint(str(tmp_path), js, 1)
    _, adamax = _port_state("toy_mlp", "adamax")
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(path, adamax)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    del arrays["leaf_3"]
    np.savez(tmp_path / "otgan_state-9.npz", **arrays)
    _, state = _port_state("toy_mlp", "adam")
    with pytest.raises(ValueError, match="leaf_0"):
        ckpt.restore_checkpoint(str(tmp_path / "otgan_state-9.npz"), state)
    orbax = tmp_path / "orbax" / "4"
    orbax.mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.checkpoint_format(str(orbax))


def test_port_checkpoint_still_restores(tmp_path):
    eng, state = _port_state("toy_mlp", "adamax")
    state.step = 4
    path = ckpt.save_checkpoint(str(tmp_path), state, 2, slot_dtype="bfloat16")
    assert ckpt.checkpoint_format(path) == "port"
    _, fresh = _port_state("toy_mlp", "adamax")
    ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 4
    assert torch.equal(fresh.rng.get_state(), state.rng.get_state())
    for k, t in _tensors(state).items():
        want = t.to(torch.bfloat16).float() if k.split("/")[0] in ("gen_ema", "disc_opt",
                                                                   "gen_opt") else t
        assert torch.equal(_tensors(fresh)[k], want), k


def test_trainer_resumes_a_jax_run(tmp_path, monkeypatch, capsys):
    """The JAX trainer runs the toy 2 epochs and saves at epoch 1; the
    port's trainer, with ``--load_params`` on that directory, says it read
    the JAX format and resumes at epoch 2 from the JAX run's step."""
    from otgan_tpu.train import train as jax_train

    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "3")
    kw = dict(model="toy_mlp", batch_size=64, sinkhorn_lambda=50.0, nr_sinkhorn_iter=5,
              save_every_epochs=1, save_dir=str(tmp_path), nr_gen_per_disc=1)
    jax_state = jax_train(JaxConfig(max_epochs=2, use_pallas=False,
                                    compilation_cache_dir=str(tmp_path / "xla"), **kw))
    assert os.path.exists(tmp_path / "otgan_state-1.npz")
    capsys.readouterr()
    res = train_mod.main(["--device", "cpu", "--max_epochs", "4", "--load_params",
                          "--log_every_steps", "1"] + [f"--{k}={v}" for k, v in kw.items()])
    out = capsys.readouterr().out
    assert "(jax checkpoint format); resuming at epoch 2" in out
    with open(tmp_path / "metrics.jsonl") as f:
        epochs = [r["epoch"] for r in map(json.loads, f) if "epoch" in r]
    assert epochs[-2:] == [2, 3]
    assert res.steps[0]["step"] == int(jax_state.step) + 1
    assert res.state.step == int(jax_state.step) + 6
    assert all(np.isfinite([r["dist"], r["entropy"]]).all() for r in res.steps)


def test_evaluate_scores_a_jax_checkpoint(tmp_path, monkeypatch):
    """A JAX run's directory (the tiny DenseNet: its config.json, with a
    matching precision the port does not train with, and its checkpoint)
    through the port's ``evaluate`` with fixed-seed random weights: 2
    samples, 2 splits, finite scores, FID against statistics of 2
    real-shaped images."""
    monkeypatch.setenv("OTGAN_INCEPTION_WEIGHTS", rw.save_npz(
        str(tmp_path / "w.npz"), seed=0, variant="tf2015", num_classes=10))
    run = tmp_path / "run"
    run.mkdir()
    tiny = dict(layers_per_block=1, filters_per_layer=4)
    JaxConfig(**_kw("densenet", **tiny), save_dir=str(run), matching_precision="high").save(
        str(run / "config.json"))
    jax_ckpt.save_checkpoint(str(run), _jax_state("densenet", "adam", **tiny), 5,
                             slot_dtype="bfloat16")
    from otgan_tpu_torch.eval import fid as fid_mod

    stats = str(tmp_path / "stats.npz")
    imgs = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    np.save(tmp_path / "imgs.npy", imgs)
    fid_mod.main(["--images", str(tmp_path / "imgs.npy"), "--out", stats, "--device", "cpu"])
    res = ev.main(["--save_dir", str(run), "--num_samples", "2", "--batch_size", "2",
                   "--splits", "2", "--ema", "--fid_stats_path", stats, "--fid_samples", "2",
                   "--device", "cpu"])
    assert res["checkpoint"].endswith("otgan_state-5.npz") and res["num_samples"] == 2
    assert np.isfinite(res["inception_score"]) and res["inception_score"] >= 1.0 - 1e-6
    assert np.isfinite(res["fid"]) and res["fid"] >= 0.0
