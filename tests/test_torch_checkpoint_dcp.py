"""The port's sharded checkpoints (``--checkpoint_backend orbax``,
``otgan_tpu_torch/utils/checkpoint_orbax.py`` on
``torch.distributed.checkpoint``) and the dispatch in
``utils/checkpoint.py``, on the CPU.

A DCP round trip of a train state (the DCGAN's with bfloat16 slots, the
toy's in float32) restores what the npz backend restores, key for key and
bit for bit (tolerance 0): parameters exact, bfloat16 slots equal to their
rounding, which DCP casts into the float32 state; with background writes and with retention
(the npz backend's kept steps). A checkpoint written by 2 gloo ranks
restores on 1 process, and one written by 1 on 2 ranks; each tensor is
written once. A real checkpoint of the JAX package's orbax backend cannot
be read without orbax: ``--load_params`` on its directory raises, naming
it (before, the port trained from scratch). ``latest_checkpoint`` scans
both backends and passes over a step whose write did not finish.
"""

import contextlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from torch.distributed.checkpoint import FileSystemReader

from otgan_tpu.utils import checkpoint_orbax as jax_orbax
from otgan_tpu_torch import sample as sample_mod
from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.utils import checkpoint as ckpt
from otgan_tpu_torch.utils import checkpoint_orbax as dcp_ckpt
from tests.test_torch_jax_checkpoint import _jax_state
from tests.test_torch_parallel_worker import World, named_arrays, perturb_state

B = 8
SLOTS = ("gen_ema", "gen_opt", "disc_opt")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world2():
    w = World(2)
    yield w
    w.close()


def _cfg(model="toy_mlp", **kw):
    return dict(model=model, batch_size=B, compute_dtype="float32", data_dependent_init=False,
                **kw)


def _x_init(model):
    rng = np.random.default_rng(0)
    if model == "toy_mlp":
        return rng.normal(size=(B, 2)).astype(np.float32)
    return rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)


def _state(model="toy_mlp", seed=None):
    eng = Engine(TrainConfig(**_cfg(model)), device="cpu")
    state = eng.init_state(1, _x_init(model))[0]
    return perturb_state(state, seed) if seed is not None else state


def _assert_same(got: dict, want: dict, slots_bf16=False):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if slots_bf16 and k.split("/")[0] in SLOTS and isinstance(w, np.ndarray):
            w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("model,slot_dtype", [("dcgan", "bfloat16"), ("toy_mlp", "float32")])
def test_dcp_round_trip_equals_npz(tmp_path, model, slot_dtype):
    """At full width for the DCGAN (72M parameters)."""
    state, fresh = _state(model, seed=3), _state(model)
    saved = named_arrays(state)
    path = dcp_ckpt.save_checkpoint(str(tmp_path), state, 4, slot_dtype=slot_dtype,
                                    async_write=False)
    npz = ckpt.save_checkpoint(str(tmp_path), state, 3, slot_dtype=slot_dtype)
    assert path == os.path.join(str(tmp_path), "orbax", "4") and dcp_ckpt.is_committed(path)
    assert ckpt.checkpoint_format(path) == "dcp" and ckpt.checkpoint_step(path) == 4
    md = FileSystemReader(path).read_metadata().state_dict_metadata
    assert md["gen_ema/" + next(iter(state.gen_ema))].properties.dtype == (
        torch.bfloat16 if slot_dtype == "bfloat16" else torch.float32)
    ckpt.restore_checkpoint(npz, fresh)
    from_npz = named_arrays(fresh)
    perturb_state(fresh, 7)  # nothing of the npz restore may survive the next one
    ckpt.restore_checkpoint(path, fresh)
    got = named_arrays(fresh)
    assert all(fresh_t.dtype == torch.float32 for _, fresh_t in ckpt._named_tensors(fresh))
    _assert_same(got, from_npz)
    _assert_same(got, saved, slots_bf16=slot_dtype == "bfloat16")
    if slot_dtype == "bfloat16":  # the rounding happened: the slots were written compressed
        k = next(k for k in got if k.startswith("gen_ema/"))
        assert np.any(got[k] != saved[k])


def test_async_writes_and_retention_match_npz(tmp_path):
    state = _state(seed=4)
    dcp_dir, npz_dir = str(tmp_path / "dcp"), str(tmp_path / "npz")
    os.makedirs(os.path.join(dcp_dir, "orbax", "0"))
    open(os.path.join(dcp_dir, "orbax", "0", "__0_0.distcp"), "w").close()  # a crashed write
    jax_step = os.path.join(dcp_dir, "orbax", "9")
    os.makedirs(jax_step)
    open(os.path.join(jax_step, "_CHECKPOINT_METADATA"), "w").close()  # the JAX package's
    for step in (1, 2, 3, 4):
        state.step = step
        dcp_ckpt.save_checkpoint(dcp_dir, state, step, max_to_keep=2, keep_every_hours=5.0,
                                 async_write=True)
        ckpt.save_checkpoint(npz_dir, state, step, max_to_keep=2, keep_every_hours=5.0,
                             async_write=True)
    ckpt.wait_for_pending_saves()
    kept_npz = sorted(ckpt.checkpoint_step(os.path.join(npz_dir, f))
                      for f in os.listdir(npz_dir) if f.endswith(".npz"))
    assert sorted(dcp_ckpt.committed_steps(dcp_dir)) == kept_npz == [1, 3, 4]
    assert sorted(os.listdir(os.path.join(dcp_dir, "orbax"))) == ["1", "3", "4", "9"]
    fresh = _state()
    ckpt.restore_checkpoint(os.path.join(dcp_dir, "orbax", "4"), fresh)
    _assert_same(named_arrays(fresh), named_arrays(state))


def test_written_by_two_ranks_restores_on_one_and_back(world2, tmp_path):
    cfg, x_init = _cfg(), _x_init("toy_mlp")
    saved = world2.run("dcp_save", cfg=cfg, x_init=x_init, save_dir=str(tmp_path / "two"),
                       step=2, seed=5)[0]
    path = os.path.join(str(tmp_path / "two"), "orbax", "2")
    md = FileSystemReader(path).read_metadata()
    # each replicated tensor is written once, by one of the two ranks
    stored = [idx.fqn for idx in md.storage_data]
    assert len(stored) == len(set(stored)) == len(md.state_dict_metadata)
    assert {info.relative_path for info in md.storage_data.values()} <= {
        "__0_0.distcp", "__1_0.distcp"}
    one = _state()
    ckpt.restore_checkpoint(path, one)
    _assert_same(named_arrays(one), saved)

    state = _state(seed=6)
    path = dcp_ckpt.save_checkpoint(str(tmp_path / "one"), state, 3, async_write=False)
    for got in world2.run("dcp_restore", cfg=cfg, x_init=x_init, path=path):
        _assert_same(got, named_arrays(state))


def _port_run(save_dir, *extra, epochs=2):
    return ["--model", "toy_mlp", "--batch_size", str(B), "--sinkhorn_lambda", "50",
            "--nr_sinkhorn_iter", "5", "--nr_gen_per_disc", "1", "--save_every_epochs", "1",
            "--max_epochs", str(epochs), "--save_dir", save_dir, "--device", "cpu", *extra]


def test_latest_checkpoint_over_both_backends(tmp_path, monkeypatch):
    """npz at epoch 2, DCP at 4, the JAX package's orbax at 3, and a DCP
    write of step 6 that did not finish: the DCP step 4 is the latest; the
    trainer resumes there; ``sample.py`` reads it."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "2")
    run = str(tmp_path / "run")
    train_mod.main(_port_run(run, "--checkpoint_backend", "orbax", epochs=5))
    assert sorted(dcp_ckpt.committed_steps(run)) == [1, 2, 3, 4]
    ckpt.save_checkpoint(run, _state(seed=1), 2)
    jax_run = str(tmp_path / "jax_run")
    jax_orbax.save_checkpoint(jax_run, {"a": jax.numpy.ones(3)}, 3, async_write=False)
    jax_orbax.wait_for_pending_saves()
    shutil.rmtree(os.path.join(run, "orbax", "3"))
    shutil.copytree(os.path.join(jax_run, "orbax", "3"), os.path.join(run, "orbax", "3"))
    shutil.copytree(os.path.join(run, "orbax", "4"), os.path.join(run, "orbax", "6"))
    os.remove(os.path.join(run, "orbax", "6", ".metadata"))
    assert ckpt.checkpoint_format(os.path.join(run, "orbax", "3")) == "orbax (JAX)"
    latest = ckpt.latest_checkpoint(run)
    assert latest == os.path.join(run, "orbax", "4") and ckpt.checkpoint_format(latest) == "dcp"
    with pytest.raises(ValueError, match="holds no finished checkpoint"):
        ckpt.checkpoint_step(os.path.join(run, "orbax", "6"))
    res = train_mod.main(_port_run(run, "--checkpoint_backend", "orbax", "--load_params",
                                   epochs=6))
    assert res.state.step == 12  # resumed at epoch 5: one more epoch of 2 steps
    x = sample_mod.main(["--save_dir", run, "--num_samples", "10", "--device", "cpu"])
    assert x.shape == (10, 2) and np.isfinite(x).all()


def test_load_params_on_a_jax_orbax_checkpoint_raises(tmp_path, monkeypatch, capsys):
    """The repair: the newest checkpoint of the directory is a step of the
    JAX package's orbax backend, which the port cannot read. The trainer
    raises, naming it and its format, instead of training from scratch."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "2")
    run = str(tmp_path / "tpu_run")
    js = _jax_state("toy_mlp", "adam")
    path = jax_orbax.save_checkpoint(run, js, 5, async_write=False)
    jax_orbax.wait_for_pending_saves()
    ckpt.save_checkpoint(run, _state(seed=2), 3)  # an older npz beside it
    assert ckpt.latest_checkpoint(run) == path
    assert ckpt.checkpoint_format(path) == "orbax (JAX)"
    with pytest.raises(ValueError, match="orbax \\(JAX\\) format") as err:
        train_mod.main(_port_run(run, "--load_params", epochs=8))
    assert path in str(err.value) and "cannot be read without orbax" in str(err.value)
    assert "training from scratch" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="cannot be read without orbax"):
        with contextlib.redirect_stdout(None):
            sample_mod.main(["--save_dir", run, "--device", "cpu"])
