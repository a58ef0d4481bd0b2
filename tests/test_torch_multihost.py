"""Training over several hosts on the port (the twin of
``tests/test_multihost.py``): the port's trainer as two OS processes, each
its own "host", joined by the manual launch flags (``--multihost
--coordinator_address --num_processes --process_id``, no torchrun) over
gloo on the CPU.

The toy at the JAX test's size: each process says ``process p/2 (local
batch 64)``, the npz backend switches to the sharded one, only process 0
writes metrics and samples, ``orbax/1`` is committed, and both resume at
epoch 2 with ``--grad_accum 2``. Then the slice as a whole: a two-process
``--multihost`` DCGAN run (global batch 8, 2 steps, float32 model
compute, the momentum optimizer) logs per-step ``dist`` and ``entropy`` within 1e-5 of one process of the port's engine fed the
concatenation of the two processes' batches from the same init (the port's
one-process engine is held against the JAX package in
``tests/test_torch_engine.py``, its shards against the JAX loader in
``tests/test_torch_data_shards.py``). Also 2 torchrun-style nodes of 2
ranks each against one process, and the launch watchdog.
"""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading

import numpy as np
import torch

from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.utils import checkpoint_orbax
from otgan_tpu_torch.utils.init_watchdog import arm
from tests.test_torch_parallel_worker import World

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(args, toy_batches=None) -> list:
    """Run the port's trainer as processes 0 and 1 of a manual launch;
    returns their outputs after both exit 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    if toy_batches:
        env["OTGAN_TOY_EPOCH_BATCHES"] = str(toy_batches)
    flags = ["--device", "cpu", "--multihost", "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-m", "otgan_tpu_torch.train", *args, *flags,
                               "--process_id", str(i)], env=env, cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def _records(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_process_toy_train(tmp_path):
    save_dir = str(tmp_path / "run")
    toy = ["--model", "toy_mlp", "--batch_size", "128", "--sinkhorn_lambda", "50.0",
           "--nr_sinkhorn_iter", "5", "--save_every_epochs", "2", "--save_dir", save_dir]
    outs = _two_processes(toy + ["--max_epochs", "2"], toy_batches=6)
    assert "process 0/2 (local batch 64)" in outs[0]
    assert "process 1/2 (local batch 64)" in outs[1]
    assert "switching checkpoint_backend npz -> orbax" in outs[0]
    epochs = [r for r in _records(save_dir) if "epoch" in r]
    assert len(epochs) == 2 and np.isfinite(epochs[-1]["dist_gen"])
    # only the chief logs: process 0 echoes metric lines, process 1 is silent
    d0 = re.findall(r"dist_gen=([0-9.]+)", outs[0])
    assert d0 and all(np.isfinite(float(d)) for d in d0)
    assert not re.findall(r"dist_gen=", outs[1])
    assert checkpoint_orbax.is_committed(os.path.join(save_dir, "orbax", "1"))
    assert os.path.exists(os.path.join(save_dir, "sample0.npy"))

    # resume on both processes into microbatched steps
    outs = _two_processes(toy + ["--max_epochs", "3", "--load_params", "--grad_accum", "2"],
                          toy_batches=6)
    for out in outs:
        assert "resuming at epoch 2" in out and "(dcp checkpoint format)" in out
    assert "grad_accum: 2 microbatches of 64" in outs[0]
    epochs = [r for r in _records(save_dir) if "epoch" in r]
    assert len(epochs) == 3 and np.isfinite(epochs[-1]["dist_gen"])


def test_two_process_dcgan_matches_one_process_on_the_global_batch(tmp_path):
    """Per-step dist and entropy of the two-process run within 1e-5 of one
    process of the engine fed the concatenated batches, from the same
    init (the processes' init batches, concatenated)."""
    save_dir = str(tmp_path / "run")
    # float32 model compute and a momentum optimizer: in bfloat16 each
    # rank's gradient is rounded before the sum over the ranks, and Adam's
    # first step moves a weight by lr times the sign of its gradient, so a
    # gradient near 0 whose sign the sum's rounding flips moves 2 lr apart
    # (measured on this test: 2.4e-5 in dist and 5.3e-5 in entropy after one
    # Adam step, against 6e-8 and 1.3e-6 with the momentum optimizer)
    flags = dict(batch_size=8, synthetic_data=True, synthetic_size=16, nr_sinkhorn_iter=20,
                 max_epochs=1, save_every_epochs=100, log_every_steps=1, seed=3,
                 compute_dtype="float32", optimizer="nesterov")
    args = [f"--{k}" if v is True else f"--{k}={v}" for k, v in flags.items()]
    _two_processes(args + ["--save_dir", save_dir])
    got = [r for r in _records(save_dir) if "kind" in r]
    assert [r["kind"] for r in got] == ["disc", "gen"]

    torch.set_num_threads(2)
    cfg = TrainConfig(**flags, save_dir=str(tmp_path / "one"))
    engine = Engine(cfg, device="cpu")
    loaders = [train_mod.make_loader(cfg, np.random.default_rng((cfg.seed, p)), p, 2)
               for p in (0, 1)]
    state, _ = engine.init_state(cfg.seed, np.concatenate([l.init_batch() for l in loaders]))
    want = []
    for xs in zip(*(l.epoch() for l in loaders)):
        step = engine.disc_step if engine.is_disc_step(state.step) else engine.gen_step
        state, met = step(state, np.concatenate(xs))
        want.append((float(met.dist), float(met.entropy)))
    assert len(want) == len(got) == 2
    for r, (d, e) in zip(got, want):
        assert abs(r["dist"] - d) <= 1e-5 and abs(r["entropy"] - e) <= 1e-5, (r, d, e)


def test_nodes_of_two_ranks_match_one_process():
    """Under torchrun a process is a node: 2 nodes of 2 ranks, each node
    handed its half of every batch and each rank keeping its rows of it,
    give the steps of one process on the whole batch (dist and entropy
    within 1e-5; the toy, float32, the momentum optimizer as above)."""
    cfg = dict(model="toy_mlp", batch_size=16, sinkhorn_lambda=50.0, nr_sinkhorn_iter=10,
               nr_gen_per_disc=1, compute_dtype="float32", optimizer="nesterov")
    rng = np.random.default_rng(0)
    x_init = rng.normal(size=(16, 2)).astype(np.float32)
    xs = [rng.normal(size=(16, 2)).astype(np.float32) for _ in range(3)]
    world = World(4)
    try:
        got = world.run("multihost_engine_steps", cfg=cfg, x_init=x_init, xs=xs,
                        ranks_per_process=2)
    finally:
        world.close()
    engine = Engine(TrainConfig(**cfg), device="cpu")
    state, _ = engine.init_state(0, x_init)
    want = []
    for x in xs:
        step = engine.disc_step if engine.is_disc_step(state.step) else engine.gen_step
        state, met = step(state, x)
        want.append((float(met.dist), float(met.entropy)))
    for rank_steps in got:
        assert np.allclose(rank_steps, want, rtol=0, atol=1e-5), (rank_steps, want)


def test_init_watchdog_fires_and_disarms():
    fired = threading.Event()
    arm(0.05, on_timeout=fired.set)
    assert fired.wait(10)
    quiet = threading.Event()
    arm(0.2, on_timeout=quiet.set).disarm()
    assert not quiet.wait(0.5)
    assert not threading.Event().is_set() and arm(0).disarm() is None  # 0: off
