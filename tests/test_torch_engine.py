"""The port's training step as a whole against the JAX engine: full-width
DCGAN at batch 8, float32 compute, lam = 500 with 50 Sinkhorn iterations,
one 5:1 cycle (critic step, then 5 generator steps) from the same converted
state, on the same uint8 batches and the same latents. Also: the CLI on the
CPU, the config surface, and that the port never imports JAX.

Each step of the port starts from the JAX state before that step,
converted anew: at lam = 500 the matching amplifies rounding-level weight
differences, so a free-running comparison drifts (measured: entropy 4e-4
apart after 5 steps) for reasons that are not faults of either package.

Tolerances. dist and entropy: 1e-4 absolute (the matcher's float32 band at
lam = 500, where the two packages' Sinkhorn loops differ by ~1e-5 in P).
Parameters: Adam moves an element by at most ~lr in a step (the first step
moves each by exactly lr * sign(g)), so an element whose gradient sits at
rounding level can differ by up to 2 * lr; most elements must agree far
more tightly: 99% within 1% of that bound (about 0.1% of an output layer's
weights have gradients at rounding level after one step).
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.config import parse_args as jax_parse_args
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu_torch import config as port_config
from otgan_tpu_torch.convert import state_from_jax, state_to_jax, unflatten_params
from otgan_tpu_torch.engine import Engine, resolve_device

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 8


@pytest.fixture(autouse=True)
def _two_threads():
    """Full-width convs: two intra-op threads. The suite runs several pytest
    workers at once, and oversubscribed thread pools made these tests
    several times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(cls, **kw):
    base = dict(model="dcgan", batch_size=B, num_devices=1, compute_dtype="float32",
                nr_sinkhorn_iter=50)
    base.update(kw)
    return cls(**base)


def _param_check(got: dict, want: dict, bound: float, what: str):
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            d = np.abs(got[layer][leaf] - np.asarray(w))
            assert d.max() <= bound + 1e-6, f"{what} {layer}.{leaf}: {d.max()} > {bound}"
            assert np.mean(d <= 0.01 * bound + 1e-7) >= 0.99, f"{what} {layer}.{leaf}"


def test_one_cycle_matches_jax_engine():
    cfg_j = _cfg(JaxConfig)
    eng_j = JaxEngine(cfg_j)
    rng = np.random.default_rng(0)
    x_init = rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    batches = [rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8) for _ in range(6)]
    state_j, nf = eng_j.init_state(0, eng_j.shard(x_init))
    assert nf == 32768

    eng = Engine(_cfg(port_config.TrainConfig), device="cpu")
    state, nf_p = eng.init_state(0, x_init)
    assert nf_p == nf
    bound = 2 * cfg_j.learning_rate_gen
    host_j = jax.device_get(state_j)
    for i, x in enumerate(batches):
        state = state_from_jax(eng, state, host_j)
        z = np.asarray(jax.random.uniform(
            jax.random.split(state_j.rng)[1], (B, 100), minval=-1.0, maxval=1.0
        ))
        kind = "disc" if eng.is_disc_step(state.step) else "gen"
        assert kind == ("disc" if i == 0 else "gen")
        jstep = eng_j.disc_step if kind == "disc" else eng_j.gen_step
        pstep = eng.disc_step if kind == "disc" else eng.gen_step
        state_j, met_j = jstep(state_j, eng_j.shard(x))
        state, met = pstep(state, x, z)
        assert abs(float(met.dist) - float(met_j.dist)) < 1e-4, i
        assert abs(float(met.entropy) - float(met_j.entropy)) < 1e-4, i
        host_j = jax.device_get(state_j)
        name = "disc" if kind == "disc" else "gen"
        got = unflatten_params(dict(getattr(state, name).named_parameters()))
        _param_check(got, getattr(host_j, f"{name}_params"), bound, f"{name} {i}")
        assert state.step == int(host_j.step) == i + 1
    got = state_to_jax(state)
    _param_check(got["gen_ema"], host_j.gen_ema, bound, "ema")
    assert got["gen_opt"]["t"] == float(host_j.gen_opt.t) == 6.0
    assert got["disc_opt"]["t"] == float(host_j.disc_opt.t) == 2.0


def test_cycle_schedule_and_sampling():
    eng = Engine(_cfg(port_config.TrainConfig, batch_size=4, nr_sinkhorn_iter=3,
                      train_disc_against_ema=True, disc_freeze_after_steps=4),
                 device="cpu")
    rng = np.random.default_rng(1)
    state, _ = eng.init_state(3, rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8))
    xs = [rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8) for _ in range(3)]
    ema_before = {k: v.clone() for k, v in state.gen_ema.items()}
    disc_before = state.disc.conv2d_3.V.detach().clone()
    state, mets = eng.cycle(state, xs[:1])  # step 0: critic; EMA untouched
    assert all(torch.equal(ema_before[k], v) for k, v in state.gen_ema.items())
    assert not torch.equal(disc_before, state.disc.conv2d_3.V.detach())
    state, mets = eng.cycle(state, xs[1:])
    assert state.step == 3 and len(mets) == 2
    # step 6 would be a critic step, but the critic froze after step 4
    assert [eng.is_disc_step(s) for s in range(8)] == [True] + [False] * 7
    assert Engine(_cfg(port_config.TrainConfig), device="cpu").is_disc_step(6)
    assert all(np.isfinite(float(m.dist)) and np.isfinite(float(m.entropy)) for m in mets)
    x = eng.sample(state, 5, ema=True)
    assert x.shape == (5, 32, 32, 3) and float(x.abs().max()) <= 1.0


def test_device_is_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(port_config.TrainConfig())
    assert resolve_device("cpu").type == "cpu"


def test_train_cli_on_cpu(tmp_path):
    """``python -m otgan_tpu_torch.train --device cpu --synthetic_data``:
    full-width DCGAN, 2 epochs of one batch of 4."""
    cmd = [
        sys.executable, "-m", "otgan_tpu_torch.train", "--device", "cpu",
        "--synthetic_data", "--synthetic_size", "4", "--batch_size", "4",
        "--max_epochs", "2", "--nr_sinkhorn_iter", "5", "--log_every_steps", "1",
        "--compute_dtype", "float32", "--save_dir", str(tmp_path),
    ]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "step_ms" in r]
    assert [r["kind"] for r in steps] == ["disc", "gen"]
    assert all(np.isfinite(r["dist"]) and np.isfinite(r["entropy"]) for r in steps)
    assert [r["epoch"] for r in recs if "epoch" in r] == [0, 1]
    for cls in (JaxConfig, port_config.TrainConfig):  # the config reads in both
        saved = cls.load(str(tmp_path / "config.json"))
        assert saved.batch_size == 4 and saved.synthetic_size == 4


def test_config_surface_matches_jax():
    assert [f.name for f in dataclasses.fields(port_config.TrainConfig)] == [
        f.name for f in dataclasses.fields(JaxConfig)
    ]
    assert dataclasses.asdict(port_config.TrainConfig()) == dataclasses.asdict(JaxConfig())
    for argv in (["--preset", "train_py"], ["--preset", "model_saving", "--batch_size=64"],
                 ["--nr_gpu", "1", "--no_use_pallas", "--sinkhorn_lambda", "50"]):
        assert dataclasses.asdict(port_config.parse_args(argv)) == dataclasses.asdict(
            jax_parse_args(argv)
        )


@pytest.mark.parametrize(
    "kw",
    [dict(matching_precision="default"), dict(matching_precision="high")],
)
def test_later_slices_raise(kw):
    """The last options a later slice ported now pass; an unknown
    precision is rejected with the JAX package's ValueError."""
    port_config.check_supported(port_config.TrainConfig(**kw))
    with pytest.raises(ValueError, match="matching precision must be one of"):
        port_config.check_supported(port_config.TrainConfig(matching_precision="bogus"))


@pytest.mark.parametrize(
    "kw",
    [dict(model="densenet"), dict(profile_dir="/tmp/trace"), dict(remat=True),
     dict(grad_accum=2), dict(debug_nans=True), dict(eval_fid=True), dict(multihost=True),
     dict(checkpoint_backend="orbax")],
)
def test_ported_options_pass_check_supported(kw):
    port_config.check_supported(port_config.TrainConfig(**kw))
    assert port_config.TrainConfig(**kw).model_opts() == JaxConfig(**kw).model_opts()


def test_port_never_imports_jax():
    files = sorted((REPO / "otgan_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "measure_local_step.py", REPO / "measure_resident.py",
        REPO / "measure_densenet.py", REPO / "measure_eval.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "otgan_tpu"), f"{path}: {name}"
