"""The port's toy MED-GAN (8 Gaussians) against the JAX package: the data,
both MLPs with converted parameters, one critic and one generator step of
the engine, the He-scale init, the per-family transport cost in every
matcher build, and the CLI on the CPU. The same numpy inputs go to both
packages; the generator's latent is the one JAX draws from its step key.

Tolerances. Forwards in float32: 1e-5 relative to the largest value (four
dense layers summed in different orders). In bfloat16 both packages round
inputs, weights and each layer's output to bfloat16 at the same places (and
agreed bit for bit here), but may sum in different orders: one bfloat16 ulp
of the largest value, 2^-8. Steps: as tests/test_torch_engine.py
(dist and entropy 1e-4; parameters within 2 lr, 99% within 1% of that).
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.data import toy as jax_toy
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu.models import toy_mlp as jax_toy_mlp
from otgan_tpu_torch import config as port_config
from otgan_tpu_torch.convert import load_params, state_from_jax, unflatten_params
from otgan_tpu_torch.data import toy
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.models import get_model, toy_mlp
from otgan_tpu_torch.nn.layers import Dense, data_init, reset_parameters
from otgan_tpu_torch.ops.costs import cosine_cost, scaled_sqeuclidean_cost
from tests import reference_impl as ref

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 64


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made such tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def test_toy_data_matches_jax():
    np.testing.assert_array_equal(toy.GAUSSIAN_CENTERS, jax_toy.GAUSSIAN_CENTERS)
    x = toy.sample_8gaussians(np.random.default_rng(3), 2000)
    np.testing.assert_array_equal(x, jax_toy.sample_8gaussians(np.random.default_rng(3), 2000))
    assert x.dtype == np.float32 and x.shape == (2000, 2)
    assert toy.mode_coverage(x) == jax_toy.mode_coverage(x) == 8
    assert toy.mode_coverage(np.zeros((100, 2), np.float32)) == 0


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2.0**-8)])
def test_forwards_match_jax(dtype, rel):
    pts = toy.sample_8gaussians(np.random.default_rng(0), B)
    disc_j = jax_toy_mlp.make_discriminator(compute_dtype=dtype)
    d_params, _ = disc_j.init(jax.random.PRNGKey(1), jnp.asarray(pts), data_dependent=False)
    gen_j = jax_toy_mlp.make_generator(compute_dtype=dtype)
    key = jax.random.PRNGKey(2)
    g_params, _ = gen_j.init(jax.random.PRNGKey(3), key, B, data_dependent=False)
    cd = getattr(torch, dtype)
    disc, gen = toy_mlp.make_discriminator(compute_dtype=cd), toy_mlp.make_generator(compute_dtype=cd)
    load_params(disc, d_params)
    load_params(gen, g_params)
    with torch.no_grad():
        f = disc(torch.from_numpy(pts))
        z = np.array(jax.random.normal(key, (B, toy_mlp.LATENT_DIM)))  # the JAX draw
        x = gen(torch.from_numpy(z))
    assert f.shape == (B, toy_mlp.FEATURE_DIM) and x.shape == (B, 2)
    assert f.dtype == x.dtype == torch.float32
    _close(f.numpy(), disc_j.apply(d_params, jnp.asarray(pts)), rel)
    _close(x.numpy(), gen_j.apply(g_params, key, B), rel)


def test_he_init_statistics_and_layout():
    """Plain dense layers: V and b only, V at He scale sqrt(2 / fan_in) in
    both packages, b zero; the JAX parameter names map one to one."""
    gen_j = jax_toy_mlp.make_generator()
    g_params, _ = gen_j.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), 4, data_dependent=False)
    gen = toy_mlp.make_generator()
    reset_parameters(gen, torch.Generator().manual_seed(0))
    names = dict(gen.named_parameters())
    assert sorted(names) == sorted(f"{k}.{leaf}" for k, v in g_params.items() for leaf in v)
    assert not any(k.endswith(".g") for k in names)
    for layer, leaves in g_params.items():
        v_port = names[f"{layer}.V"].detach().numpy()
        fan_in = v_port.shape[1]
        assert np.asarray(leaves["V"]).shape == v_port.shape[::-1]
        if v_port.size >= 1000:  # std estimates within 5%
            for v in (v_port, np.asarray(leaves["V"])):
                assert abs(v.std() / np.sqrt(2.0 / fan_in) - 1) < 0.05, layer
        assert float(names[f"{layer}.b"].detach().abs().max()) == 0.0


def test_plain_dense_data_init_folds_scale_into_v():
    """The data-init branch of a plain dense layer (``weight_norm=False``):
    the scale is folded into V, so after it the outputs have unit std and
    zero mean per unit, and JAX's data-dependent init from JAX's V is a fixed
    point of the port's."""
    from otgan_tpu.nn import layers as jl

    x = np.random.default_rng(4).standard_normal((32, 12)).astype(np.float32)
    mod = jl.Module(lambda s, x: jl.dense(s, x, 10, pre_activation="relu", weight_norm=False,
                                          use_g=False))
    params, out_init = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), data_dependent=True)
    layer = Dense(12, 10, pre_activation="relu", weight_norm=False)
    reset_parameters(layer, torch.Generator().manual_seed(1))
    out = data_init(layer, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out.std(0), 1.0, atol=1e-4)
    np.testing.assert_allclose(out.mean(0), 0.0, atol=1e-5)
    holder = torch.nn.ModuleDict({"dense_0": layer})
    load_params(holder, params)
    out = data_init(layer, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(out_init), atol=1e-5)
    np.testing.assert_allclose(layer.V.detach().numpy().T, np.asarray(params["dense_0"]["V"]),
                               rtol=1e-5, atol=1e-6)


def _cfg(cls, **kw):
    base = dict(model="toy_mlp", batch_size=B, num_devices=1, compute_dtype="float32",
                sinkhorn_lambda=50.0, nr_sinkhorn_iter=10, learning_rate_gen=3e-4,
                learning_rate_disc=6e-5, nr_gen_per_disc=1)
    base.update(kw)
    return cls(**base)


def _param_check(got: dict, want: dict, bound: float, what: str):
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            d = np.abs(got[layer][leaf] - np.asarray(w))
            assert d.max() <= bound + 1e-6, f"{what} {layer}.{leaf}: {d.max()} > {bound}"
            assert np.mean(d <= 0.01 * bound + 1e-7) >= 0.99, f"{what} {layer}.{leaf}"


def test_critic_and_generator_steps_match_jax_engine():
    """A critic step, then a generator step (1:1 schedule), each from the
    JAX state before it, on the same points and the latents JAX draws."""
    eng_j = JaxEngine(_cfg(JaxConfig))
    rng = np.random.default_rng(5)
    x_init = toy.sample_8gaussians(rng, B)
    batches = [toy.sample_8gaussians(rng, B) for _ in range(2)]
    state_j, nf = eng_j.init_state(0, eng_j.shard(x_init))
    eng = Engine(_cfg(port_config.TrainConfig), device="cpu")
    state, nf_p = eng.init_state(0, x_init)
    assert nf == nf_p == toy_mlp.FEATURE_DIM
    for i, x in enumerate(batches):
        state = state_from_jax(eng, state, jax.device_get(state_j))
        z = np.asarray(jax.random.normal(jax.random.split(state_j.rng)[1],
                                         (B, toy_mlp.LATENT_DIM)))
        kind = "disc" if eng.is_disc_step(state.step) else "gen"
        assert kind == ("disc", "gen")[i]
        jstep = eng_j.disc_step if kind == "disc" else eng_j.gen_step
        pstep = eng.disc_step if kind == "disc" else eng.gen_step
        state_j, met_j = jstep(state_j, eng_j.shard(x))
        state, met = pstep(state, x, z)
        assert abs(float(met.dist) - float(met_j.dist)) < 1e-4, kind
        assert abs(float(met.entropy) - float(met_j.entropy)) < 1e-4, kind
        host_j = jax.device_get(state_j)
        lr = eng.cfg.learning_rate_disc if kind == "disc" else eng.cfg.learning_rate_gen
        got = unflatten_params(dict(getattr(state, kind).named_parameters()))
        _param_check(got, getattr(host_j, f"{kind}_params"), 2 * lr, f"{kind} step")
        assert state.step == int(host_j.step) == i + 1


def test_config_accepts_toy_and_resume():
    for kw in (dict(model="toy_mlp"), dict(load_params=True, model_name="/x/otgan_state-3.npz")):
        port_config.check_supported(port_config.TrainConfig(**kw))
    assert get_model("toy_mlp") is toy_mlp
    for cls in (port_config.TrainConfig, JaxConfig):
        opts = cls(model="toy_mlp").model_opts()
        assert opts["nonlinearity"] == "relu" and opts["compute_dtype"] == "bfloat16"
        assert cls(model="toy_mlp", nonlinearity="elu").model_opts()["nonlinearity"] == "elu"
    assert port_config.TrainConfig().model_opts()["nonlinearity"] == "crelu"
    # the toy runs in the configured compute dtype, bf16 by default
    eng = Engine(port_config.TrainConfig(model="toy_mlp", batch_size=8), device="cpu")
    state, _ = eng.init_state(0, toy.sample_8gaussians(np.random.default_rng(0), 8))
    assert {layer.compute_dtype for layer in state.gen.children()} == {torch.bfloat16}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_toy_cost_in_every_matcher_build():
    """Each matcher the engine builds matches with the toy's scaled
    squared-Euclidean cost (the float64 reference with that cost), not the
    cosine cost: the single-device build, and in a one-rank gloo group the
    gathered global matcher, the row-sharded and the matrix-parallel ones."""
    rng = np.random.default_rng(6)
    fa, fb = (rng.standard_normal((16, 16)).astype(np.float32) for _ in range(2))
    want = ref.match_two_batch_np(fa, fb, 50.0, 10, cost_fn=ref.toy_cost_np)
    cosine = ref.match_two_batch_np(fa, fb, 50.0, 10)
    assert np.abs(np.asarray(cosine[2]) - want[2]).max() > 1e-2

    def check(matcher, what):
        got = matcher(torch.from_numpy(fa), torch.from_numpy(fb))
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=what)
        assert abs(float(got.entropy) - want[4]) < 1e-4, what

    cfg = _cfg(port_config.TrainConfig, batch_size=16)
    eng = Engine(cfg, device="cpu")
    assert eng.cost_fn is scaled_sqeuclidean_cost
    assert Engine(dataclasses.replace(cfg, model="dcgan"), device="cpu").cost_fn is cosine_cost
    check(eng._matcher, "single device")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        for kw in (dict(sharded_matching=False), dict(matching_layout="rows"),
                   dict(matching_layout="matrices")):
            eng = Engine(dataclasses.replace(cfg, **kw), device="cpu")
            check(eng._make_parallel_matcher(), f"{kw}: {eng.matcher_desc}")
    finally:
        dist.destroy_process_group()


def test_toy_cli_one_epoch_on_cpu(tmp_path):
    """``python -m otgan_tpu_torch.train --device cpu --model toy_mlp``:
    one epoch of 2 batches of 64 writes ``sample0.npy`` (100 finite points)
    and its EMA twin, and runs the resident tier's plain version only."""
    cmd = [sys.executable, "-m", "otgan_tpu_torch.train", "--device", "cpu", "--model",
           "toy_mlp", "--batch_size", "64", "--sinkhorn_lambda", "50", "--nr_sinkhorn_iter",
           "10", "--nr_gen_per_disc", "1", "--max_epochs", "1", "--log_every_steps", "1",
           "--save_dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OTGAN_TOY_EPOCH_BATCHES="2")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    for name in ("sample0.npy", "ema_sample0.npy"):
        x = np.load(tmp_path / name)
        assert x.shape == (100, 2) and np.isfinite(x).all()
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs if "step_ms" in r] == ["disc", "gen"]
    launches = [r["launches"] for r in recs if "epoch" in r][-1]
    assert launches["resident_plain"] == 2 and launches["resident"] == 0
    assert launches["col_potential"] == launches["col_potential_plain"] == 0
    assert "model has a hidden representation with 16 features" in out.stdout
