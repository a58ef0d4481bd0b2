"""The port's microbatched steps (``--grad_accum``; twin of
``tests/test_grad_accum.py:102-308``) are exact: given the same latents,
the accumulated generator and critic gradients equal the port's full-batch
gradients and the JAX package's ``_gen_step_accum``/``_disc_step_accum``
fed the same microbatch draws (the JAX keys' latents, given to the port as
inputs), also against the EMA generator; ``dist`` and ``entropy`` are the
full-batch step's; an indivisible batch raises; a world of 2 gloo ranks
microbatching its local rows equals one rank; and a tiny DenseNet trained
through the CLI with ``--grad_accum 2 --remat`` checkpoints, resumes at the
next epoch and samples. One DCGAN step under ``--remat`` without
microbatches equals the plain step.

Tolerance: port against port, ``_assert_trees_close`` of
``tests/test_grad_accum.py`` (rtol and atol 1e-4: the accumulated sum
reorders float32 additions); port against JAX, rtol 1e-4 and an atol of
1e-5 of each tensor's largest gradient (the two packages' float32 matmuls
round differently, and an element near 0 sums terms of the largest's
size). Metrics: port against port rtol 1e-5, port against JAX 1e-4
absolute (the cross-package band of ``tests/test_torch_engine.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu_torch import sample as sample_mod
from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.convert import state_from_jax, unflatten_params
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.utils.checkpoint import latest_checkpoint
from tests.test_torch_parallel_worker import World


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


def _kw(**kw):
    base = dict(model="toy_mlp", batch_size=32, grad_accum=4, sinkhorn_lambda=50.0,
                nr_sinkhorn_iter=20, num_devices=1, use_pallas=False,
                data_dependent_init=False, compute_dtype="float32")
    base.update(kw)
    return base


def _data(batch, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 2)).astype(np.float32)


def _assert_trees_close(got, want, rtol=1e-4, atol=1e-4, atol_of_max=0.0):
    assert set(got) == set(want)
    for layer in want:
        assert set(got[layer]) == set(want[layer])
        for leaf, w in want[layer].items():
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(got[layer][leaf]), w, rtol=rtol,
                                       atol=max(atol, atol_of_max * float(np.abs(w).max())),
                                       err_msg=f"{layer}.{leaf}")


def _assert_close_to_jax(got, want):
    _assert_trees_close(got, want, atol_of_max=1e-5)


def _spy(eng):
    """The gradients ``eng`` hands its optimizer, captured by name."""
    captured = {}
    update = eng.opt_update

    def spy(params, grads, opt, lr, **kw):
        captured["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        return update(params, grads, opt, lr, **kw)

    eng.opt_update = spy
    return captured


def _jax_accum(kind, ema=False):
    """JAX's accumulated step on the toy: its gradients, metrics, the state
    before the step and the latents its microbatches drew."""
    cfg = JaxConfig(**_kw(train_disc_against_ema=ema))
    eng = JaxEngine(cfg)
    x = jnp.asarray(_data(cfg.batch_size))
    state, _ = eng.init_state(0, x)
    if ema:  # make the EMA differ so a wrong source shows
        state = state._replace(gen_ema=jax.tree_util.tree_map(lambda p: p * 1.5,
                                                              state.gen_params))
    captured = {}
    update = eng.opt_update

    def spy(params, grads, opt, lr, **kw):
        captured["grads"] = grads
        return update(params, grads, opt, lr, **kw)

    eng.opt_update = spy
    host = jax.device_get(state)
    step = eng._disc_step_accum if kind == "disc" else eng._gen_step_accum
    _, met = step(state, x)
    _, noise_key = jax.random.split(host.rng)
    mb = cfg.batch_size // cfg.grad_accum
    z = np.concatenate([np.asarray(jax.random.normal(k, (mb, 256)))
                        for k in jax.random.split(noise_key, cfg.grad_accum)])
    return jax.device_get(captured["grads"]), met, host, z


def _port_grads(host, z, kind, **kw):
    eng = Engine(TrainConfig(**_kw(**kw)), device="cpu")
    state, _ = eng.init_state(0, _data(32))
    state = state_from_jax(eng, state, host)
    captured = _spy(eng)
    step = eng.disc_step if kind == "disc" else eng.gen_step
    _, met = step(state, _data(32), z)
    return unflatten_params(captured["grads"]), met


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_accum_grads_match_full_batch_and_jax(kind):
    want_j, met_j, host, z = _jax_accum(kind)
    got, met = _port_grads(host, z, kind, grad_accum=4)
    full, met_full = _port_grads(host, z, kind, grad_accum=1)
    _assert_trees_close(got, full)
    _assert_close_to_jax(got, want_j)
    # dist and entropy come from one full-batch match of the first pass
    np.testing.assert_allclose(float(met.dist), float(met_full.dist), rtol=1e-5)
    np.testing.assert_allclose(float(met.entropy), float(met_full.entropy), rtol=1e-5)
    assert abs(float(met.dist) - float(met_j.dist)) < 1e-4
    assert abs(float(met.entropy) - float(met_j.entropy)) < 1e-4


def test_disc_accum_against_ema_generator():
    want_j, _, host, z = _jax_accum("disc", ema=True)
    got, _ = _port_grads(host, z, "disc", grad_accum=4, train_disc_against_ema=True)
    _assert_close_to_jax(got, want_j)
    # and not the raw generator's fakes
    raw, _ = _port_grads(host, z, "disc", grad_accum=4)
    assert max(float(np.abs(raw[k][leaf] - got[k][leaf]).max())
               for k in got for leaf in got[k]) > 1e-3


def test_accum_indivisible_batch_raises():
    with pytest.raises(ValueError, match="divisible by"):
        Engine(TrainConfig(**_kw(batch_size=30, grad_accum=4)), device="cpu")


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_densenet_accum_grads_match_full_batch(kind):
    """The image-shaped path: a tiny DenseNet (uint8 batch ingested per
    microbatch, the four noises sliced by rows), under remat too, with and
    without microbatches."""
    x = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    grads = {}
    for accum, remat in ((1, False), (4, False), (2, True), (1, True)):
        cfg = TrainConfig(model="densenet", layers_per_block=1, filters_per_layer=4,
                          batch_size=8, grad_accum=accum, remat=remat,
                          remat_policy="gen_u1,disc_d2", nr_sinkhorn_iter=10,
                          sinkhorn_lambda=50.0, compute_dtype="float32")
        eng = Engine(cfg, device="cpu")
        state, _ = eng.init_state(0, x)
        z = eng.latents(8, torch.Generator().manual_seed(3))
        captured = _spy(eng)
        step = eng.disc_step if kind == "disc" else eng.gen_step
        _, met = step(state, x, z)
        grads[(accum, remat)] = (unflatten_params(captured["grads"]), float(met.dist))
    full, dist = grads.pop((1, False))
    for got, d in grads.values():
        _assert_trees_close(got, full)
        np.testing.assert_allclose(d, dist, rtol=1e-5)


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_dcgan_remat_step_matches_plain(kind):
    """One DCGAN step under ``--remat`` without microbatches, alone and with
    the JAX package's usual policy, equals the plain step: the critic stays
    frozen through the generator step's backward pass, where its segments
    recompute."""
    x = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    z = np.random.default_rng(5).uniform(-1, 1, (4, 100)).astype(np.float32)
    grads = {}
    for remat, policy in ((False, ""), (True, ""), (True, "gen_g1,disc_c4,gen_g2,disc_c3,gen_g3")):
        cfg = TrainConfig(model="dcgan", batch_size=4, remat=remat, remat_policy=policy,
                          nr_sinkhorn_iter=10, sinkhorn_lambda=50.0, compute_dtype="float32")
        eng = Engine(cfg, device="cpu")
        state, _ = eng.init_state(0, x)
        captured = _spy(eng)
        step = eng.disc_step if kind == "disc" else eng.gen_step
        _, met = step(state, x, z)
        grads[policy if remat else None] = (captured["grads"], float(met.dist))
    plain, dist = grads.pop(None)
    for got, d in grads.values():
        assert d == dist
        for name, g in plain.items():
            np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0,
                                       atol=1e-6 * float(g.abs().max()), err_msg=name)


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_two_ranks_with_accum_equal_one_rank(world2, kind):
    """Each of 2 gloo ranks microbatches its 16 local rows in 2; the matcher
    (gathered, global) and the gradient all-reduce are the one-rank step's."""
    x_init, x = _data(32, 1), _data(32, 2)
    z = np.random.default_rng(3).standard_normal((32, 256)).astype(np.float32)
    kw = _kw(grad_accum=2, sharded_matching=False)
    res = world2.run("engine_grads", cfg=dict(kw, num_devices=2), x_init=x_init, x=x, z=z,
                     kind=kind)
    assert res[0]["dist"] == res[1]["dist"]
    for accum in (2, 1):
        eng = Engine(TrainConfig(**dict(kw, grad_accum=accum)), device="cpu")
        state, _ = eng.init_state(0, x_init)
        captured = _spy(eng)
        step = eng.disc_step if kind == "disc" else eng.gen_step
        _, met = step(state, x, z)
        np.testing.assert_allclose(res[0]["dist"], float(met.dist), rtol=1e-5)
        np.testing.assert_allclose(res[0]["entropy"], float(met.entropy), rtol=1e-5)
        _assert_trees_close(unflatten_params(res[0]["grads"]),
                            unflatten_params(captured["grads"]))


def test_densenet_cli_accum_remat_checkpoints_resumes_and_samples(tmp_path, capsys):
    save = str(tmp_path / "run")
    argv = ["--model", "densenet", "--layers_per_block", "1", "--filters_per_layer", "4",
            "--batch_size", "8", "--synthetic_data", "--synthetic_size", "8",
            "--grad_accum", "2", "--remat", "--nr_sinkhorn_iter", "10",
            "--save_every_epochs", "1", "--log_every_steps", "1", "--save_dir", save,
            "--device", "cpu"]
    first = train_mod.main(argv + ["--max_epochs", "2"])
    assert "grad_accum: 2 microbatches of 4" in capsys.readouterr().out
    ckpt = latest_checkpoint(save)
    assert ckpt.endswith("otgan_state-1.npz")
    # the flat layer names of the JAX package's scopes key the checkpoint
    assert {"gen/dense_0.V", "gen/conv2d_0.V", "disc/conv2d_0.V", "gen_ema/conv2d_3.b"} <= set(
        np.load(ckpt).files)
    assert [r["kind"] for r in first.steps] == ["disc", "gen"]
    resumed = train_mod.main(argv + ["--max_epochs", "3", "--load_params"])
    assert "resuming at epoch 2" in capsys.readouterr().out
    assert resumed.state.step == 3 and [r["step"] for r in resumed.steps] == [3]
    assert all(np.isfinite(r["dist"]) for r in first.steps + resumed.steps)
    # a sampling batch that the run's --grad_accum does not divide
    x = sample_mod.main(["--save_dir", save, "--num_samples", "10", "--batch_size", "5",
                         "--device", "cpu"])
    assert x.shape == (10, 32, 32, 3) and np.isfinite(x).all()
    assert (tmp_path / "run" / "samples.png").exists()
