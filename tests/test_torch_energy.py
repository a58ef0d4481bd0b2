"""The research layer of the port against the JAX package:
``ops/energy.py`` (exact: sorting and a subtraction, the sorts stable on
both sides, so tied columns pair alike), ``weight_decay`` (float32 sums,
rtol 1e-6), the toy baselines of ``examples/toy_baselines.py`` (one step of
each objective on converted parameters and given ``z`` and ``x``: losses
within rtol 1e-4 / atol 1e-6 and gradients (sums over the batch) within
1e-5 of each array's largest magnitude (at least 1e-6; the energy's last
bias has a gradient of exactly 0 and rounding): float32 graphs summed in different
orders, and the MED-GAN's matches run different plain Sinkhorns; the parameters after a full step within 2 lr, since
Adam's first step moves a weight by lr times its gradient's sign), and the
plotting helpers (``tile_raster_images`` and the rest exact; the KDE panels
against scipy's ``gaussian_kde``, the one the JAX function calls, exact).
"""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import toy_baselines as jax_tb
from otgan_tpu.nn.optim import adam_init as jax_adam_init
from otgan_tpu.nn.optim import adam_update as jax_adam_update
from otgan_tpu.ops.energy import energy_distance as jax_energy_distance
from otgan_tpu.ops.energy import weight_decay as jax_weight_decay
from otgan_tpu.utils import plotting as jax_plotting
from otgan_tpu_torch.examples import toy_baselines as tb
from otgan_tpu_torch.nn.optim import adam_init
from otgan_tpu_torch.ops.energy import energy_distance, weight_decay
from otgan_tpu_torch.utils import plotting


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ties", [False, True], ids=["untied", "tied"])
def test_energy_distance_matches_jax(ties):
    rng = np.random.default_rng(0)
    if ties:  # few distinct values a column: many tied ranks
        fs = rng.integers(-3, 4, (64, 9)).astype(np.float32)
        fd = rng.integers(-3, 4, (64, 9)).astype(np.float32)
    else:
        fs = rng.standard_normal((64, 9)).astype(np.float32)
        fd = rng.standard_normal((64, 9)).astype(np.float32)
    loss, grads = energy_distance(torch.from_numpy(fs), torch.from_numpy(fd))
    jl, jg = jax_energy_distance(jnp.asarray(fs), jnp.asarray(fd))
    np.testing.assert_array_equal(grads.numpy(), np.asarray(jg))
    assert float(loss) == float(jl)


def test_weight_decay_matches_jax():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "k": rng.standard_normal((2, 1, 3, 2)).astype(np.float32)}
    got = weight_decay({k: torch.from_numpy(v) for k, v in params.items()})
    want = jax_weight_decay({k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(weight_decay({"w": torch.ones(2, 3), "b": torch.ones(4),
                               "k": torch.full((2, 1, 1, 2), 2.0)})) == 22.0


def _mlps(seed):
    g = torch.Generator().manual_seed(seed)
    gp = tb.init_mlp(g, tb.GEN_SIZES, tb.xavier, "cpu")
    dp = tb.init_mlp(g, tb.DISC_SIZES, tb.xavier, "cpu")
    return gp, dp


def _to_jax(ps):
    return [{k: jnp.asarray(t.detach().numpy()) for k, t in p.items()} for p in ps]


@pytest.mark.parametrize("model", tb.MODELS)
def test_one_step_of_each_objective_matches_jax(model):
    rng = np.random.default_rng(2)
    B = 16
    z1, z2 = (rng.standard_normal((B, tb.Z_DIM)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 2)).astype(np.float32) * 2.0
    gp, dp = _mlps(3)
    jgp, jdp = _to_jax(gp), _to_jax(dp)
    g_loss, d_loss, ascent = tb.make_losses(model)
    jg_loss, jd_loss, jascent = jax_tb.make_losses(model)
    assert ascent == jascent
    tz1, tz2, tx = map(torch.from_numpy, (z1, z2, x))
    # the critic's loss and gradient, the generator's loss, aux and gradient
    ld = d_loss(dp, gp, tz1, tx)
    dgrad = torch.autograd.grad(ld, list(tb.flat(dp).values()))
    jld, jdgrad = jax.value_and_grad(lambda p: jd_loss(p, jgp, z1, x))(jdp)
    (lg, aux) = g_loss(gp, dp, tz2, tx)
    ggrad = torch.autograd.grad(lg, list(tb.flat(gp).values()))
    (jlg, jaux), jggrad = jax.value_and_grad(lambda p: jg_loss(p, jdp, z2, x),
                                             has_aux=True)(jgp)
    for got, want in ((ld, jld), (lg, jlg), (aux, jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4, atol=1e-6)
    for got, want in ((dgrad, jdgrad), (ggrad, jggrad)):
        want_flat = [w for layer in want for w in (layer["w"], layer["b"])]
        for g, w in zip(got, want_flat):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=max(1e-5 * np.abs(w).max(), 1e-6))
    # a full step of both scripts
    lr = 2e-5
    tb.train_step((g_loss, d_loss, ascent), gp, dp, adam_init(tb.flat(gp)),
                  adam_init(tb.flat(dp)), tz1, tz2, tx, lr)
    jdg = jax.grad(lambda p: jd_loss(p, jgp, z1, x))(jdp)
    jdp, _ = jax_adam_update(jdp, jdg, jax_adam_init(jdp), -lr if ascent else lr,
                             mom1=0.5, mom2=0.999)
    (_, _), jgg = jax.value_and_grad(lambda p: jg_loss(p, jdp, z2, x), has_aux=True)(jgp)
    jgp, _ = jax_adam_update(jgp, jgg, jax_adam_init(jgp), 5 * lr, mom1=0.5, mom2=0.999)
    for ps, jps, step in ((dp, jdp, lr), (gp, jgp, 5 * lr)):
        for p, jp in zip(ps, jps):
            for k in ("w", "b"):
                np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(jp[k]),
                                           rtol=0, atol=2 * step)


@pytest.mark.parametrize("model", tb.MODELS)
def test_toy_baselines_smoke(tmp_path, model, capsys):
    """Four steps of each objective from the CLI on the CPU: finite; a
    snapshot and the KDE strip at a stride of 2 steps."""
    gp, dp = tb.main(["--model", model, "--steps", "4", "--batch_size", "32",
                      "--save_dir", str(tmp_path), "--device", "cpu"])
    for p in gp + dp:
        assert all(bool(torch.isfinite(t).all()) for t in p.values())
    assert not os.listdir(tmp_path)  # no snapshot before step 500


def _png_size(path):
    with open(path, "rb") as f:
        png = f.read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", png[16:24])
    pos, idat = 8, b""
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            idat += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    assert len(zlib.decompress(idat)) == h * (1 + 3 * w)
    return w, h


def test_kde_evolution_plot_with_a_collapsed_snapshot(tmp_path):
    from scipy.stats import gaussian_kde

    rng = np.random.default_rng(0)
    spread = rng.standard_normal((300, 2))
    snaps = [(500, spread), (1000, rng.standard_normal((300, 2)) + 2.0),
             (1500, np.zeros((300, 2)))]  # collapsed: a singular KDE
    path = str(tmp_path / "kde.png")
    plotting.kde_evolution_plot(snaps, path)
    assert _png_size(path) == (3 * plotting.KDE_GRID + 2, plotting.KDE_GRID)
    axis = np.linspace(-4.0, 4.0, plotting.KDE_GRID)
    gx, gy = np.meshgrid(axis, axis)
    want = gaussian_kde(spread.T)(np.stack([gx.ravel(), gy.ravel()])).reshape(gx.shape)
    np.testing.assert_array_equal(plotting.kde_density(spread), want)
    assert not plotting.kde_density(np.zeros((300, 2))).any()


@pytest.mark.parametrize("pixels", [True, False], ids=["uint8", "float"])
def test_tile_raster_images_matches_jax(pixels):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((7, 12)).astype(np.float32)
    args = ((3, 4), (3, 3), (1, 2), True, pixels)
    np.testing.assert_array_equal(plotting.tile_raster_images(X, *args),
                                  jax_plotting.tile_raster_images(X, *args))
    chans = (X, None, X * 2.0, None)
    np.testing.assert_array_equal(plotting.tile_raster_images(chans, *args),
                                  jax_plotting.tile_raster_images(chans, *args))


def test_filter_tiles_and_unit_scaling_match_jax():
    rng = np.random.default_rng(5)
    for shape in ((4, 3, 5, 5), (4, 2, 3, 3)):
        f = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(plotting.conv_filter_tile(f),
                                      jax_plotting.conv_filter_tile(f))
    a = rng.standard_normal((6, 5))
    np.testing.assert_array_equal(plotting.scale_to_unit_interval(a),
                                  jax_plotting.scale_to_unit_interval(a))


def test_plot_img_names_matplotlib_when_absent(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.plot_img(np.zeros((4, 4)))
