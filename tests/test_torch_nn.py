"""The port's layers, optimizers and EMA against the JAX package on the same
numpy inputs and the same weights (carried over by ``convert.py``).

Tolerances: float32 layer outputs and init statistics within 1e-5 (absolute
and relative; conv algorithms sum in different orders); optimizer steps
within 1e-6 relative of each other, as both compute the same float32
expressions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from otgan_tpu.nn import layers as jl
from otgan_tpu.nn import optim as jopt
from otgan_tpu.nn.ema import ema_init as jax_ema_init
from otgan_tpu.nn.ema import ema_update as jax_ema_update
from otgan_tpu_torch.convert import flatten_params, load_params
from otgan_tpu_torch.nn import ema, layers, optim

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made these tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_layer(spec, x, seed=0):
    mod = jl.Module(spec)
    params, out_init = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return params, np.asarray(out_init), np.asarray(mod.apply(params, jnp.asarray(x)))


def _check_layer(name, layer, params, out_init, out_apply, x):
    """Same V: the port's data-dependent init must find JAX's g and b, and
    both forwards must agree."""
    holder = nn.ModuleDict({name: layer})
    load_params(holder, params)
    g_jax = layer.g.detach().clone()
    b_jax = layer.b.detach().clone()
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(), out_apply, **TOL)
    with torch.no_grad():
        layer.g.fill_(1.0)
        layer.b.fill_(0.0)
    init_out = layers.data_init(layer, torch.from_numpy(x))
    torch.testing.assert_close(layer.g.detach(), g_jax, **TOL)
    torch.testing.assert_close(layer.b.detach(), b_jax, **TOL)
    np.testing.assert_allclose(init_out.numpy(), out_init, **TOL)


@pytest.mark.parametrize("pre", [None, "crelu", "celu", "elu", "relu"])
def test_dense_weight_norm_and_init(pre):
    x = _x(1, (16, 12))
    params, out_init, out = _jax_layer(
        lambda s, x: jl.dense(s, x, 10, pre_activation=pre, init_scale=0.7), x
    )
    layer = layers.Dense(12, 10, pre_activation=pre, init_scale=0.7)
    _check_layer("dense_0", layer, params, out_init, out, x)


@pytest.mark.parametrize(
    "stride,upsample,pre,size",
    [((1, 1), False, None, 8), ((2, 2), False, "crelu", 32), ((2, 2), False, "crelu", 7),
     ((1, 1), True, None, 4), ((1, 2), False, "celu", 9)],
    ids=["s1", "s2_same_32to16", "s2_odd", "upsample", "mixed_stride"],
)
def test_conv_weight_norm_and_init(stride, upsample, pre, size):
    """5x5 convs with XLA's SAME padding, stride-2 (pads (1, 2) on 32) and
    NN-upsample included."""
    x = _x(2, (3, size, size, 6))
    params, out_init, out = _jax_layer(
        lambda s, x: jl.conv2d(s, x, 8, filter_size=(5, 5), stride=stride,
                               upsample=upsample, pre_activation=pre),
        x,
    )
    layer = layers.Conv2d(6, 8, (5, 5), stride, upsample=upsample, pre_activation=pre)
    _check_layer("conv2d_0", layer, params, out_init, out, x)


def test_same_padding_matches_xla():
    assert layers.same_padding(32, 5, 2) == (1, 2)
    assert layers.same_padding(32, 5, 1) == (2, 2)
    assert layers.same_padding(7, 5, 2) == (2, 2)
    assert layers.same_padding(16, 5, 2) == (1, 2)


def test_activation_helpers_match_jax():
    x = _x(3, (2, 4, 4, 6))
    for pre in (None, "crelu", "celu", "elu", "relu"):
        np.testing.assert_allclose(
            layers.apply_pre_activation(torch.from_numpy(x), pre).numpy(),
            np.asarray(jl.apply_pre_activation(jnp.asarray(x), pre)), atol=1e-6,
        )
    np.testing.assert_allclose(
        layers.glu(torch.from_numpy(x)).numpy(), np.asarray(jl.glu(jnp.asarray(x))), atol=1e-6
    )
    np.testing.assert_allclose(
        layers.glu(torch.from_numpy(x), dim=1).numpy(),
        np.asarray(jl.glu(jnp.asarray(x), axis=1)), atol=1e-6,
    )
    np.testing.assert_array_equal(
        layers.nn_upsample(torch.from_numpy(x)).numpy(), np.asarray(jl.nn_upsample(jnp.asarray(x)))
    )
    f = x.reshape(2, -1)
    np.testing.assert_allclose(
        layers.l2_normalize_rows(torch.from_numpy(f)).numpy(),
        np.asarray(jl.l2_normalize_rows(jnp.asarray(f))), atol=1e-6,
    )
    with pytest.raises(ValueError):
        layers.apply_pre_activation(torch.from_numpy(x), "gelu")


def test_bf16_compute_casts_then_upcasts():
    x = _x(4, (2, 8, 8, 4))
    layer = layers.Conv2d(4, 8, (5, 5), (2, 2), pre_activation="crelu",
                          compute_dtype=torch.bfloat16)
    layers.reset_parameters(layer, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
        assert out.dtype == torch.float32 and out.shape == (2, 4, 4, 8)
        layer.compute_dtype = torch.float32
        ref = layer(torch.from_numpy(x))
    assert float((out - ref).abs().max()) < 0.05 * float(ref.abs().max())


def _jax_steps(update, init, p0, gs, lr, **kw):
    params = {"w": jnp.asarray(p0)}
    state = init(params)
    for g in gs:
        params, state = update(params, {"w": jnp.asarray(g)}, state, lr, **kw)
    return np.asarray(params["w"]), state


def _port_steps(update, init, p0, gs, lr, **kw):
    params = {"w": torch.from_numpy(p0.copy())}
    state = init(params)
    for g in gs:
        state = update(params, {"w": torch.from_numpy(g)}, state, lr, **kw)
    return params["w"].numpy(), state


@pytest.mark.parametrize(
    "name,lr,kw",
    [("adam", 3e-4, dict(mom1=0.5, mom2=0.999)), ("adam", -3e-4, dict(mom1=0.5, mom2=0.999)),
     ("adamax", 1e-3, dict(mom1=0.5, mom2=0.999)), ("adamax", -1e-3, dict(mom1=0.0)),
     ("nesterov", 1e-2, dict(mom1=0.9)), ("nesterov", -1e-2, dict(mom1=0.9))],
)
def test_optimizers_match_jax(name, lr, kw):
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    gs = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(7)]
    want, jstate = _jax_steps(*reversed(jopt.make_optimizer(name)), p0, gs, lr, **kw)
    got, pstate = _port_steps(*reversed(optim.make_optimizer(name)), p0, gs, lr, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert pstate.t == float(jstate.t) == 8.0


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        optim.make_optimizer("sgd")


def test_ema_matches_jax():
    rng = np.random.default_rng(6)
    p0 = {"w": rng.standard_normal(5).astype(np.float32)}
    ps = [{"w": rng.standard_normal(5).astype(np.float32)} for _ in range(4)]
    je = jax_ema_init({"w": jnp.asarray(p0["w"])})
    pe = ema.ema_init({"w": torch.from_numpy(p0["w"])})
    assert pe["w"].data_ptr() != torch.from_numpy(p0["w"]).data_ptr()
    for p in ps:
        je = jax_ema_update(je, {"w": jnp.asarray(p["w"])}, 0.9)
        ema.ema_update(pe, {"w": torch.from_numpy(p["w"])}, 0.9)
    np.testing.assert_allclose(pe["w"].numpy(), np.asarray(je["w"]), rtol=1e-6)


def test_convert_layouts_round_trip():
    params = {"conv2d_0": {"V": _x(7, (5, 5, 3, 4)), "g": _x(8, (4,)), "b": _x(9, (4,))},
              "dense_0": {"V": _x(10, (6, 2)), "g": _x(11, (2,)), "b": _x(12, (2,))}}
    flat = flatten_params(params)
    assert flat["conv2d_0.V"].shape == (4, 3, 5, 5)
    assert flat["dense_0.V"].shape == (2, 6)
    from otgan_tpu_torch.convert import unflatten_params

    back = unflatten_params(flat)
    for layer, leaves in params.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], v)
