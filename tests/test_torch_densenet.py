"""The port's DenseNet and its list-input, upsampled and dilated convs
against the JAX package: the same converted weights, the same images, and
for the generator the four noises JAX draws inside (``split(key, 4)``,
``uniform(-1, 1)``) given to the port as inputs; float32 compute on both
sides.

Tolerance: 2e-5 relative to the largest value (``tests/test_torch_dcgan.py``:
float32 convs summed in different orders); the data-dependent init 1e-4;
bfloat16 compute within the JAX package's own band, a cosine above 0.999
to the float32 result (``tests/test_models.py:151``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu.models import densenet as jax_densenet
from otgan_tpu.nn.layers import Module, conv2d
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.convert import flatten_params, load_params, state_from_jax, state_to_jax
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.models import densenet, get_model
from otgan_tpu_torch.nn.layers import Conv2d, apply_pre_activation, data_init

SIZES = [(2, 8), (1, 4)]  # (layers_per_block, filters_per_layer); (2, 8): tests/test_models.py:55


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def _images(n=3, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _jax_noise(key, batch, filters):
    """The four noises ``otgan_tpu.models.densenet.gen_spec`` draws."""
    keys = jax.random.split(key, 4)
    shapes = [(batch, 100), (batch, 8, 8, filters), (batch, 16, 16, filters),
              (batch, 32, 32, filters)]
    return tuple(np.array(jax.random.uniform(k, s, minval=-1.0, maxval=1.0))
                 for k, s in zip(keys, shapes))


def _check_init(module, params):
    """The data-dependent init from JAX's V finds JAX's g and b."""
    for name, p in module.named_parameters():
        layer, leaf = name.split(".")
        if leaf in ("g", "b"):
            _close(p.detach().numpy(), params[layer][leaf], rel=1e-4)


@pytest.mark.parametrize("L,F", SIZES)
def test_critic_features_match_jax(L, F):
    x = _images()
    disc_j = jax_densenet.make_discriminator(L, F, compute_dtype="float32")
    params, _ = disc_j.init(jax.random.PRNGKey(1), jnp.asarray(x))
    f_jax = disc_j.apply(params, jnp.asarray(x))
    disc = densenet.make_discriminator(L, F)
    load_params(disc, params)
    f = disc(torch.from_numpy(x)).detach().numpy()
    channels = ((2 * F + L * F) // 2 + L * F) // 2
    channels = (channels + L * F) // 2
    assert f.shape == (3, 16 * 2 * channels)
    _close(f, f_jax)
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)
    data_init(disc, torch.from_numpy(x))
    _check_init(disc, params)


@pytest.mark.parametrize("L,F", SIZES)
def test_generator_images_match_jax(L, F):
    gen_j = jax_densenet.make_generator(L, F, compute_dtype="float32")
    key = jax.random.PRNGKey(2)
    params, _ = gen_j.init(jax.random.PRNGKey(3), key, 3)
    x_jax = gen_j.apply(params, key, 3)
    noise = tuple(torch.from_numpy(u) for u in _jax_noise(key, 3, F))
    gen = densenet.make_generator(L, F)
    load_params(gen, params)
    x = gen(noise).detach().numpy()
    assert x.shape == (3, 32, 32, 3)
    _close(x, x_jax)
    # JAX's init drew the same noises: its init call took the same key
    data_init(gen, noise)
    _check_init(gen, params)


def test_parameter_names_and_shapes_map_one_to_one():
    x = jnp.asarray(_images(2))
    for make_j, make, args in (
            (jax_densenet.make_discriminator, densenet.make_discriminator, (x,)),
            (jax_densenet.make_generator, densenet.make_generator,
             (jax.random.PRNGKey(6), 2))):
        params, _ = make_j(2, 8).init(jax.random.PRNGKey(4), *args, data_dependent=False)
        port = {k: tuple(p.shape) for k, p in make(2, 8).named_parameters()}
        jax_side = {k: tuple(t.shape) for k, t in flatten_params(params).items()}
        assert port == jax_side


def test_train_state_carries_both_ways():
    """``convert.py`` carries a DenseNet ``TrainState`` (params, EMA, Adam
    moments, step) from the JAX package and back, V relaid out, unchanged."""
    kw = dict(model="densenet", layers_per_block=1, filters_per_layer=4, batch_size=4,
              num_devices=1, compute_dtype="float32", data_dependent_init=False)
    x = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    eng_j = JaxEngine(JaxConfig(**kw))
    state_j, nf_j = eng_j.init_state(0, jnp.asarray(x))
    host = jax.device_get(state_j)
    eng = Engine(TrainConfig(**kw), device="cpu")
    state, nf = eng.init_state(0, x)
    assert nf == nf_j
    back = state_to_jax(state_from_jax(eng, state, host))
    for field in ("gen_params", "disc_params", "gen_ema"):
        want = getattr(host, field)
        assert set(back[field]) == set(want)
        for layer, leaves in want.items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(back[field][layer][leaf], np.asarray(w))
    for field in ("gen_opt", "disc_opt"):
        for moment in ("v", "mg"):
            want = getattr(getattr(host, field), moment)
            for layer, leaves in want.items():
                for leaf, w in leaves.items():
                    np.testing.assert_array_equal(back[field][moment][layer][leaf],
                                                  np.asarray(w))
    assert int(back["step"]) == int(host.step)


def test_latents_and_registry():
    z = densenet.sample_latent(5, torch.Generator().manual_seed(0), filters_per_layer=4)
    assert [tuple(t.shape) for t in z] == [(5, 100), (5, 8, 8, 4), (5, 16, 16, 4),
                                           (5, 32, 32, 4)]
    assert all(float(t.min()) >= -1 and float(t.max()) <= 1 for t in z)
    assert get_model("densenet") is densenet


def _conv_pair(pre, upsample=False, dilate=1, filters=6, channels=(3, 5, 4)):
    """A JAX list-input conv and the port's, on the same weights and list."""
    rng = np.random.default_rng(5)
    size = 8 if upsample else 16
    xs = [rng.standard_normal((2, size, size, c)).astype(np.float32) for c in channels]

    def spec(scope, *ins):
        return conv2d(scope, list(ins), filters, pre_activation=pre, upsample=upsample,
                      dilate=dilate)

    module = Module(spec)
    params, _ = module.init(jax.random.PRNGKey(9), *map(jnp.asarray, xs))
    conv = Conv2d(sum(channels), filters, pre_activation=pre, upsample=upsample,
                  dilation=dilate)
    with torch.no_grad():
        for leaf, t in flatten_params(params).items():
            getattr(conv, leaf.split(".")[1]).copy_(t)
    return module, params, conv, xs


@pytest.mark.parametrize("upsample", [False, True], ids=["list", "upsample"])
@pytest.mark.parametrize("pre", ["crelu", "celu", "relu", "elu", None])
def test_list_input_conv_matches_jax(pre, upsample):
    module, params, conv, xs = _conv_pair(pre, upsample)
    want = module.apply(params, *map(jnp.asarray, xs))
    got = conv([torch.from_numpy(x) for x in xs]).detach().numpy()
    assert got.shape == want.shape
    _close(got, want)


def test_dilated_conv_matches_jax():
    module, params, conv, xs = _conv_pair("crelu", dilate=2)
    want = module.apply(params, *map(jnp.asarray, xs))
    _close(conv([torch.from_numpy(x) for x in xs]).detach().numpy(), want)


@pytest.mark.parametrize("pre", ["crelu", "celu", None])
def test_bf16_list_conv_within_jax_band(pre):
    module, params, conv, xs = _conv_pair(pre, upsample=True)
    want = np.asarray(module.apply(params, *map(jnp.asarray, xs)))
    want16 = np.asarray(Module(module._spec, compute_dtype="bfloat16").apply(
        params, *map(jnp.asarray, xs)))
    conv.compute_dtype = torch.bfloat16
    got = conv([torch.from_numpy(x) for x in xs]).detach().numpy()
    assert got.dtype == np.float32
    for ref in (want, want16):
        a, b = got.reshape(2, -1), ref.reshape(2, -1)
        cos = np.sum(a * b, 1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        assert cos.min() > 0.999, cos


@pytest.mark.parametrize("pre", ["crelu", "relu", None])
def test_cast_first_is_the_cast_after(pre):
    """Where the cast commutes with the pre-activation, casting each list
    element first gives the same bf16 conv input, bit for bit."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((2, 4, 4, c)).astype(np.float32))
          for c in (3, 5)]
    first = apply_pre_activation(xs, pre, torch.bfloat16)
    after = apply_pre_activation(xs, pre).to(torch.bfloat16)
    assert first.dtype == torch.bfloat16 and torch.equal(first, after)
