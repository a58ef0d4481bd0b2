"""The port's DCGAN critic and generator at full width against the JAX
package: the same converted weights, the same images and latents, float32
compute on both sides. The critic's features are compared element for
element, so the NHWC flatten order is checked too.

Tolerance: 2e-5 relative to the largest value (four or five float32 5x5
conv layers summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.models import dcgan as jax_dcgan
from otgan_tpu_torch.convert import load_params
from otgan_tpu_torch.models import dcgan, densenet, get_model
from otgan_tpu_torch.nn.layers import data_init


@pytest.fixture(autouse=True)
def _two_threads():
    """Full-width convs: two intra-op threads. The suite runs several pytest
    workers at once, and oversubscribed thread pools made these tests
    several times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)


def test_critic_features_match_jax(images):
    disc_j = jax_dcgan.make_discriminator(compute_dtype="float32")
    params, f_init = disc_j.init(jax.random.PRNGKey(1), jnp.asarray(images))
    f_jax = disc_j.apply(params, jnp.asarray(images))
    disc = dcgan.make_discriminator()
    load_params(disc, params)
    f = disc(torch.from_numpy(images)).detach().numpy()
    assert f.shape == (3, 32768)
    _close(f, f_jax)
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)
    # data-dependent init from JAX's V finds JAX's g and b
    data_init(disc, torch.from_numpy(images))
    for name, p in disc.named_parameters():
        layer, leaf = name.split(".")
        if leaf in ("g", "b"):
            _close(p.detach().numpy(), params[layer][leaf], rel=1e-4)


def test_generator_images_match_jax():
    gen_j = jax_dcgan.make_generator(compute_dtype="float32")
    key = jax.random.PRNGKey(2)
    params, _ = gen_j.init(jax.random.PRNGKey(3), key, 3)
    x_jax = gen_j.apply(params, key, 3)
    # the latent JAX draws inside the module, fed to the port as an input
    z = np.array(jax.random.uniform(key, (3, 100), minval=-1.0, maxval=1.0))
    gen = dcgan.make_generator()
    load_params(gen, params)
    x = gen(torch.from_numpy(z)).detach().numpy()
    assert x.shape == (3, 32, 32, 3)
    _close(x, x_jax)


def test_latents_and_registry():
    z = dcgan.sample_latent(64, torch.Generator().manual_seed(0))
    assert z.shape == (64, 100) and float(z.min()) >= -1 and float(z.max()) <= 1
    assert get_model("dcgan") is dcgan
    assert get_model("toy_mlp").LATENT_DIM == 256
    assert get_model("densenet") is densenet
    with pytest.raises(ValueError):
        get_model("resnet")
