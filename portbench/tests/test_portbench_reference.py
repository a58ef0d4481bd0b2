"""The plain reference against the port at a tiny size on the CPU. The
reference imports nothing of the port; the test imports both."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from otgan_tpu_torch.models import dcgan as port_dcgan
from otgan_tpu_torch.nn.layers import data_init, reset_parameters
from otgan_tpu_torch.ops.matching import match_two_batch
from portbench.reference import dcgan, train

SEED = 7


def port_models(seed, x_init, compute):
    rng = torch.Generator().manual_seed(seed)
    gen = port_dcgan.make_generator(compute_dtype=compute)
    disc = port_dcgan.make_discriminator(compute_dtype=compute)
    reset_parameters(disc, rng)
    reset_parameters(gen, rng)
    data_init(disc, (x_init.float() / 127.5 - 1.0).to(compute))
    data_init(gen, port_dcgan.sample_latent(x_init.shape[0], rng))
    return gen, disc


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
def test_models_and_init_equal_the_port(compute):
    torch.set_num_threads(2)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), np.uint8))
    gen, disc = port_models(SEED, x, compute)
    d, g, rng = dcgan.draw(SEED)
    dcgan.critic(d, dcgan.images(x, compute), compute, init=True)
    z0 = torch.rand((4, dcgan.LATENT), generator=rng) * 2.0 - 1.0
    dcgan.generator(g, z0, compute, init=True)
    for mine, port in ((d, disc), (g, gen)):
        assert list(mine) == [k for k, _ in port.named_parameters()]
        for k, p in port.named_parameters():
            torch.testing.assert_close(mine[k], p.detach(), rtol=0, atol=0, msg=k)
    z = torch.rand((4, dcgan.LATENT), generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        torch.testing.assert_close(dcgan.generator(g, z, compute), gen(z), rtol=0, atol=0)
        torch.testing.assert_close(dcgan.critic(d, dcgan.images(x, compute), compute),
                                   disc((x.float() / 127.5 - 1.0).to(compute)), rtol=0, atol=0)


def test_bf16_models_agree_with_float32_within_rounding():
    """The reference's models at the configuration's bf16 (each conv and
    dense layer's input and weight rounded to bf16, the product summed in
    float32 and returned in bf16) against the same models in float32, from
    one init at a tiny batch: the critic's features and the generator's
    images differ, and by no more than the roundings allow: three of at
    most 2^-9 each (input, weight, result) in each of the critic's four
    layers and the generator's five, carried through (a norm-wise bound,
    so the sum of the layers')."""
    torch.set_num_threads(2)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 32, 32, 3), np.uint8))
    d, g, rng = dcgan.draw(SEED)
    dcgan.critic(d, dcgan.images(x, torch.float32), torch.float32, init=True)
    z = torch.rand((4, dcgan.LATENT), generator=rng) * 2.0 - 1.0
    dcgan.generator(g, z, torch.float32, init=True)
    unit = 2.0 ** -9  # bf16's unit roundoff
    with torch.no_grad():
        for net, layers, out in (
                ("critic", len(dcgan.DISC),
                 lambda c: dcgan.critic(d, dcgan.images(x, c), c)),
                ("generator", len(dcgan.GEN), lambda c: dcgan.generator(g, z, c))):
            f32, bf16 = out(torch.float32), out(torch.bfloat16)
            gap = float(torch.linalg.vector_norm(bf16 - f32) / torch.linalg.vector_norm(f32))
            assert 0.0 < gap <= 3 * layers * unit, (net, gap)


@pytest.mark.parametrize("ranks", [1, 2])
def test_match_equals_the_port(ranks):
    """The two-batch match, and on 2 ranks the halves each rank takes of its
    own rows: the port's row-sharded convention is the global matcher on
    rows in that order."""
    gen = torch.Generator().manual_seed(3)
    fa = torch.nn.functional.normalize(torch.rand((8, 64), generator=gen), dim=1)
    fb = torch.nn.functional.normalize(torch.rand((8, 64), generator=gen), dim=1)
    order = train.halves_order(8, ranks)
    if order is not None:
        assert order.tolist() == [0, 1, 4, 5, 2, 3, 6, 7]
        fa, fb = fa[order], fb[order]
    mine = train.match(fa, fb, 5.0, 50)
    port = match_two_batch(fa, fb, lam=5.0, n_iters=50)
    for a, b in zip(mine, port):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
