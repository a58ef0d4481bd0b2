"""The port's DCGAN critic and generator at full width against the JAX
package: the same converted weights, the same images and latents, float32
compute on both sides. The critic's features are compared element for
element, so the NHWC flatten order is checked too.

Tolerance: 2e-5 relative to the largest value (four or five float32 5x5
conv layers summed in different orders).

The bf16 DCGAN's layer boundaries (``nn/layer_boundary.py``) against the
layers' own chain, which the JAX comparison above holds: values and
gradients bit for bit, the plain version and the autograd Functions alike.
A model engages them on a CUDA tensor alone; here its tensors are taken as
on the card, and the Functions run on the kernels' arithmetic written in
PyTorch (``csrc/layer_boundary.cu``'s header); the kernels themselves run
only on a card (``tests/test_torch_cuda.py``). Bias gradients: the same float32 terms
summed in another order, within 1e-5 of the sum of their magnitudes.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.models import dcgan as jax_dcgan
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.convert import load_params
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.models import dcgan, densenet, get_model
from otgan_tpu_torch.nn import layer_boundary as lb
from otgan_tpu_torch.nn.layers import data_init, reset_parameters


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


# -- the layer boundaries ------------------------------------------------------

def _crelu_pad_forward(y, bias, pads):
    lb.launches["kernel"] += 1
    return lb.crelu_pad_plain(y, bias, pads)


def _crelu_pad_backward(gx, x, y_shape, pads, grad_y=True, grad_bias=True):
    """The backward kernel's arithmetic: each half's relu gradient by the
    sign the saved input shows, their difference."""
    lb.launches["kernel"] += 1
    n, h, w, c = y_shape
    pt, _, pl, _ = pads
    g, x = gx[:, pt:pt + h, pl:pl + w].float(), x[:, pt:pt + h, pl:pl + w].float()
    d = (torch.where(x[..., :c] <= 0, 0.0, g[..., :c])
         - torch.where(x[..., c:] <= 0, 0.0, g[..., c:])).to(torch.bfloat16)
    return d if grad_y else None, d.float().sum((0, 1, 2)) if grad_bias else None


def _glu_upsample_forward(y, bias, factor, hw=None):
    lb.launches["kernel"] += 1
    return lb.glu_upsample_plain(y, bias, factor, hw)


def _glu_upsample_backward(gx, y, bias, factor, hw=None, grad_y=True, grad_bias=True):
    """The backward kernel's arithmetic: the 2x2 gradient summed as
    ((g00 + g01) + g10) + g11 and rounded, then GLU's backward in float32."""
    lb.launches["kernel"] += 1
    g = gx.float()
    if factor == 2:
        g = g.reshape(g.shape[0], g.shape[1] // 2, 2, g.shape[2] // 2, 2, -1)
        g = (((g[:, :, 0, :, 0] + g[:, :, 0, :, 1]) + g[:, :, 1, :, 0])
             + g[:, :, 1, :, 1]).to(torch.bfloat16).float()
    hb, gate = torch.chunk(y.float() + bias, 2, dim=-1)
    g = g.reshape(hb.shape)
    s = torch.sigmoid(gate)
    gy = torch.cat([g * s, (g * hb) * (1 - s) * s], dim=-1)
    return (gy.to(torch.bfloat16) if grad_y else None,
            gy.reshape(-1, gy.shape[-1]).sum(0) if grad_bias else None)


@pytest.fixture
def emulated_kernels():
    """The operator's autograd Functions on the CPU, as a model on the card
    engages them, their kernels replaced by the arithmetic above."""
    with mock.patch.multiple(lb, _on_card=lambda t: True,
                             crelu_pad_cuda=_crelu_pad_forward,
                             crelu_pad_backward_cuda=_crelu_pad_backward,
                             glu_upsample_cuda=_glu_upsample_forward,
                             glu_upsample_backward_cuda=_glu_upsample_backward):
        yield


def _bf16_model(make, remat, seed):
    m = make(compute_dtype=torch.bfloat16, remat=remat,
             remat_policy="disc_c3,gen_g2" if remat else "")
    reset_parameters(m, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases and gains away from their init values
        gen = torch.Generator().manual_seed(seed + 1)
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return m


def _values_and_grads(model, inp, fused):
    with mock.patch.object(dcgan, "engages", lambda *a: fused):
        x = inp.clone().requires_grad_()
        out = model(x)
        # a gradient that reaches both CReLU halves and every GLU input
        loss = (out.float() * torch.linspace(-1, 2, out.numel()).reshape(out.shape)).sum()
        return out.detach(), torch.autograd.grad(loss, [*model.parameters(), x])


@pytest.mark.parametrize("path", ["plain", "kernel_arithmetic"])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("mode", ["crelu_pad", "glu_upsample"])
def test_layer_boundary_equals_the_layer_chain(request, mode, remat, path):
    """The critic (CReLU boundaries into convs padded (1, 2) at stride 2) or
    the generator (GLU boundaries, 2x upsample, the dense layer's row-wide
    gate) at bf16, batch 2: the operator's output and every gradient equal
    the layers' own chain bit for bit (bias gradients of the Functions:
    another order of the same sum), with and without remat (whose save
    points then carry the layers' outputs before their bias)."""
    if path == "kernel_arithmetic":
        request.getfixturevalue("emulated_kernels")
    if mode == "crelu_pad":
        model = _bf16_model(dcgan.make_discriminator, remat, 0)
        inp = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
            np.float32)).to(torch.bfloat16)
    else:
        model = _bf16_model(dcgan.make_generator, remat, 2)
        inp = dcgan.sample_latent(2, torch.Generator().manual_seed(3))
    lb.reset_launch_counts()
    out, grads = _values_and_grads(model, inp, True)
    # each boundary forward and backward, and again forward where remat recomputes
    n = 3 if mode == "crelu_pad" else 4
    counted = ({"kernel": (3 if remat else 2) * n, "plain": 0} if path == "kernel_arithmetic"
               else {"kernel": 0, "plain": (2 if remat else 1) * n})
    assert lb.launches == counted
    want_out, want = _values_and_grads(model, inp, False)
    assert lb.launches == counted  # the layers' chain never reaches the operator
    assert torch.equal(out, want_out)
    names = [n for n, _ in model.named_parameters()] + ["input"]
    for name, g, w in zip(names, grads, want):
        if name.endswith(".b") and path == "kernel_arithmetic":
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().sum()))
        else:
            assert torch.equal(g, w), name


def _bypass_run(case):
    if case == "cpu_tensor":
        model = dcgan.make_discriminator(compute_dtype=torch.bfloat16)
    elif case == "densenet_lists":
        model = densenet.make_discriminator(1, 4, compute_dtype=torch.bfloat16)
    elif case == "float32":
        model = dcgan.make_discriminator()
    else:
        model = dcgan.make_discriminator(nonlinearity=case, compute_dtype=torch.bfloat16)
    reset_parameters(model, torch.Generator().manual_seed(4))
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    model(x).square().sum().backward()


@pytest.mark.parametrize("case", ["cpu_tensor", "densenet_lists", "float32", "elu", "celu"])
def test_layer_boundary_bypassed(request, case):
    """A CPU tensor, and on the card the DenseNet's list inputs, float32
    compute and the elu/celu pre-activations, run the layers as they are:
    neither counter moves."""
    if case != "cpu_tensor":
        request.getfixturevalue("emulated_kernels")
    lb.reset_launch_counts()
    _bypass_run(case)
    assert lb.launches == {"kernel": 0, "plain": 0}


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_layer_boundary_crossings_a_step(emulated_kernels, kind):
    """One engine step of the bf16 DCGAN at batch 4: a generator step
    crosses 17 boundaries (10 forwards: the generator's 4, the critic's 3 on
    each half; 7 backwards: the critic on the images, then the generator), a
    critic step 16 (the same forwards; the critic's 3 backwards on each
    half); PERF.md's count a call."""
    eng = Engine(TrainConfig(model="dcgan", batch_size=4, num_devices=1, nr_sinkhorn_iter=5),
                 "cpu")
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    state, _ = eng.init_state(7, x)
    lb.reset_launch_counts()
    state, metrics = (eng.gen_step if kind == "gen" else eng.disc_step)(state, x)
    assert np.isfinite(float(metrics.dist))
    assert lb.launches == {"kernel": 17 if kind == "gen" else 16, "plain": 0}


@pytest.mark.parametrize("rows,groups", [
    (5000 * 35 * 35, 16), (5000 * 1024, 16), (8000 * 19 * 19, 32), (8000 * 64, 64),
    (5000, 2048), (512 * 1024, 16), (3, 5), (1, 1), (100, 300), (7, 256)])
def test_layer_boundary_tiling_covers_each_row_and_group_once(rows, groups):
    """The launch plan of every DCGAN boundary at batches 5000 and 8000, the
    card tests' 512, and ragged sizes: blocks of at most 256 threads, at most
    65535 row chunks, every row and group covered, no chunk empty."""
    tg, lanes, tiles, chunks, per = lb.tiling(rows, groups)
    assert tg * lanes <= lb.THREADS and 1 <= chunks <= 65535
    assert tiles * tg >= groups > (tiles - 1) * tg
    assert chunks * per >= rows > (chunks - 1) * per
    assert tiles * chunks <= max(lb.BLOCKS, tiles)
