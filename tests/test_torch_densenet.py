"""The port's DenseNet and its list-input, upsampled and dilated convs
against the JAX package: the same converted weights, the same images, and
for the generator the four noises JAX draws inside (``split(key, 4)``,
``uniform(-1, 1)``) given to the port as inputs; float32 compute on both
sides.

Tolerance: 2e-5 relative to the largest value (``tests/test_torch_dcgan.py``:
float32 convs summed in different orders); the data-dependent init 1e-4;
bfloat16 compute within the JAX package's own band, a cosine above 0.999
to the float32 result (``tests/test_models.py:151``).

The bf16 DenseNet's blocks on slabs (``nn/dense_boundary.py``) against the
layers' own chain, which the JAX comparisons above hold: values and every
gradient bit for bit. A model engages the slabs on a CUDA tensor alone;
here its tensors are taken as on the card, so the operators run their
plain versions, the kernels' arithmetic in PyTorch
(``csrc/dense_boundary.cu``'s header); the kernels themselves run only on
a card (``tests/test_torch_cuda.py``).
"""

import gc
import weakref
from unittest import mock

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
from otgan_tpu_torch.models import dcgan, densenet, get_model
from otgan_tpu_torch.nn import dense_boundary as db
from otgan_tpu_torch.nn.layers import Conv2d, apply_pre_activation, data_init, reset_parameters
from otgan_tpu_torch.utils import tracing

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


# -- the dense blocks on slabs -------------------------------------------------

@pytest.fixture
def on_card():
    """The model's tensors taken as on the card: the slabs engage, and each
    operator runs its plain version on the CPU."""
    with mock.patch.object(db, "_on_card", lambda t: True):
        yield


def _bf16_net(make, remat=False, seed=0, L=3, F=4):
    m = make(L, F, compute_dtype=torch.bfloat16, remat=remat,
             remat_policy="disc_d2,gen_u1" if remat else "")
    reset_parameters(m, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases and gains away from their init values
        gen = torch.Generator().manual_seed(seed + 1)
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return m


def _net_input(kind, seed=3, n=4, F=4):
    if kind == "critic":
        return torch.rand(n, 32, 32, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    return densenet.sample_latent(n, torch.Generator().manual_seed(seed), filters_per_layer=F)


def _leaf(inp):
    """The input with a gradient: the images, or the generator's first noise."""
    if isinstance(inp, tuple):
        return (inp[0].clone().requires_grad_(), *inp[1:])
    return inp.clone().requires_grad_()


def _weighted(out):
    return (out.float() * torch.linspace(-1, 2, out.numel()).reshape(out.shape)).sum()


def _values_and_grads(model, inp, slabs, between=None):
    """The output and the gradient of every parameter and of the input leaf;
    ``between``: a no-grad forward of the same model run after the forward
    and before its backward."""
    with mock.patch.object(db, "_on_card", lambda t: slabs):
        x = _leaf(inp)
        out = model(x)
        if between is not None:
            with torch.no_grad():
                model(between)
        leaf = x[0] if isinstance(x, tuple) else x
        return out.detach(), torch.autograd.grad(_weighted(out), [*model.parameters(), leaf])


def _assert_same(model, got, want):
    (out, grads), (want_out, want_grads) = got, want
    assert torch.equal(out, want_out)
    names = [n for n, _ in model.named_parameters()] + ["input"]
    bad = [n for n, g, w in zip(names, grads, want_grads) if not torch.equal(g, w)]
    assert not bad, bad


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("kind", ["critic", "generator"])
def test_dense_boundary_equals_the_layer_chain(kind, remat):
    """The bf16 critic (list convs, stride-2 down convs padded (0, 1)) or the
    generator (the dense layer's row-wide bias, noises, 2x up convs, the last
    conv) at L = 3, F = 4, batch 4: on slabs, the output and every gradient
    equal the layers' chain bit for bit, with and without remat. Each
    forward writes, gathers and scatters through the plain versions alone,
    remat's recompute again."""
    make = densenet.make_discriminator if kind == "critic" else densenet.make_generator
    model, inp = _bf16_net(make, remat), _net_input(kind)
    db.reset_launch_counts()
    got = _values_and_grads(model, inp, True)
    # critic: 12 writes, 12 gathers, 12 scatters, 12 gathers again for the
    # weights; generator: 3 more writes (the noises); remat recomputes as
    # much of a segment's forward as its checkpoint needs
    per = 48 if kind == "critic" else 51
    counted = dict(db.launches)
    assert counted["kernel"] == 0 and (counted["plain"] >= per if remat
                                       else counted["plain"] == per)
    want = _values_and_grads(model, inp, False)
    assert db.launches == counted  # the chain never reaches the operators
    _assert_same(model, got, want)


def test_dense_boundary_two_critic_forwards_alive():
    """The critic step's pattern: the critic on fakes and on data under
    autograd, then one ``autograd.grad``; each forward has its own slabs."""
    model = _bf16_net(densenet.make_discriminator, seed=5)
    fake, data = _net_input("critic", 6), _net_input("critic", 7)
    results = []
    for slabs in (True, False):
        with mock.patch.object(db, "_on_card", lambda t: slabs):
            f_fake, f_dat = model(fake), model(data)
            loss = _weighted(f_fake) - _weighted(f_dat.flip(0))
            results.append((torch.cat([f_fake, f_dat]).detach(),
                            torch.autograd.grad(loss, list(model.parameters()))))
    _assert_same(model, (results[0][0], results[0][1] + (fake,)),
                 (results[1][0], results[1][1] + (fake,)))


@pytest.mark.parametrize("kind", ["critic", "generator"])
def test_dense_boundary_no_grad_forward_between(kind):
    """A no-grad forward of the same net on other inputs between a forward
    and its backward (the features phase beside a graph) leaves the graph's
    slabs as they were."""
    make = densenet.make_discriminator if kind == "critic" else densenet.make_generator
    model = _bf16_net(make, seed=8)
    inp, other = _net_input(kind, 9), _net_input(kind, 10)
    got = _values_and_grads(model, inp, True, between=other)
    _assert_same(model, got, _values_and_grads(model, inp, False, between=other))


@pytest.mark.parametrize("upsample", [False, True], ids=["list", "up"])
def test_dense_boundary_gather_zeros_as_the_card(upsample):
    """The plain gather writes relu as the card computes it, on the CPU too:
    a slab zero of either sign gives +0 in both halves (the CPU's
    ``torch.relu`` keeps -0), a NaN passes as a NaN, and every other value
    is the chain's."""
    class Conv:
        def same_pads(self, h, w):
            return (1, 1, 1, 1)

    Conv.upsample = upsample
    block = db.Block(torch.empty(0), 2, 2, 2, [4, 4])
    vals = torch.tensor([-0.0, 0.0, float("nan"), -1.5, 2.0, -0.25, 0.5, 3.0])
    block.slab.copy_(vals.repeat(8).reshape(block.slab.shape))
    x = db.gather_plain(block, db.geometry(block, 2, Conv()))
    s = block.slab.float()
    s = s.repeat_interleave(2, 1).repeat_interleave(2, 2) if upsample else s
    if upsample:
        want = torch.cat([s, -s], dim=-1)
    else:
        want = torch.cat([s[..., :4], -s[..., :4], s[..., 4:], -s[..., 4:]], dim=-1)
    nan = want.isnan()
    assert torch.equal(x.isnan(), nan)
    want = (want.clamp_min(0) + 0.0).to(torch.bfloat16)
    assert torch.equal(x[~nan].view(torch.int16), want[~nan].view(torch.int16))
    assert not bool(torch.signbit(x[x == 0]).any())


@pytest.mark.parametrize("kernel,stride,upsample", [(3, 1, False), (3, 2, False), (3, 1, True)],
                         ids=["list", "down", "up"])
def test_dense_boundary_scatter_writes_every_position(kernel, stride, upsample):
    """The first consumer's scatter stores every position of each element
    that needs a gradient, zeros included (accumulators start as NaN), a
    later one adds to each, and an element without one (a noise) is left
    alone."""
    from otgan_tpu_torch.nn.layers import same_padding

    class Conv:
        def same_pads(self, h, w):
            return same_padding(h, kernel, stride) + same_padding(w, kernel, stride)

    Conv.upsample = upsample
    block = db.Block(torch.empty(0), 2, 4, 4, [4, 2, 2])
    block.slab.copy_(torch.randn(block.slab.shape).round())  # many exact zeros
    geo = db.geometry(block, 3, Conv())
    g = torch.randn(db._input_shape(block, geo)).to(torch.bfloat16)
    accs = [torch.full((2, 4, 4, f), float("nan")) for f in (4, 2)] + [None]
    db.scatter_plain(block, geo, g, accs, [True, True, False])
    first = [a.clone() for a in accs[:2]]
    assert all(bool(torch.isfinite(a).all()) for a in first)
    db.scatter_plain(block, geo, g, accs, [False, False, False])
    assert all(torch.equal(a, f + f) for a, f in zip(accs[:2], first))


def test_dense_boundary_frees_each_forward(on_card):
    """No reference cycle keeps a forward's blocks: they go with the graph
    after its backward, and with the forward under no-grad, without the
    garbage collector."""
    model, x = _bf16_net(densenet.make_discriminator), _net_input("critic")
    made, init = [], db.Block.__init__

    def track(self, *a, **k):
        init(self, *a, **k)
        made.append(weakref.ref(self))

    gc.disable()
    try:
        with mock.patch.object(db.Block, "__init__", track):
            out = model(x)
            assert sum(r() is not None for r in made) == 3
            torch.autograd.grad(out.sum(), list(model.parameters()))
            del out
            with torch.no_grad():
                model(x)
    finally:
        gc.enable()
    assert len(made) == 6 and all(r() is None for r in made)


def _bypass_run(case):
    if case == "single_tensor":
        model = dcgan.make_discriminator(compute_dtype=torch.bfloat16)
        reset_parameters(model, torch.Generator().manual_seed(4))
        model(_net_input("critic", n=2)).square().sum().backward()
        return
    kw = {"compute_dtype": torch.float32 if case == "float32" else torch.bfloat16}
    if case in ("elu", "celu", "relu"):
        kw["nonlinearity"] = case
    for make, kind in ((densenet.make_discriminator, "critic"),
                       (densenet.make_generator, "generator")):
        model = make(1, 4, **kw)
        reset_parameters(model, torch.Generator().manual_seed(4))
        inp = _net_input(kind, n=2)
        if case == "init_pending":
            data_init(model, inp)
        else:
            model(inp).float().square().sum().backward()


@pytest.mark.parametrize("case", ["cpu_tensor", "float32", "elu", "celu", "relu",
                                  "init_pending", "single_tensor"])
def test_dense_boundary_bypassed(case):
    """A CPU tensor, and on the card float32 compute, the elu/celu/relu
    pre-activations, the data-dependent init and single-tensor convs (the
    DCGAN) run the layers' chain: neither counter moves."""
    with mock.patch.object(db, "_on_card", lambda t: case != "cpu_tensor"):
        db.reset_launch_counts()
        _bypass_run(case)
    assert db.launches == {"kernel": 0, "plain": 0}


@pytest.mark.parametrize("kind", ["critic", "generator"])
def test_dense_boundary_engages_past_a_launch(kind):
    """Blocks of more elements than one gather or scatter launch takes (L =
    MAX_ELEMS, F = 1: the transition conv takes MAX_ELEMS + 1 or + 2) run on
    slabs too, and equal the layers' chain bit for bit; each such conv's
    gather and scatter launches once a run of MAX_ELEMS elements, the runs
    covering the prefix's channel groups in order."""
    make = densenet.make_discriminator if kind == "critic" else densenet.make_generator
    L = db.MAX_ELEMS
    model, inp = _bf16_net(make, seed=11, L=L, F=1), _net_input(kind, 12, n=2, F=1)
    db.reset_launch_counts()
    got = _values_and_grads(model, inp, True)
    assert db.launches["plain"] > 0
    _assert_same(model, got, _values_and_grads(model, inp, False))

    assert db.runs(L) == [range(L)]
    assert db.runs(2 * L + 2) == [range(L), range(L, 2 * L), range(2 * L, 2 * L + 2)]
    block = db.Block(torch.empty(0), 1, 2, 2, [2, 4] + [2] * (L + 1))
    geo = db.Geometry(L + 3, 1, False, (0, 0, 0, 0), False)
    gs, els = db._structs(block, geo)
    assert gs.k_groups == block.offsets[-1] // block.vec
    assert [run for run, _ in els] == [range(L), range(L, L + 3)]
    for run, el in els:
        assert el.n == len(run)
        assert list(el.off[:el.n + 1]) == [block.offsets[e] // block.vec
                                           for e in range(run.start, run.stop + 1)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_dense_boundary_engine_step(kind, accum):
    """One engine step of the bf16 DenseNet (L = 1, F = 4, batch 4) on slabs
    against the layers' chain from the same state: every parameter, the
    EMA and Adam's moments bit for bit, and the counts of a step. Launches a
    step (PERF.md): M (39 L + 45) a generator step and M (42 L + 45) a
    critic step at --grad_accum M > 1 (2676 and 2868 at L = 16, M = 4);
    27 L + 30 and 30 L + 33 without microbatches; ``dense_concat`` as on
    the chain."""
    L = 1
    cfg = TrainConfig(model="densenet", layers_per_block=L, filters_per_layer=4, batch_size=4,
                      grad_accum=accum, num_devices=1, nr_sinkhorn_iter=5,
                      compute_dtype="bfloat16")
    x = np.random.default_rng(6).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    results = []
    for slabs in (True, False):
        eng = Engine(cfg, "cpu")
        state, _ = eng.init_state(7, x)
        db.reset_launch_counts()
        tracing.reset_counts()
        with mock.patch.object(db, "_on_card", lambda t: slabs):
            state, m = (eng.gen_step if kind == "gen" else eng.disc_step)(state, x)
        assert np.isfinite(float(m.dist)) and np.isfinite(float(m.entropy))
        leaves = [t.detach().clone() for t in (
            *state.gen.parameters(), *state.disc.parameters(),
            *torch.utils._pytree.tree_leaves((state.gen_ema, state.gen_opt, state.disc_opt)))
            if isinstance(t, torch.Tensor)]
        results.append((leaves, dict(db.launches), tracing.counts["dense_concat"]))
    (got, counts, concat), (want, plain_counts, plain_concat) = results
    if accum > 1:
        n = accum * ((39 if kind == "gen" else 42) * L + 45)
    else:
        n = 27 * L + 30 if kind == "gen" else 30 * L + 33
    assert counts == {"kernel": 0, "plain": n}
    assert plain_counts == {"kernel": 0, "plain": 0}
    assert concat == plain_concat == (5 * accum if accum > 1 else 3) * (3 * L + 3)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    assert not bad, (bad, len(got))
