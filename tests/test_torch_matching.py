"""The port's costs, matchers, distance and MED losses against the JAX
package and the float64 oracle (mirrors tests/test_matching_parity.py,
with its tolerances: matched features 2e-4 / 3e-4 and entropy 1e-3 against
the oracle at lam = 50; 1e-5 between the two float32 packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.ops import calc_distance as jax_calc_distance
from otgan_tpu.ops import match_random as jax_match_random
from otgan_tpu.ops import match_single_batch as jax_match_single_batch
from otgan_tpu.ops import match_two_batch as jax_match_two_batch
from otgan_tpu.ops.costs import cosine_cost as jax_cosine_cost
from otgan_tpu.ops.costs import scaled_sqeuclidean_cost as jax_sqeuclidean
from otgan_tpu.ops.losses import med_discriminator_loss as jax_disc_loss
from otgan_tpu.ops.losses import med_generator_loss as jax_gen_loss
from otgan_tpu.ops.matching import two_batch_costs as jax_two_batch_costs
from otgan_tpu_torch.ops import costs, matching
from otgan_tpu_torch.ops.losses import med_discriminator_loss, med_generator_loss
from tests import reference_impl as ref

LAM, ITERS = 50.0, 60


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made these tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(seed, n, d, normalize=True):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    if normalize:
        f /= np.linalg.norm(f, axis=1, keepdims=True)
    return f


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fields(m):
    return [m.a_a, m.b_b, m.a_b, m.b_a]


def test_costs_match_jax():
    fa, fb = _features(1, 24, 40, False), _features(2, 16, 40, False)
    for port_fn, jax_fn in [
        (costs.cosine_cost, jax_cosine_cost),
        (costs.scaled_sqeuclidean_cost, jax_sqeuclidean),
    ]:
        np.testing.assert_allclose(
            port_fn(_t(fa), _t(fb)).numpy(),
            np.asarray(jax_fn(jnp.asarray(fa), jnp.asarray(fb))),
            atol=1e-5, rtol=1e-6,
        )
    got = matching.two_batch_costs(_t(fa), _t(_features(3, 24, 40)))
    want = jax_two_batch_costs(jnp.asarray(fa), jnp.asarray(_features(3, 24, 40)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_precision_knob_accepts_highest_only():
    assert costs.resolve_precision(None) == "highest"
    assert costs.resolve_precision("highest") == "highest"
    with pytest.raises(NotImplementedError):
        costs.resolve_precision("high")
    with pytest.raises(ValueError):
        costs.resolve_precision("bogus")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_path"])
def test_two_batch_parity(use_pallas):
    fa, fb = _features(10, 64, 32), _features(11, 64, 32)
    want = ref.match_two_batch_np(fa, fb, LAM, ITERS)
    got = matching.match_two_batch(_t(fa), _t(fb), LAM, ITERS, use_pallas=use_pallas)
    jx = jax_match_two_batch(jnp.asarray(fa), jnp.asarray(fb), LAM, ITERS)
    for g, w, j in zip(_fields(got), want[:4], _fields(jx)):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5)
    assert abs(float(got.entropy) - want[4]) < 1e-3
    assert abs(float(got.entropy) - float(jx.entropy)) < 1e-4


def test_two_batch_rejects_odd_batch():
    with pytest.raises(ValueError, match="even"):
        matching.match_two_batch(_t(_features(0, 5, 4)), _t(_features(1, 5, 4)), LAM, 3)


def test_single_batch_parity():
    fa, fb = _features(12, 48, 24), _features(13, 48, 24)
    want = ref.match_single_batch_np(fa, fb, LAM, ITERS)
    got = matching.match_single_batch(_t(fa), _t(fb), LAM, ITERS, use_pallas=True)
    jx = jax_match_single_batch(jnp.asarray(fa), jnp.asarray(fb), LAM, ITERS)
    for g, w, j in zip(_fields(got), want[:4], _fields(jx)):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5)
    assert abs(float(got.entropy) - want[4]) < 1e-3


def test_random_matching_parity():
    fa, fb = _features(14, 64, 8, False), _features(15, 64, 8, False)
    want = ref.match_random_np(fa, fb, shard_size=8)
    got = matching.match_random(_t(fa), _t(fb), shard_size=8)
    jx = jax_match_random(jnp.asarray(fa), jnp.asarray(fb), shard_size=8)
    for g, w, j in zip(_fields(got), want[:4], _fields(jx)):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert float(got.entropy) == 0.0


def test_calc_distance_parity():
    fa, fb = _features(16, 64, 32), _features(17, 64, 32)
    want = ref.calc_distance_np(fa, fb, ref.match_two_batch_np(fa, fb, LAM, ITERS))
    got_m = matching.match_two_batch(_t(fa), _t(fb), LAM, ITERS, use_pallas=True)
    got = matching.calc_distance(_t(fa), _t(fb), got_m)
    jx_m = jax_match_two_batch(jnp.asarray(fa), jnp.asarray(fb), LAM, ITERS)
    jx = jax_calc_distance(jnp.asarray(fa), jnp.asarray(fb), jx_m)
    np.testing.assert_allclose(float(got), want, atol=1e-4)
    np.testing.assert_allclose(float(got), float(jx), atol=1e-6)


def test_toy_cost_two_batch_parity():
    fa, fb = _features(18, 32, 16, False), _features(19, 32, 16, False)
    want = ref.match_two_batch_np(fa, fb, LAM, ITERS, cost_fn=ref.toy_cost_np)
    got = matching.match_two_batch(
        _t(fa), _t(fb), LAM, ITERS, cost_fn=costs.scaled_sqeuclidean_cost
    )
    for g, w in zip(_fields(got), want[:4]):
        np.testing.assert_allclose(g.numpy(), w, atol=3e-4)
    d = matching.calc_distance_mean(_t(fa), _t(fb), got)
    d_want = (
        np.mean(fb * want[1]) + np.mean(fa * want[0]) - 2 * np.mean(fa * want[2])
    ) / 2.0
    np.testing.assert_allclose(float(d), d_want, atol=1e-5)


def test_loss_gradients_match_jax():
    """The surrogate losses' gradients are the reference's injected
    cotangents, cross term of weight 1 included, in both packages."""
    fa, fb = _features(20, 32, 24), _features(21, 32, 24)
    jm = jax_match_two_batch(jnp.asarray(fa), jnp.asarray(fb), LAM, 30)
    pm = matching.match_two_batch(_t(fa), _t(fb), LAM, 30)

    def jax_grads():
        def loss(fa_, fb_):
            m = jax_match_two_batch(fa_, fb_, LAM, 30)
            return jax_gen_loss(fa_, m), jax_disc_loss(fa_, fb_, m)

        g_gen = jax.grad(lambda a, b: loss(a, b)[0], argnums=(0, 1))
        g_disc = jax.grad(lambda a, b: loss(a, b)[1], argnums=(0, 1))
        return g_gen(jnp.asarray(fa), jnp.asarray(fb)), g_disc(jnp.asarray(fa), jnp.asarray(fb))

    (jg_a, jg_b), (jd_a, jd_b) = jax_grads()
    ta = _t(fa).requires_grad_(True)
    tb = _t(fb).requires_grad_(True)
    m = matching.match_two_batch(ta, tb, LAM, 30)
    g_a, = torch.autograd.grad(med_generator_loss(ta, m), [ta])
    d_a, d_b = torch.autograd.grad(med_discriminator_loss(ta, tb, m), [ta, tb])
    np.testing.assert_allclose(g_a.numpy(), np.asarray(jg_a), atol=1e-5)
    assert float(np.abs(np.asarray(jg_b)).max()) == 0.0  # data gets no gen grad
    np.testing.assert_allclose(d_a.numpy(), np.asarray(jd_a), atol=1e-5)
    np.testing.assert_allclose(d_b.numpy(), np.asarray(jd_b), atol=1e-5)
    # the cotangents themselves: f_aa - f_ab and f_bb - f_ba
    np.testing.assert_allclose(g_a.numpy(), (pm.a_a - pm.a_b).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        d_b.numpy(), np.asarray(jm.b_b - jm.b_a), atol=1e-5
    )
