"""Remat and save points in the port (twin of ``tests/test_models.py:100-198``).

``--remat`` runs a model's stages as ``torch.utils.checkpoint`` segments
that end at the save points ``--remat_policy`` lists (one segment without
a policy); a scheduling decision, so forward values and gradients must
equal the plain module's (atol 1e-6, float32, CPU) for the toy, the DCGAN
and a small DenseNet. Unknown names are inert, and so is ``disc_c2_half``
(a segment boundary keeps whole tensors, so the port cannot keep the half
of disc_c2 that JAX's ``save_point_half`` keeps, and keeps none of it; the
critic warns of it, ``tests/test_torch_crash_recovery.py``). The port's
remat gradients also hold against
the JAX package's under the same policy (2e-5 of the largest value, as
``tests/test_torch_dcgan.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.models import densenet as jax_densenet
from otgan_tpu_torch.convert import load_params, unflatten_params
from otgan_tpu_torch.models import dcgan, densenet, toy_mlp
from otgan_tpu_torch.nn import layers
from otgan_tpu_torch.nn.layers import reset_parameters, save_names, segments


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_values_and_grads(make, inputs, policies, seed=0):
    """``make(remat, remat_policy)`` without remat, with remat alone and
    with each policy: the same output and the same gradients of
    ``sum(out ** 2)`` (parameters and inputs). Several inputs go in as one
    tuple (the DenseNet's noises)."""
    plain = make(False, "")
    reset_parameters(plain, torch.Generator().manual_seed(seed))
    results = []
    for remat, policy in [(False, "")] + [(True, "")] + [(True, p) for p in policies]:
        module = make(remat, policy)
        module.load_state_dict(plain.state_dict())
        ins = [t.clone().requires_grad_() for t in inputs]
        out = module(ins[0] if len(ins) == 1 else tuple(ins))
        leaves = [*module.parameters(), *ins]
        results.append((out.detach(), torch.autograd.grad(torch.sum(out ** 2), leaves)))
    out0, g0 = results[0]
    for out, g in results[1:]:
        np.testing.assert_allclose(out.numpy(), out0.numpy(), atol=1e-6, rtol=0)
        for a, b in zip(g, g0):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_toy_remat_matches_plain():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 2)).astype(np.float32))
    _same_values_and_grads(lambda r, p: toy_mlp.make_discriminator(remat=r, remat_policy=p),
                           [x], ["unknown_name_is_inert"])


def test_dcgan_critic_and_generator_remat_match_plain():
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    _same_values_and_grads(lambda r, p: dcgan.make_discriminator(remat=r, remat_policy=p),
                           [x], ["disc_c3,disc_c4,unknown_name_is_inert", "disc_c2_half",
                                 "disc_c2,disc_c2_half,disc_c3,disc_c4"])
    z = dcgan.sample_latent(2, torch.Generator().manual_seed(4))
    _same_values_and_grads(lambda r, p: dcgan.make_generator(remat=r, remat_policy=p),
                           [z], ["gen_g1,gen_g2", "gen_g3"])


def test_densenet_remat_matches_plain():
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    policies = ["gen_u1,gen_u2,disc_d2,disc_d3", "disc_d1", "unknown_name_is_inert"]
    _same_values_and_grads(
        lambda r, p: densenet.make_discriminator(2, 4, remat=r, remat_policy=p), [x], policies)
    z = densenet.sample_latent(2, torch.Generator().manual_seed(6), filters_per_layer=4)
    _same_values_and_grads(
        lambda r, p: densenet.make_generator(2, 4, remat=r, remat_policy=p), list(z), policies)


def test_segments_end_at_the_listed_save_points(monkeypatch):
    stages = [(None, ("disc_c2",)), (None, ("disc_c3",)), (None, ("disc_c4",)), (None, ())]

    def cut(policy):
        return [len(seg) for seg in segments(stages, save_names(policy))]

    assert cut("") == [4]
    assert cut("unknown_name_is_inert") == [4]
    assert cut("disc_c3") == [2, 2]
    assert cut(" disc_c2 , disc_c4") == [1, 2, 1]
    # the DCGAN critic runs one checkpoint a segment; disc_c2_half cuts none
    calls = []
    real = layers.checkpoint
    monkeypatch.setattr(layers, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.zeros((1, 32, 32, 3), requires_grad=True)
    for policy, n in (("", 1), ("disc_c2_half", 1), ("disc_c2,disc_c2_half", 2),
                      ("disc_c2,disc_c3,disc_c4", 4)):
        calls.clear()
        dcgan.make_discriminator(remat=True, remat_policy=policy)(x)
        assert len(calls) == n, policy


def test_remat_recomputes_in_the_backward_pass():
    """Under remat every conv starts again in the backward pass (a pre-hook
    counts it: the recompute stops once the last tensor it must rebuild is
    saved); without a gradient to record (init, sampling) each runs once."""
    calls = []
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    for remat, policy in ((False, ""), (True, ""), (True, "disc_d1,disc_d2,disc_d3")):
        disc = densenet.make_discriminator(1, 4, remat=remat, remat_policy=policy)
        convs = [m for m in disc.modules() if m is not disc]
        for m in convs:
            m.register_forward_pre_hook(lambda *_: calls.append(1))
        calls.clear()
        torch.sum(disc(x) ** 2).backward()
        assert len(calls) == len(convs) * (2 if remat else 1), (remat, policy)
        calls.clear()
        with torch.no_grad():
            disc(x)
        assert len(calls) == len(convs)


def test_densenet_remat_grads_match_jax():
    """The port's remat-policy gradients against the JAX package's
    ``jax.checkpoint`` with ``save_only_these_names`` on the same weights."""
    policy = "disc_d2,disc_d3"
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    disc_j = jax_densenet.make_discriminator(1, 4, remat=True, remat_policy=policy,
                                             compute_dtype="float32")
    params, f = disc_j.init(jax.random.PRNGKey(10), jnp.asarray(x))
    ct = np.random.default_rng(9).standard_normal(f.shape).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(disc_j.apply(p, jnp.asarray(x)) * ct))(params)
    disc = densenet.make_discriminator(1, 4, remat=True, remat_policy=policy)
    load_params(disc, params)
    names = [n for n, _ in disc.named_parameters()]
    grads = torch.autograd.grad(torch.sum(disc(torch.from_numpy(x)) * torch.from_numpy(ct)),
                                list(disc.parameters()))
    got = unflatten_params(dict(zip(names, grads)))
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                       atol=2e-5 * float(np.abs(w).max()))
