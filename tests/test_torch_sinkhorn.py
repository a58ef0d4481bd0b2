"""The port's Sinkhorn (plain loop, kernel wrapper, early exit) against the
JAX package and the float64 oracle. The same numpy inputs go to both.

Tolerances are the JAX package's own: assignments P within 1e-5, entropies
within 1e-4 (tests/test_sinkhorn_tiled.py), potentials within 1e-5 of
their magnitude at lam = 50. The CUDA kernel itself runs only on a card:
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from otgan_tpu.ops.sinkhorn import sinkhorn_assignment as jax_sinkhorn_assignment
from otgan_tpu.ops.sinkhorn import sinkhorn_log_tol as jax_sinkhorn_log_tol
from otgan_tpu.ops.sinkhorn_pallas import sinkhorn_assignment_pallas
from otgan_tpu.ops.sinkhorn_pallas_tiled import _col_potential, sinkhorn_assignment_padded
from otgan_tpu_torch.ops import sinkhorn_cuda
from otgan_tpu_torch.ops.sinkhorn import (
    assignment_and_entropy,
    sinkhorn_assignment,
    sinkhorn_log,
    sinkhorn_log_tol,
)
from tests.reference_impl import sinkhorn_np


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made these tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cost(seed, n, m, d=32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.standard_normal((m, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return 1.0 - a @ b.T


@pytest.mark.parametrize("n,m", [(64, 128), (136, 256)])
def test_plain_col_potential_matches_pallas_kernel(n, m):
    """The kernel's plain version == ``_col_potential`` (the Pallas kernel
    in interpret mode) on the same logits."""
    x = -50.0 * _cost(n + m, n, m)
    want = np.asarray(_col_potential(jnp.asarray(x), 30, interpret=True))[0]
    got = sinkhorn_cuda.col_potential(torch.from_numpy(x)[None], 30)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_wrapper_on_cpu_takes_plain_version_and_counts():
    sinkhorn_cuda.reset_launch_counts()
    x = torch.from_numpy(-50.0 * _cost(1, 16, 24))[None]
    v = sinkhorn_cuda.col_potential(x, 5)
    assert v.shape == (1, 24)
    assert sinkhorn_cuda.launches == {"kernel": 0, "plain": 1}
    _, _, v_ref = sinkhorn_log(x, 5)
    torch.testing.assert_close(v, v_ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        sinkhorn_cuda.col_potential_cuda(x, 5)  # a CPU tensor never launches


@pytest.mark.parametrize(
    "shape", [(256, 128), (2, 128, 128)], ids=["aligned", "aligned_batched"]
)
def test_kernel_path_matches_jax_tiled(shape):
    costs = np.stack([_cost(i, *shape[-2:]) for i in range(int(np.prod(shape[:-2])))])
    costs = costs.reshape(shape)
    p_ref, e_ref = sinkhorn_assignment_pallas(jnp.asarray(costs), 50.0, 40)
    p, e = sinkhorn_assignment(torch.from_numpy(costs), 50.0, 40, use_pallas=True)
    assert p.shape == shape
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=1e-4)


@pytest.mark.parametrize("n,m", [(100, 128), (128, 100), (100, 100), (250, 250)])
def test_kernel_path_matches_jax_padded_misaligned(n, m):
    """The TPU pads misaligned shapes to its tile grid; the port runs them
    unpadded and must give the same assignment."""
    cost = _cost(n + m, n, m)
    p_ref, e_ref = sinkhorn_assignment_padded(jnp.asarray(cost), 50.0, 40)
    p, e = sinkhorn_assignment(torch.from_numpy(cost), 50.0, 40, use_pallas=True)
    assert p.shape == (n, m)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(float(e), float(e_ref), atol=1e-4)


def test_padded_diagonal_lam500_matches_jax_and_oracle():
    """+999 self-match diagonal at lam = 500 (the single-batch case). At
    lam = 500 the JAX kernel itself strays ~1e-5 from the float64 oracle,
    so the port is held to the oracle at 1e-5 and to JAX at the JAX
    package's own lam = 500 band, 1e-4 (tests/test_sinkhorn_tiled.py:50)."""
    n = 120
    cost = _cost(9, n, n) + 999.0 * np.eye(n, dtype=np.float32)
    p_ref, e_ref = sinkhorn_assignment_padded(jnp.asarray(cost), 500.0, 60)
    p_np, e_np = sinkhorn_np(cost, 500.0, 60)
    p, e = sinkhorn_assignment(torch.from_numpy(cost), 500.0, 60, use_pallas=True)
    assert float(p.diagonal().max()) < 1e-6
    np.testing.assert_allclose(p.numpy(), p_np, atol=1e-5)
    np.testing.assert_allclose(float(e), e_np, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-4)
    np.testing.assert_allclose(float(e), float(e_ref), atol=1e-4)


@pytest.mark.parametrize(
    "seed,n,d,iters", [(21, 48, 512, 200), (3, 256, 4096, 300), (5, 200, 32, 300)]
)
def test_kernel_path_matches_float64_oracle_lam500(seed, n, d, iters):
    """lam = 500 vs the reference recursion in float64: the row-shifted
    kernel path stays within 1e-5 (the unshifted float32 loop does not,
    which is why the wrapper shifts)."""
    cost = _cost(seed, n, n, d=d)
    p_ref, e_ref = sinkhorn_np(cost, 500.0, iters)
    p, e = sinkhorn_assignment(torch.from_numpy(cost), 500.0, iters, use_pallas=True)
    np.testing.assert_allclose(p.numpy(), p_ref, atol=1e-5)
    assert abs(float(e) - e_ref) < 1e-4


def test_plain_loop_matches_float64_oracle_lam500():
    """The unshifted plain loop, as the JAX package runs it, holds the
    JAX package's lam = 500 band against the oracle."""
    cost = _cost(21, 48, 48, d=512)
    p_ref, e_ref = sinkhorn_np(cost, 500.0, 200)
    p, e = sinkhorn_assignment(torch.from_numpy(cost), 500.0, 200)
    np.testing.assert_allclose(p.numpy(), p_ref, atol=1e-4)
    assert abs(float(e) - e_ref) < 1e-4


def test_plain_loop_matches_jax_xla_loop():
    costs = np.stack([_cost(30 + i, 40, 56) for i in range(3)])
    p_ref, e_ref = jax_sinkhorn_assignment(jnp.asarray(costs), 50.0, 60)
    p, e = sinkhorn_assignment(torch.from_numpy(costs), 50.0, 60)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=1e-4)


def test_tol_exit_matches_jax():
    """Early exit: same iteration count as the JAX loop, same assignment."""
    rng = np.random.default_rng(7)  # the inputs of tests/test_sinkhorn.py
    fa, fb = (rng.standard_normal((96, 48)).astype(np.float32) for _ in range(2))
    fa /= np.linalg.norm(fa, axis=1, keepdims=True)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    x = -50.0 * np.stack([1.0 - fa @ fb.T, 1.0 - fb @ fa.T])
    log_ref, it_ref = jax_sinkhorn_log_tol(jnp.asarray(x), 500, 1e-3)
    log_a, iters = sinkhorn_log_tol(torch.from_numpy(x), 500, 1e-3)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(it_ref))
    assert iters.tolist() == [140, 500]  # per-matrix exit; the second hits the cap
    p, e = assignment_and_entropy(log_a)
    p_ref, e_ref = assignment_and_entropy(torch.from_numpy(np.asarray(log_ref)))
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)
    # through the public entry: tol > 0 overrides use_pallas
    p2, _ = sinkhorn_assignment(torch.from_numpy(-x / 50.0), 50.0, 500, use_pallas=True, tol=1e-3)
    torch.testing.assert_close(p2, p, atol=1e-6, rtol=0)
    _, capped = sinkhorn_log_tol(torch.from_numpy(x), 7, tol=0.0)
    assert capped.tolist() == [7, 7]


def test_above_the_grid_ceiling_counts_col_potential_not_local_steps():
    """``use_pallas`` on the CPU at 2641^2, above the grid kernel's ceiling
    on an H100: kernel 1's plain version, counted once as
    ``col_potential_plain`` in the trainer's launches, and no local-step
    launch of either tier, though the card runs it on the local-step
    kernel."""
    from otgan_tpu_torch.nn import dense_boundary, layer_boundary
    from otgan_tpu_torch.ops import sinkhorn_grid_cuda, sinkhorn_resident_cuda, sinkhorn_step_cuda
    from otgan_tpu_torch.ops.sinkhorn import kernel_tier
    from otgan_tpu_torch.ops.sinkhorn_grid_cuda import H100_LIMITS
    from otgan_tpu_torch.train import kernel_launches
    from otgan_tpu_torch.utils import tracing

    assert kernel_tier(2641, 2641, H100_LIMITS) == "tiled"
    for mod in (sinkhorn_cuda, sinkhorn_grid_cuda, sinkhorn_resident_cuda, sinkhorn_step_cuda,
                layer_boundary, dense_boundary):
        mod.reset_launch_counts()
    tracing.reset_counts()  # the main path's counts, beside the launches
    cost = torch.from_numpy(_cost(11, 2641, 2641, d=8))
    p, e = sinkhorn_assignment(cost, 50.0, 1, use_pallas=True)
    assert p.shape == (2641, 2641) and e.shape == ()
    counts = kernel_launches()
    assert counts.pop("col_potential_plain") == 1
    assert not any(counts.values()), counts
