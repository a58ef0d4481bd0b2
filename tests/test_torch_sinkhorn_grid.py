"""The grid tier of the port's Sinkhorn (``ops/sinkhorn_grid_cuda.py``, the
redesign of TPU kernel 1 for matrices the card's shared memory holds) on the
CPU: its plan, the three-tier dispatch, and its plain version against the
JAX package's kernel-1 path (``_col_potential`` in interpret mode,
``sinkhorn_assignment_pallas``, ``sinkhorn_assignment_padded``) and the
float64 oracle. The same numpy inputs go to both packages.

Tolerances are the JAX package's own: P within 1e-5 and entropy within 1e-4
at lam = 50 (tests/test_sinkhorn_tiled.py); at lam = 500 the port is held
to the float64 oracle within 1e-5 and to JAX within its lam = 500 band,
1e-4 (tests/test_sinkhorn_tiled.py:50), where the float32 loops of both
packages stray ~1e-5 from each other. The CUDA kernel itself runs only on a
card: tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from otgan_tpu.ops.sinkhorn_pallas import sinkhorn_assignment_pallas
from otgan_tpu.ops.sinkhorn_pallas_tiled import _col_potential, sinkhorn_assignment_padded
from otgan_tpu_torch.ops import sinkhorn_cuda
from otgan_tpu_torch.ops import sinkhorn_grid_cuda as gc
from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc
from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy, kernel_tier, sinkhorn_assignment
from tests.reference_impl import sinkhorn_np

H100 = (132, 232448)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made such tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _costs(seed, b, n, m, d=32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, m, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    return 1.0 - a @ c.transpose(0, 2, 1)


def test_grid_plan_h100_ceiling():
    """At 132 SMs of 232,448 B: the main path's 2500^2 on 132 blocks of 19
    rows, one matrix at a time; the largest square 2640^2 (bands of 20
    rows); the square above it refused."""
    assert gc.grid_plan(2500, 2500, *H100, batch=6) == (132, 19)
    assert gc.grid_groups(132, 6, 132) == 1
    assert gc.grid_plan(2640, 2640, *H100) == (132, 20)
    assert gc.grid_plan(2641, 2641, *H100) is None
    assert max(n for n in range(2500, 2700) if gc.grid_plan(n, n, *H100)) == 2640
    # mid-size matrices run side by side: 6 x 1000^2 on 22 blocks each
    assert gc.grid_plan(1000, 1000, *H100, batch=6) == (22, 46)
    assert gc.grid_groups(22, 6, 132) == 6
    assert gc.grid_plan(1200, 1200, *H100, batch=3) == (43, 28)
    # a forced block count, and one whose bands do not fit
    assert gc.grid_plan(1000, 1000, *H100, blocks=33) == (33, 31)
    assert gc.grid_groups(33, 6, 132) == 4
    assert gc.grid_plan(2500, 2500, *H100, blocks=33) is None
    assert gc.grid_plan(100, 100, *H100, blocks=133) is None
    assert gc.grid_supported(2500, 2500, H100) and not gc.grid_supported(4000, 4000, H100)


@pytest.mark.parametrize("sms", [132, 114, 78, 16])
@pytest.mark.parametrize("n,m", [(2500, 2500), (2000, 2600), (1000, 1900), (1200, 1200),
                                 (100, 228), (1, 1), (5, 57999), (3000, 800)])
def test_grid_plan_never_overfills(sms, n, m):
    """Every plan's band fits one block's shared memory, covers the matrix
    with no empty block, and its groups of blocks fit on the SMs; a refused
    shape has no band that fits even on every SM."""
    for batch in (1, 3, 6):
        plan = gc.grid_plan(n, m, sms, H100[1], batch=batch)
        if plan is None:
            assert gc.smem_bytes(-(-n // sms), m) > H100[1]
            continue
        blocks, band = plan
        assert gc.smem_bytes(band, m) <= H100[1]
        assert 1 <= blocks <= sms and blocks * band >= n > (blocks - 1) * band
        assert 1 <= gc.grid_groups(blocks, batch, sms) * blocks <= sms
        assert gc.grid_groups(blocks, batch, sms) <= batch


def test_kernel_tier_by_shape():
    """resident / grid / kernel 1 at the DCGAN's batch 256, the reference
    batch 5000 and batch 8000, on an H100's limits; the measured boundary
    between the first two (up to 512^2 resident, 768^2 and up grid);
    on a card of half the SMs 2500^2 no longer fits and goes to kernel 1;
    a matrix of few cells too wide for the resident kernel goes on."""
    assert kernel_tier(128, 128, H100) == "resident"
    assert kernel_tier(2500, 2500, H100) == "grid"
    assert kernel_tier(4000, 4000, H100) == "tiled"
    assert kernel_tier(256, 256, H100) == "resident"
    assert kernel_tier(384, 384, H100) == "resident"
    assert kernel_tier(512, 512, H100) == "resident"
    assert kernel_tier(513, 512, H100) == "grid"
    assert kernel_tier(768, 768, H100) == "grid"
    assert kernel_tier(2500, 2500, (66, H100[1])) == "tiled"
    assert kernel_tier(4, 16384, H100) == "grid" and not rc.resident_supported(4, 16384)


@pytest.mark.parametrize("n,m", [(64, 128), (136, 256)])
def test_plain_matches_jax_col_potential(n, m):
    """The plain version's P == the row softmax of x + v, v from
    ``_col_potential`` (the Pallas kernel in interpret mode), at lam 50."""
    costs = _costs(n + m, 1, n, m)
    x = -50.0 * costs
    v = np.asarray(_col_potential(jnp.asarray(x[0]), 30, interpret=True))
    p_ref, e_ref = assignment_and_entropy(torch.from_numpy(x + v[:, None, :]))
    p, e = rc.sinkhorn_resident_plain(torch.from_numpy(costs), 50.0, 30)
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(256, 128), (2, 128, 128)], ids=["aligned", "batched"])
def test_plain_matches_jax_kernel_path(shape):
    costs = _costs(sum(shape), int(np.prod(shape[:-2])), *shape[-2:]).reshape(shape)
    p_ref, e_ref = sinkhorn_assignment_pallas(jnp.asarray(costs), 50.0, 40)
    p, e = gc.sinkhorn_grid(torch.from_numpy(costs), 50.0, 40)
    assert p.shape == shape and e.shape == shape[:-2]
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=1e-4)


def test_plain_matches_jax_padded_misaligned():
    """(100, 228): the TPU block-pads it to its tile grid; the port runs it
    unpadded and gives the same assignment."""
    cost = _costs(3, 1, 100, 228)[0]
    p_ref, e_ref = sinkhorn_assignment_padded(jnp.asarray(cost), 50.0, 40)
    p, e = gc.sinkhorn_grid(torch.from_numpy(cost), 50.0, 40)
    assert p.shape == (100, 228) and e.shape == ()
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(float(e), float(e_ref), atol=1e-4)


def test_plain_diagonal_lam500_matches_jax_and_oracle():
    """The single-batch +999 self-match diagonal at lam = 500: within 1e-5
    of the float64 oracle, within the JAX package's lam = 500 band of its
    kernel-1 path, and no self-match."""
    n = 120
    cost = _costs(9, 1, n, n)[0] + 999.0 * np.eye(n, dtype=np.float32)
    p_ref, e_ref = sinkhorn_assignment_padded(jnp.asarray(cost), 500.0, 60)
    p_np, e_np = sinkhorn_np(cost, 500.0, 60)
    p, e = gc.sinkhorn_grid(torch.from_numpy(cost), 500.0, 60)
    assert float(p.diagonal().max()) < 1e-6
    np.testing.assert_allclose(p.numpy(), p_np, atol=1e-5)
    np.testing.assert_allclose(float(e), e_np, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-4)
    np.testing.assert_allclose(float(e), float(e_ref), atol=1e-4)


@pytest.mark.parametrize("seed,n,m,iters", [(21, 48, 48, 200), (5, 200, 200, 300)])
def test_plain_matches_float64_oracle_lam500(seed, n, m, iters):
    costs = _costs(seed, 2, n, m, d=512)
    p, e = rc.sinkhorn_resident_plain(torch.from_numpy(costs), 500.0, iters)
    for i in range(2):
        p_ref, e_ref = sinkhorn_np(costs[i], 500.0, iters)
        np.testing.assert_allclose(p[i].numpy(), p_ref, atol=1e-5)
        assert abs(float(e[i]) - e_ref) < 1e-4


def test_wrapper_counts_plain_on_cpu_and_raises_elsewhere():
    """On the CPU the wrapper counts a plain launch; the kernel's entry
    takes only CUDA tensors; a device with no path raises instead of taking
    the plain version."""
    gc.reset_launch_counts()
    costs = torch.from_numpy(_costs(7, 2, 16, 24))
    p, e = gc.sinkhorn_grid(costs, 50.0, 3)
    assert gc.launches == {"kernel": 0, "plain": 1}
    p_ref, e_ref = rc.sinkhorn_resident_plain(costs, 50.0, 3)
    torch.testing.assert_close(p, p_ref, atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        gc.sinkhorn_grid_cuda(costs, 50.0, 3)
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        gc.sinkhorn_grid(torch.empty((2, 16, 24), device="meta"), 50.0, 3)
    assert gc.launches == {"kernel": 0, "plain": 1}


def test_public_entry_takes_the_grid_tier_on_cpu():
    """``sinkhorn_assignment(use_pallas=True)`` on a matrix above the
    resident tier: the grid tier's plain version, no other counter, and
    the same assignment as kernel 1's path."""
    costs = torch.from_numpy(_costs(11, 1, 800, 800, d=8))
    gc.reset_launch_counts()
    rc.reset_launch_counts()
    sinkhorn_cuda.reset_launch_counts()
    p, e = sinkhorn_assignment(costs, 50.0, 3, use_pallas=True)
    assert gc.launches == {"kernel": 0, "plain": 1}
    assert rc.launches == sinkhorn_cuda.launches == {"kernel": 0, "plain": 0}
    p_k1, e_k1 = sinkhorn_cuda.sinkhorn_assignment_kernel(costs, 50.0, 3)
    torch.testing.assert_close(p, p_k1, atol=1e-6, rtol=0)
    torch.testing.assert_close(e, e_k1, atol=1e-6, rtol=0)
