"""The resident tier of the port's Sinkhorn (TPU kernel 4's counterpart,
``ops/sinkhorn_resident_cuda.py``) on the CPU: its plain version against the
JAX kernel ``_sinkhorn_pallas_batched`` in interpret mode and against the
float64 oracle, the shapes the kernel holds, and the dispatch between the
three tiers. The same numpy inputs go to both packages.

Tolerances are the JAX package's own: P within 1e-5 and entropy within 1e-4
(tests/test_sinkhorn_pallas.py), and at lam = 500 with the +999 diagonal
the 1e-4 band of tests/test_sinkhorn_tiled.py:50, where the float32 loops
of both packages stray ~1e-5 from each other. The CUDA kernel itself runs
only on a card: tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from otgan_tpu.ops.sinkhorn_pallas import _sinkhorn_pallas_batched, pallas_supported
from otgan_tpu_torch.ops import sinkhorn_cuda, sinkhorn_grid_cuda
from otgan_tpu_torch.ops import sinkhorn_resident_cuda as rc
from otgan_tpu_torch.ops.sinkhorn import sinkhorn_assignment
from tests.reference_impl import sinkhorn_np


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


@pytest.mark.parametrize("b,n,m,lam,iters", [(2, 64, 128, 30.0, 40), (3, 100, 228, 50.0, 30)],
                         ids=["aligned", "ragged"])
def test_plain_matches_jax_resident_kernel(b, n, m, lam, iters):
    """The plain version == the Pallas kernel in interpret mode, on an
    aligned batch and on a ragged one the TPU would not take."""
    costs = _costs(n + m, b, n, m)
    p_ref, e_ref = _sinkhorn_pallas_batched(jnp.asarray(costs), lam, iters, interpret=True)
    p, e = rc.sinkhorn_resident_plain(torch.from_numpy(costs), lam, iters)
    assert p.shape == (b, n, m) and e.shape == (b,)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=1e-4)


def test_plain_diagonal_lam500_matches_jax_kernel():
    """The single-batch +999 self-match diagonal at lam = 500, 100
    iterations: finite, self-match-free, and within the JAX package's
    lam = 500 band of its kernel."""
    costs = _costs(1, 1, 128, 128) + 999.0 * np.eye(128, dtype=np.float32)
    p_ref, e_ref = _sinkhorn_pallas_batched(jnp.asarray(costs), 500.0, 100, interpret=True)
    p, e = rc.sinkhorn_resident_plain(torch.from_numpy(costs), 500.0, 100)
    assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(e).all())
    assert float(p[0].diagonal().max()) < 1e-6
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-4)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=1e-4)


@pytest.mark.parametrize("seed,n,m,lam,iters", [(3, 48, 48, 500.0, 200), (4, 40, 72, 50.0, 60)])
def test_plain_matches_float64_oracle(seed, n, m, lam, iters):
    costs = _costs(seed, 2, n, m, d=64)
    p, e = rc.sinkhorn_resident_plain(torch.from_numpy(costs), lam, iters)
    for i in range(2):
        p_ref, e_ref = sinkhorn_np(costs[i], lam, iters)
        np.testing.assert_allclose(p[i].numpy(), p_ref, atol=1e-5)
        assert abs(float(e[i]) - e_ref) < 1e-4


def test_resident_supported_cases():
    # the TPU's ceiling of 768^2 cells, with no tile alignment
    for n, m in [(128, 128), (256, 256), (768, 768), (100, 228), (1, 1), (4, 9)]:
        assert rc.resident_supported(n, m), (n, m)
    assert pallas_supported(768, 768) and not pallas_supported(100, 228)
    for n, m in [(769, 768), (1024, 1024), (0, 5), (5, 0)]:
        assert not rc.resident_supported(n, m), (n, m)
    # 768^2 cells in one row: no cluster fits the row's partials in a block
    assert not rc.resident_supported(1, 768 * 768)
    # the measured cluster rule: 8 blocks up to 256 rows, 16 above
    assert rc.resident_plan(128, 128) == (8, 16)
    assert rc.resident_plan(256, 256) == (8, 32)
    assert rc.resident_plan(512, 512) == (16, 32)
    assert rc.resident_plan(768, 768) == (16, 48)
    assert rc.resident_plan(4, 9) == (4, 1)  # never more blocks than rows
    # an explicit cluster too small for shared memory is refused
    assert rc.resident_plan(768, 768, cluster_size=4) is None
    assert rc.resident_plan(768, 768, cluster_size=11) == (11, 70)
    assert all(rc.smem_bytes(band, 768) <= rc.MAX_SMEM for band in (48, 70))
    assert rc.smem_bytes(71, 768) > rc.MAX_SMEM


def test_dispatch_on_cpu_counts_each_tier():
    """``use_pallas`` on the CPU: the resident tier's plain version up to
    the measured boundary of 256^2 cells, the grid tier's above it (800^2),
    kernel 1's plain version above the grid kernel's ceiling (2641^2 on an
    H100's limits); none with ``tol`` > 0 or without ``use_pallas``."""
    small = torch.from_numpy(_costs(5, 6, 128, 128))
    mid = torch.from_numpy(_costs(6, 1, 800, 800, d=8))[0]
    big = torch.from_numpy(_costs(6, 1, 2641, 2641, d=8))[0]
    for mod in (rc, sinkhorn_cuda, sinkhorn_grid_cuda):
        mod.reset_launch_counts()
    p, e = sinkhorn_assignment(small, 50.0, 5, use_pallas=True)
    assert p.shape == (6, 128, 128) and e.shape == (6,)
    assert rc.launches == {"kernel": 0, "plain": 1}
    assert sinkhorn_cuda.launches == sinkhorn_grid_cuda.launches == {"kernel": 0, "plain": 0}
    p, e = sinkhorn_assignment(mid, 50.0, 2, use_pallas=True)
    assert p.shape == (800, 800) and e.shape == ()
    assert rc.launches == sinkhorn_grid_cuda.launches == {"kernel": 0, "plain": 1}
    assert sinkhorn_cuda.launches == {"kernel": 0, "plain": 0}
    p, e = sinkhorn_assignment(big, 50.0, 1, use_pallas=True)
    assert p.shape == (2641, 2641) and e.shape == ()
    assert rc.launches == sinkhorn_grid_cuda.launches == sinkhorn_cuda.launches == {
        "kernel": 0, "plain": 1}
    sinkhorn_assignment(small, 50.0, 5, use_pallas=True, tol=1e-3)
    sinkhorn_assignment(small, 50.0, 5)
    assert rc.launches["plain"] == 1 and sinkhorn_cuda.launches["plain"] == 1
    # the tier and kernel 1's path agree on the same costs
    p_k1, e_k1 = sinkhorn_cuda.sinkhorn_assignment_kernel(small, 50.0, 5)
    p_res, e_res = sinkhorn_assignment(small, 50.0, 5, use_pallas=True)
    torch.testing.assert_close(p_res, p_k1, atol=1e-6, rtol=0)
    torch.testing.assert_close(e_res, e_k1, atol=1e-6, rtol=0)


def test_no_fallback_off_the_cpu():
    """The kernel's entry takes only CUDA tensors, and the wrapper raises
    for a device it has no path for, instead of taking the plain version."""
    costs = torch.from_numpy(_costs(7, 2, 16, 24))
    with pytest.raises(ValueError, match="CUDA"):
        rc.sinkhorn_resident_cuda(costs, 50.0, 3)
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        rc.sinkhorn_resident(torch.empty((2, 16, 24), device="meta"), 50.0, 3)
