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
    # 768^2 cells in one row: rows of the kernel hold at most 768 columns
    assert not rc.resident_supported(1, 768 * 768)
    assert not rc.resident_supported(64, 769) and rc.resident_supported(768, 1)
    # the measured cluster rule: 8 blocks up to 128 rows, 16 above
    plans = {(n, m): rc.resident_plan(n, m) for n, m in
             [(128, 128), (256, 256), (512, 512), (768, 768), (4, 9), (100, 228)]}
    assert {k: (p.cluster, p.band) for k, p in plans.items()} == {
        (128, 128): (8, 16), (256, 256): (16, 16), (512, 512): (16, 32), (768, 768): (16, 48),
        (4, 9): (4, 1), (100, 228): (8, 13)}  # never more blocks than rows
    # x in registers at the tier's shapes, in shared memory above
    assert [plans[k].reg_rows for k in [(128, 128), (256, 256), (100, 228), (512, 512)]] == [
        1, 1, 1, 0]
    # every block receives every column's value, except where those buffers
    # do not fit beside x (768^2: each block its slice of columns)
    assert plans[(512, 512)].push and not plans[(768, 768)].push
    # an explicit cluster too small for shared memory is refused
    assert rc.resident_plan(768, 768, cluster_size=4) is None
    assert rc.resident_plan(768, 768, cluster_size=13) is None
    assert rc.resident_plan(768, 768, cluster_size=14) == rc.ResidentPlan(
        14, 55, 6, 0, False, rc.smem_bytes(55, 768, 14, 0, False))
    assert rc.smem_bytes(48, 768, 16, 0, False) <= rc.MAX_SMEM
    assert rc.smem_bytes(48, 768, 16, 0, True) > rc.MAX_SMEM
    assert rc.smem_bytes(59, 768, 13, 0, False) > rc.MAX_SMEM


def test_dispatch_on_cpu_counts_each_tier():
    """``use_pallas`` on the CPU: the resident tier's plain version up to
    the measured boundary of 512^2 cells, the grid tier's above it (800^2),
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


# ---- the kernel's plan and its order of work (csrc/sinkhorn_resident.cu) ----

_SIDES = [1, 2, 5, 16, 17, 31, 64, 100, 127, 128, 129, 228, 255, 256, 300, 384, 500, 512, 640,
          767, 768]


@pytest.mark.parametrize("n", _SIDES)
def test_plan_at_every_supported_shape(n):
    """Every (n, m) of these sides that ``resident_supported`` takes has a
    plan with every row in one block, x in registers (at most 16 cells a
    thread, 1-2 quads a lane) or in shared memory, and a block's shared
    memory under 232,448 B; so does every cluster size that fits. A band
    of ceil(n / cs) rows may leave the last blocks with none (129 rows on
    16 blocks of 9), which the kernel masks."""
    for m in _SIDES:
        plan = rc.resident_plan(n, m)
        assert (plan is not None) == rc.resident_supported(n, m) == (
            n * m <= rc.MAX_CELLS and m <= 768), (n, m)
        if plan is None:
            continue
        sizes = [plan] + [p for p in (rc.resident_plan(n, m, cs)
                                      for cs in range(1, rc.MAX_CLUSTER + 1)) if p]
        for p in sizes:
            assert p.band == -(-n // p.cluster) and p.cluster * p.band >= n
            assert p.quads == -(-m // 128) <= rc.MAX_QUADS
            rows = -(-p.band // rc.WARPS)
            if p.reg_rows:
                assert p.reg_rows == rows and 4 * p.quads * rows <= rc.REG_CELLS
            else:
                assert p.quads > 2 or 4 * p.quads * rows > rc.REG_CELLS
            assert p.smem == rc.smem_bytes(p.band, m, p.cluster, p.reg_rows, p.push)
            assert p.smem <= rc.MAX_SMEM
            assert p.push == (rc.smem_bytes(p.band, m, p.cluster, p.reg_rows, True)
                              <= rc.MAX_SMEM)
        assert plan.cluster == max(
            min(p.cluster for p in sizes),
            min(n, rc.CLUSTER_SMALL if n <= rc.SMALL_ROWS else rc.CLUSTER_LARGE))


def _model_resident(costs, lam, iters, cluster=None):
    """The kernel's float32 order of work, in torch: x = -lam C shifted by
    its row max; an iteration's row potentials, then per block and warp
    (rows w, w + 16, ... of the band) the column (max, sum) over the warp's
    rows: all at once with x in registers, row by row with the online
    rescale with x in shared memory, where a warp's value is a log-sum-exp;
    the warps' values folded into the block's (a log-sum-exp in shared
    memory), the blocks' into v, in order, idle blocks and warps without
    rows adding nothing. Then P and the mean row entropy."""
    b, n, m = costs.shape
    plan = rc.resident_plan(n, m, cluster)
    cs, band, warps = plan.cluster, plan.band, rc.WARPS
    inf = float("inf")
    c = torch.from_numpy(costs)
    x = -lam * c
    x = x - x.amax(dim=-1, keepdim=True)
    rpw = -(-band // warps)  # rows a warp
    pad = cs * rpw * warps
    v = torch.zeros((b, m))
    for _ in range(iters):
        y = x + v[:, None, :]
        mx = y.amax(dim=-1, keepdim=True)
        u = -(mx + torch.log(torch.exp(y - mx).sum(dim=-1, keepdim=True)))
        z = torch.full((b, pad, m), -inf)
        for q in range(cs):  # block q's band, rows padded to rpw x 16 (i major, warp minor)
            rows = z[:, q * rpw * warps:q * rpw * warps + min(band, max(0, n - q * band))]
            rows.copy_((x + u)[:, q * band:q * band + rows.shape[1]])
        z = z.reshape(b, cs, rpw, warps, m)
        if plan.reg_rows:
            wm = z.amax(dim=2)
            ws = torch.exp(z - torch.where(wm == -inf, 0.0, wm)[:, :, None]).sum(dim=2)
        else:
            wm = torch.full((b, cs, warps, m), -inf)
            ws = torch.zeros((b, cs, warps, m))
            for i in range(rpw):
                zi = z[:, :, i]
                nm = torch.maximum(wm, zi)
                t = torch.exp(torch.minimum(wm, zi) - nm)
                ws = torch.where(zi > wm, ws * t + 1.0, ws + t)
                wm = nm
            wm, ws = wm + torch.log(ws), torch.ones_like(ws)  # log-sum-exp values
            ws = torch.where(wm == -inf, 0.0, ws)
        bm = wm.amax(dim=2)
        bs = (ws * torch.exp(wm - torch.where(bm == -inf, 0.0, bm)[:, :, None])).sum(dim=2)
        if not plan.reg_rows:
            bm, bs = bm + torch.log(bs), torch.where(bs > 0, 1.0, 0.0)
        vm = bm.amax(dim=1)
        vs = (bs * torch.exp(bm - vm[:, None])).sum(dim=1)
        v = -(vm + torch.log(vs))
    y = x + v[:, None, :]
    p = torch.softmax(y, dim=-1)
    ent = -(p * torch.log_softmax(y, dim=-1)).sum(-1).mean(-1)
    return p, ent, plan


@pytest.mark.parametrize("b,n,m,lam,iters,cluster", [
    (2, 64, 128, 50.0, 40, None), (3, 100, 228, 50.0, 30, None), (2, 5, 9, 50.0, 20, 8),
    (2, 100, 130, 50.0, 30, 1), (2, 40, 72, 50.0, 30, 3), (1, 128, 128, 500.0, 150, None)],
    ids=["registers", "ragged", "idle-blocks", "shared-memory", "three-blocks", "lam500"])
def test_kernel_order_matches_plain_pallas_and_oracle(b, n, m, lam, iters, cluster):
    """The model of the kernel's order against the plain version (P within
    1e-5, entropy within 1e-4), the Pallas kernel in interpret mode (the
    same, and the 1e-4 band in P at lam 500), and the float64 oracle."""
    costs = _costs(n * m + b, b, n, m)
    p, e, plan = _model_resident(costs, lam, iters, cluster)
    if cluster == 8:
        assert plan.cluster * plan.band - n >= plan.band  # a block owns no row
    assert (plan.reg_rows > 0) == (cluster != 1)
    p_ref, e_ref = rc.sinkhorn_resident_plain(torch.from_numpy(costs), lam, iters)
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)
    p_j, e_j = _sinkhorn_pallas_batched(jnp.asarray(costs), lam, iters, interpret=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), atol=1e-4 if lam == 500.0 else 1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-4)
    for i in range(b):
        p_o, e_o = sinkhorn_np(costs[i], lam, iters)
        np.testing.assert_allclose(p[i].numpy(), p_o, atol=1e-5)
        assert abs(float(e[i]) - e_o) < 1e-4
