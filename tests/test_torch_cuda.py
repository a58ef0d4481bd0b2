"""The hand-written CUDA Sinkhorn kernels on a card (the column-potential
loop, the row-sharded matcher's local step, the resident whole-loop kernel
and the grid whole-loop kernel), against their plain PyTorch versions on the
same logits, the engine's phase marks (``csrc/phase_marks.cu``) in an
eager, a captured and a profiled cycle, the DCGAN's layer-boundary
kernels (``csrc/layer_boundary.cu``) against the plain chain, and the
DenseNet's slab kernels (``csrc/dense_boundary.cu``) against their plain
versions and, in both nets and an engine step, against the layers' chain,
bit for bit. Every test here needs an NVIDIA GPU and
``nvcc`` (a CUDA kernel has no CPU mode) and skips without one. This file
imports no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: P within 1e-5 and entropy within 1e-4, at lam = 500 on square
matrices. The layer boundaries: bit for bit, but for the bias gradient,
whose float32 terms each side sums over all rows in its own order (the
kernel in per-block partials, PyTorch's reduction in a tree): within 1e-5
of the sum of the terms' magnitudes. Rectangular matrices have no fixed point with unit marginals:
their potentials drift by log(M/N) per iteration, to |v| ~ 400 after 500
iterations, where float32 spacing is 3e-5; those shapes run 100 iterations
at a small aspect ratio.
"""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import BOUNDARIES  # the DCGAN's boundaries at the main path's widths
from otgan_tpu_torch.nn import layer_boundary as lb
from otgan_tpu_torch.ops import (
    sinkhorn_cuda,
    sinkhorn_grid_cuda,
    sinkhorn_resident_cuda,
    sinkhorn_step_cuda,
)
from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy, sinkhorn_assignment


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _costs(b, n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, m, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    return torch.from_numpy(1.0 - a @ c.transpose(0, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,m,d,iters",
    [(6, 128, 128, 32, 500), (6, 100, 100, 32, 500), (2, 333, 300, 32, 100),
     (6, 100, 228, 4096, 100), (1, 17, 40, 64, 50)],
)
def test_kernel_matches_plain(cuda_device, b, n, m, d, iters):
    x = sinkhorn_cuda.scaled_logits(_costs(b, n, m, d).to(cuda_device), 500.0)
    before = sinkhorn_cuda.launches["kernel"]
    v = sinkhorn_cuda.col_potential(x, iters)
    torch.cuda.synchronize()
    assert sinkhorn_cuda.launches["kernel"] == before + 1
    v_ref = sinkhorn_cuda.col_potential_plain(x, iters)
    p, e = assignment_and_entropy(x + v[:, None, :])
    p_ref, e_ref = assignment_and_entropy(x + v_ref[:, None, :])
    assert bool(torch.isfinite(p).all())
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_zero_iterations_and_bad_inputs(cuda_device):
    x = torch.randn(2, 20, 30, device=cuda_device)
    assert float(sinkhorn_cuda.col_potential(x, 0).abs().max()) == 0.0
    with pytest.raises(ValueError):
        sinkhorn_cuda.col_potential_cuda(x.transpose(1, 2), 3)  # not contiguous
    with pytest.raises(ValueError):
        sinkhorn_cuda.col_potential_cuda(x.double(), 3)


@pytest.mark.cuda
def test_public_entry_launches_kernel_not_plain(cuda_device):
    """The resident tier up to 512^2 cells, the grid tier above it while the
    card's shared memory holds the matrix, kernel 1 above that; no plain
    version on the card."""
    for mod in (sinkhorn_cuda, sinkhorn_resident_cuda, sinkhorn_grid_cuda):
        mod.reset_launch_counts()
    p, e = sinkhorn_assignment(_costs(6, 64, 64, 32).to(cuda_device), 500.0, 50,
                               use_pallas=True)
    assert sinkhorn_resident_cuda.launches == {"kernel": 1, "plain": 0}
    assert sinkhorn_cuda.launches == sinkhorn_grid_cuda.launches == {"kernel": 0, "plain": 0}
    assert p.shape == (6, 64, 64) and e.shape == (6,)
    torch.testing.assert_close(p.sum(-1), torch.ones(6, 64, device=cuda_device),
                               atol=1e-5, rtol=0)
    p, e = sinkhorn_assignment(_costs(1, 800, 800, 32).to(cuda_device)[0], 500.0, 50,
                               use_pallas=True)
    assert sinkhorn_grid_cuda.launches == {"kernel": 1, "plain": 0}
    assert sinkhorn_cuda.launches == {"kernel": 0, "plain": 0}
    assert p.shape == (800, 800) and e.shape == ()
    steps = dict(sinkhorn_step_cuda.launches)
    p, e = sinkhorn_assignment(_costs(1, 2700, 2700, 32).to(cuda_device)[0], 500.0, 20,
                               use_pallas=True)
    assert sinkhorn_cuda.launches == {"kernel": 1, "plain": 0}
    assert sinkhorn_step_cuda.launches == steps  # kernel 1 counts its own launches
    assert sinkhorn_grid_cuda.launches == sinkhorn_resident_cuda.launches == {
        "kernel": 1, "plain": 0}
    assert p.shape == (2700, 2700) and e.shape == ()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 313, 2500), (6, 100, 228), (2, 37, 50), (1, 1000, 4000),
                                   (6, 500, 2000), (2, 8, 40000)])
@pytest.mark.parametrize("mode", ["fused", "stream"])
def test_local_step_kernels_match_plain(cuda_device, shape, mode):
    """Both tiers at every shape (the tier rule picks one; either must be
    right), on the inputs of tests/test_torch_sinkhorn_step.py (x in [-50,
    0], v in [-5, 5], so |m| is a few units and float32 spacing stays under
    5e-7): m within 1e-6 and s within 1e-5 relative of the plain version.
    (6, 500, 2000) is one rank's block at batch 4000 on 4 GPUs; (2, 8,
    40000), the fused tier's widest kind of block, takes the direct plan."""
    rng = np.random.default_rng(0)
    b, n, m = shape
    x = torch.from_numpy(rng.uniform(-50, 0, shape).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.uniform(-5, 5, (b, m)).astype(np.float32)).to(cuda_device)
    before = dict(sinkhorn_step_cuda.launches)
    m_k, s_k = sinkhorn_step_cuda.make_local_step(x, mode=mode)(v)
    torch.cuda.synchronize()
    assert sinkhorn_step_cuda.launches[mode] == before[mode] + 1
    assert sinkhorn_step_cuda.launches["plain"] == before["plain"]
    m_ref, s_ref = sinkhorn_step_cuda.local_step_plain(x, v)
    torch.testing.assert_close(m_k, m_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(s_k, s_ref, atol=0, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_ctas", [((6, 4000, 4000), None), ((6, 1000, 4000), 4),
                                          ((6, 313, 2500), 3), ((2, 37, 50), 1),
                                          ((2, 37, 50), 64), ((6, 100, 228), 60)])
def test_stream_blocks_walking_several_panels_match_plain(cuda_device, shape, n_ctas):
    """The stream tier where each block walks several ring stages, so the
    online rescale of its column accumulators runs and the ring wraps:
    (6, 4000, 4000) on the default plan (182 rows a block on a 132-SM
    card), the others on a few blocks (up to 334 rows each, the last stage
    ragged); and more blocks than rows ((2, 37, 50) on 64, (6, 100, 228) on
    60), so some blocks own no rows and fold only. Inputs and limits as
    above."""
    rng = np.random.default_rng(1)
    b, n, m = shape
    x = torch.from_numpy(rng.uniform(-50, 0, shape).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.uniform(-5, 5, (b, m)).astype(np.float32)).to(cuda_device)
    m_k, s_k = sinkhorn_step_cuda.make_local_step(x, mode="stream", n_ctas=n_ctas)(v)
    m_ref, s_ref = sinkhorn_step_cuda.local_step_plain(x, v)
    torch.testing.assert_close(m_k, m_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(s_k, s_ref, atol=0, rtol=1e-5)


@pytest.mark.cuda
def test_local_step_is_deterministic(cuda_device):
    """The fold runs in block order, with no float atomics: two calls give
    bitwise-equal (m, s)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-50, 0, (6, 1000, 4000)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.uniform(-5, 5, (6, 4000)).astype(np.float32)).to(cuda_device)
    step = sinkhorn_step_cuda.make_local_step(x)
    m1, s1 = (t.clone() for t in step(v))
    m2, s2 = step(v)
    assert torch.equal(m1, m2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 500, 2000), (6, 1000, 4000)])
def test_local_step_is_one_device_kernel(cuda_device, shape):
    """Under torch.profiler one step of either tier's block launches exactly
    one device kernel: the fold runs in the same launch. A profile whose
    trace holds no device event at all (the card's trace came back empty,
    which a later profile in one process sometimes gives) is taken again, at
    most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(shape, device=cuda_device) * -50.0
    v = torch.zeros(shape[0], shape[2], device=cuda_device)
    step = sinkhorn_step_cuda.make_local_step(x)
    step(v)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(v)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1, [e.name for e in kernels]
    assert "local_step" in kernels[0].name


@pytest.mark.cuda
def test_local_step_bad_inputs_raise(cuda_device):
    x = torch.randn(2, 20, 30, device=cuda_device)
    with pytest.raises(ValueError):
        sinkhorn_step_cuda.make_local_step(x.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        sinkhorn_step_cuda.make_local_step(x.double())
    with pytest.raises(ValueError):
        sinkhorn_step_cuda.make_local_step(x)(torch.zeros(2, 31, device=cuda_device))
    with pytest.raises(ValueError, match="tier"):
        sinkhorn_step_cuda.make_local_step(x, mode="xla")
    with pytest.raises(ValueError, match="stream tier"):
        sinkhorn_step_cuda.make_local_step(x, mode="fused", n_ctas=2)


def _resident_costs(name, device):
    """chip_smoke.py's resident shapes from numpy costs: the DCGAN at batch
    256, the toy at batch 512, the 768^2 point, a ragged one, and the
    single-batch +999 diagonal."""
    shapes = {"dcgan_b256": (6, 128, 128), "toy_b512": (6, 256, 256), "bench_768": (1, 768, 768),
              "ragged": (6, 100, 228), "single_b128": (3, 128, 128)}
    b, n, m = shapes[name]
    c = _costs(b, n, m, 64)
    if name == "single_b128":
        c[:2] += 999.0 * torch.eye(n)
    return c.to(device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dcgan_b256", "toy_b512", "bench_768", "ragged", "single_b128"])
def test_resident_kernel_matches_plain(cuda_device, name):
    """lam = 500, 500 iterations: P within 1e-5 and entropy within 1e-4 of
    the plain version and of kernel 1's path; the +999 diagonal stays 0."""
    costs = _resident_costs(name, cuda_device)
    before = dict(sinkhorn_resident_cuda.launches)
    p, e = sinkhorn_resident_cuda.sinkhorn_resident(costs, 500.0, 500)
    torch.cuda.synchronize()
    assert sinkhorn_resident_cuda.launches == {"kernel": before["kernel"] + 1,
                                               "plain": before["plain"]}
    p_ref, e_ref = sinkhorn_resident_cuda.sinkhorn_resident_plain(costs, 500.0, 500)
    p_k1, e_k1 = sinkhorn_cuda.sinkhorn_assignment_kernel(costs, 500.0, 500)
    assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(e).all())
    for want_p, want_e in ((p_ref, e_ref), (p_k1, e_k1)):
        torch.testing.assert_close(p, want_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(e, want_e, atol=1e-4, rtol=0)
    if name == "single_b128":
        assert float(torch.diagonal(p[:2], dim1=1, dim2=2).max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", list(range(1, 17)))
def test_resident_every_cluster_size(cuda_device, cluster):
    """Any cluster size gives the same assignment: bands of 7 to 100 rows,
    x in shared memory (up to 3 blocks) or in registers, blocks that hold
    no rows (16 blocks for 100 rows of 7) included."""
    costs = _costs(2, 100, 130, 32).to(cuda_device)
    p, e = sinkhorn_resident_cuda.sinkhorn_resident_cuda(costs, 50.0, 200, cluster_size=cluster)
    p_ref, e_ref = sinkhorn_resident_cuda.sinkhorn_resident_plain(costs, 50.0, 200)
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)
    p0, e0 = sinkhorn_resident_cuda.sinkhorn_resident_cuda(costs, 50.0, 0, cluster_size=cluster)
    torch.testing.assert_close(p0, torch.softmax(-50.0 * costs, dim=-1), atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_resident_bad_inputs_raise(cuda_device):
    x = torch.rand(2, 20, 30, device=cuda_device)
    with pytest.raises(ValueError):
        sinkhorn_resident_cuda.sinkhorn_resident_cuda(x.transpose(1, 2), 50.0, 3)
    with pytest.raises(ValueError):
        sinkhorn_resident_cuda.sinkhorn_resident_cuda(x.double(), 50.0, 3)
    with pytest.raises(ValueError, match="cannot hold"):
        sinkhorn_resident_cuda.sinkhorn_resident_cuda(torch.rand(1, 800, 800, device=cuda_device),
                                                      50.0, 3)
    with pytest.raises(ValueError, match="cannot hold"):
        sinkhorn_resident_cuda.sinkhorn_resident_cuda(
            torch.rand(1, 768, 768, device=cuda_device), 50.0, 3, cluster_size=4)


def _grid_costs(shape, device):
    """Square costs from 64-wide unit features; ``"+999"`` puts the
    single-batch self-match diagonal on the first two of three matrices."""
    b, n, m = shape[:3]
    c = _costs(b, n, m, 64, seed=n + m)
    if len(shape) > 3:
        c[:2] += 999.0 * torch.eye(n)
    return c.to(device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [8, 33, "all"])
@pytest.mark.parametrize("shape", [(6, 1024, 1024), (3, 1000, 1900), (3, 1200, 1200, "+999"),
                                   (6, 400, 500)])
def test_grid_kernel_matches_plain(cuda_device, shape, blocks):
    """lam = 500, 500 iterations on the squares (100 on the rectangle, whose
    potentials drift): P within 1e-5 and entropy within 1e-4 of the plain
    version, on a forced block count per matrix (8, 33, one per SM), so
    bands run from a few rows to 128 and the fold crosses from 8 to 132
    blocks; diag(P) of the +999 matrices stays 0. A block count whose bands
    do not fit is refused with a ValueError."""
    costs = _grid_costs(shape, cuda_device)
    b, n, m = costs.shape
    sms, smem = sinkhorn_grid_cuda.card_limits(cuda_device)
    n_blocks = sms if blocks == "all" else blocks
    iters = 500 if n == m else 100
    if sinkhorn_grid_cuda.grid_plan(n, m, sms, smem, n_blocks, batch=b) is None:
        with pytest.raises(ValueError, match="cannot hold"):
            sinkhorn_grid_cuda.sinkhorn_grid_cuda(costs, 500.0, iters, blocks=n_blocks)
        return
    before = dict(sinkhorn_grid_cuda.launches)
    p, e = sinkhorn_grid_cuda.sinkhorn_grid_cuda(costs, 500.0, iters, blocks=n_blocks)
    torch.cuda.synchronize()
    assert sinkhorn_grid_cuda.launches == {"kernel": before["kernel"] + 1,
                                           "plain": before["plain"]}
    p_ref, e_ref = sinkhorn_resident_cuda.sinkhorn_resident_plain(costs, 500.0, iters)
    assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(e).all())
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)
    if len(shape) > 3:
        assert float(torch.diagonal(p[:2], dim1=1, dim2=2).max()) < 1e-6


@pytest.mark.cuda
def test_grid_zero_iterations_and_ragged_width(cuda_device):
    """No iteration: P is the row softmax of -lam C. A width that is not a
    multiple of 4 takes the scalar load and the -inf padded rows."""
    costs = _costs(2, 300, 501, 32).to(cuda_device)
    p0, _ = sinkhorn_grid_cuda.sinkhorn_grid_cuda(costs, 50.0, 0)
    torch.testing.assert_close(p0, torch.softmax(-50.0 * costs, dim=-1), atol=1e-6, rtol=0)
    p, e = sinkhorn_grid_cuda.sinkhorn_grid_cuda(costs, 50.0, 100)
    p_ref, e_ref = sinkhorn_resident_cuda.sinkhorn_resident_plain(costs, 50.0, 100)
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_grid_bad_inputs_raise(cuda_device):
    x = torch.rand(2, 20, 30, device=cuda_device)
    with pytest.raises(ValueError):
        sinkhorn_grid_cuda.sinkhorn_grid_cuda(x.transpose(1, 2), 50.0, 3)
    with pytest.raises(ValueError):
        sinkhorn_grid_cuda.sinkhorn_grid_cuda(x.double(), 50.0, 3)
    with pytest.raises(ValueError, match="cannot hold"):
        sinkhorn_grid_cuda.sinkhorn_grid_cuda(torch.rand(1, 4000, 4000, device=cuda_device),
                                              50.0, 3)
    with pytest.raises(ValueError, match="cannot hold"):
        sinkhorn_grid_cuda.sinkhorn_grid_cuda(x, 50.0, 3, blocks=100000)


@pytest.mark.cuda
def test_grid_public_entry_at_batch_5000(cuda_device):
    """The main path's 6 x 2500^2 through the public entry: the grid tier,
    not kernel 1, and kernel 1's assignment within 1e-5."""
    costs = _costs(6, 2500, 2500, 64).to(cuda_device)
    for mod in (sinkhorn_cuda, sinkhorn_resident_cuda, sinkhorn_grid_cuda):
        mod.reset_launch_counts()
    p, e = sinkhorn_assignment(costs, 500.0, 100, use_pallas=True)
    torch.cuda.synchronize()
    assert sinkhorn_grid_cuda.launches == {"kernel": 1, "plain": 0}
    assert sinkhorn_cuda.launches == sinkhorn_resident_cuda.launches == {"kernel": 0, "plain": 0}
    p_k1, e_k1 = sinkhorn_cuda.sinkhorn_assignment_kernel(costs, 500.0, 100)
    torch.testing.assert_close(p, p_k1, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_k1, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 128, 128), (6, 256, 256), (6, 100, 228), (1, 768, 768)])
def test_resident_tier_shapes_every_cluster_bitwise(cuda_device, shape):
    """At the tier's shapes and 768^2, on every cluster size that fits: lam
    500, 500 iterations (100 on the rectangle, whose potentials drift), P
    within 1e-5 and entropy within 1e-4 of the plain version, and two calls
    bitwise equal (every fold in a fixed order)."""
    b, n, m = shape
    iters = 500 if n == m else 100
    costs = _costs(b, n, m, 64, seed=3).to(cuda_device)
    p_ref, e_ref = sinkhorn_resident_cuda.sinkhorn_resident_plain(costs, 500.0, iters)
    for cs in range(1, 17):
        if sinkhorn_resident_cuda.resident_plan(n, m, cs) is None:
            continue
        p, e = sinkhorn_resident_cuda.sinkhorn_resident_cuda(costs, 500.0, iters, cluster_size=cs)
        p2, e2 = sinkhorn_resident_cuda.sinkhorn_resident_cuda(costs, 500.0, iters,
                                                               cluster_size=cs)
        torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)
        assert torch.equal(p, p2) and torch.equal(e, e2), cs


@pytest.mark.cuda
def test_resident_barrier_loop(cuda_device):
    """The cluster barrier alone runs on the planned clusters and refuses a
    cluster the card has no size for."""
    sinkhorn_resident_cuda.barrier_loop_cuda(8, 6, 500)
    sinkhorn_resident_cuda.barrier_loop_cuda(16, 6, 500)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="barrier loop failed"):
        sinkhorn_resident_cuda.barrier_loop_cuda(17, 6, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,iters", [((6, 4000, 4000), 20), ((2, 2700, 2650), 30)])
def test_col_potential_above_the_ceiling_matches_plain(cuda_device, shape, iters):
    """Kernel 1 above the grid kernel's ceiling (the local-step kernel's v
    mode) on the single-device matcher's shape at batch 8000 and on a
    ragged one: lam 500, P within 1e-5 and entropy within 1e-4 of the plain
    version, v bitwise equal across two calls, one launch counted, no
    local-step tier counted."""
    from otgan_tpu_torch.ops.sinkhorn import kernel_tier

    b, n, m = shape
    assert kernel_tier(n, m, sinkhorn_grid_cuda.card_limits(cuda_device)) == "tiled"
    x = sinkhorn_cuda.scaled_logits(_costs(b, n, m, 64, seed=4).to(cuda_device), 500.0)
    before, steps = dict(sinkhorn_cuda.launches), dict(sinkhorn_step_cuda.launches)
    v = sinkhorn_cuda.col_potential(x, iters).clone()
    torch.cuda.synchronize()
    assert sinkhorn_cuda.launches == {"kernel": before["kernel"] + 1, "plain": before["plain"]}
    assert sinkhorn_step_cuda.launches == steps
    assert torch.equal(v, sinkhorn_cuda.col_potential(x, iters))
    v_ref = sinkhorn_cuda.col_potential_plain(x, iters)
    p, e = assignment_and_entropy(x + v[:, None, :])
    p_ref, e_ref = assignment_and_entropy(x + v_ref[:, None, :])
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_col_potential_is_one_device_kernel_an_iteration(cuda_device):
    """Under torch.profiler a 3-iteration call launches exactly 3 device
    kernels, all the local-step kernel (no memset, no combine launch). A
    profile whose trace holds no device event at all is taken again, at
    most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(6, 1000, 1000, device=cuda_device) * -50.0
    sinkhorn_cuda.col_potential_cuda(x, 3)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sinkhorn_cuda.col_potential_cuda(x, 3)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 3 and all("local_step" in k for k in kernels), kernels


@pytest.mark.cuda
def test_inception_scoring_on_card_matches_cpu(cuda_device):
    """The eval path on the card (float32, TF32 held off by the scorers even
    when a bf16 run left it on) against the same scorers on the CPU: pool
    features within 1e-4 of the largest value, the one-pass IS within 1e-5,
    and FID statistics within 1e-3; no Sinkhorn kernel launches."""
    from otgan_tpu_torch.eval import fid as fid_mod
    from otgan_tpu_torch.eval.inception_net import InceptionV3
    from otgan_tpu_torch.eval.random_weights import scaled_params

    tree = scaled_params(seed=2024)
    nets = {d: InceptionV3.from_params(tree, "tf2015", device=d) for d in ("cpu", cuda_device)}
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    batches = [rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    keep = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        feats = {d: fid_mod.pool_features(imgs, net=n, batch=2) for d, n in nets.items()}
        combined = {d: fid_mod.combined_eval_from_sampler(
            lambda i, _d=d: torch.from_numpy(batches[i]).to(_d), 9, splits=3, net=n, batch=4)
            for d, n in nets.items()}
        assert torch.backends.cudnn.allow_tf32  # the caller's setting comes back
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep
    f_cpu, f_gpu = feats["cpu"], feats[cuda_device]
    assert np.abs(f_gpu - f_cpu).max() <= 1e-4 * np.abs(f_cpu).max()
    (m_c, _), (mu_c, sig_c) = combined["cpu"]
    (m_g, _), (mu_g, sig_g) = combined[cuda_device]
    np.testing.assert_allclose(m_g, m_c, rtol=1e-5)
    assert np.abs(mu_g - mu_c).max() <= 1e-4 * np.abs(mu_c).max()
    assert np.abs(sig_g - sig_c).max() <= 1e-3 * np.abs(sig_c).max()


@pytest.mark.cuda
def test_jax_format_checkpoint_restores_on_card(cuda_device, tmp_path):
    """A toy state on the card written as the JAX package's leaves
    (``convert.jax_leaves``) restores into a fresh state on the card equal
    to it, bit for bit, the generator seeded from the key."""
    from otgan_tpu_torch import convert
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.data.toy import sample_8gaussians
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.utils import checkpoint as ckpt

    eng = Engine(TrainConfig(model="toy_mlp", batch_size=32, sinkhorn_lambda=50.0,
                             nr_sinkhorn_iter=10, nr_gen_per_disc=1), device=cuda_device)
    x = sample_8gaussians(np.random.default_rng(0), 32)
    state, _ = eng.init_state(0, x)
    state, _ = eng.cycle(state, [x, x, x])
    leaves = convert.jax_leaves(state, rng_key=(5, 6))
    np.savez(tmp_path / "otgan_state-4.npz", **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    fresh, _ = eng.init_state(1, x)
    ckpt.restore_checkpoint(str(tmp_path / "otgan_state-4.npz"), fresh)
    for (k, a), (_, b) in zip(ckpt._named_tensors(state), ckpt._named_tensors(fresh)):
        assert b.device.type == "cuda" and torch.equal(a, b), k
    assert fresh.step == state.step == 3
    want = torch.Generator(device=cuda_device).manual_seed(convert.seed_from_jax_key([5, 6]))
    assert torch.equal(fresh.rng.get_state(), want.get_state())


@pytest.mark.cuda
def test_host_to_device_places_batches_on_a_side_stream(cuda_device):
    """The trainer's prefetch placement (``train.HostToDevice``) on a worker
    thread: every batch arrives whole on the card (uint8 and bfloat16, more
    batches than pinned buffers, so each buffer is refilled), and the
    consuming stream sees it after ``wait``."""
    import threading

    from otgan_tpu_torch.train import HostToDevice

    place = HostToDevice(cuda_device)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (64, 32, 32, 3)).astype(np.uint8) for _ in range(7)]
    batches.append(torch.from_numpy(rng.standard_normal((64, 32, 32, 3)).astype(np.float32))
                   .to(torch.bfloat16))
    placed = []
    worker = threading.Thread(target=lambda: placed.extend(place(b) for b in batches))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and len(placed) == len(batches)
    for host, p in zip(batches, placed):
        x = p.wait()
        assert x.is_cuda and x.device.index == torch.cuda.current_device()
        want = torch.from_numpy(host) if isinstance(host, np.ndarray) else host
        assert torch.equal(x.cpu(), want)


def _toy_engine(device, cycle_graphs: bool):
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.data.toy import sample_8gaussians
    from otgan_tpu_torch.engine import Engine

    eng = Engine(TrainConfig(model="toy_mlp", batch_size=64, sinkhorn_lambda=50.0,
                             nr_sinkhorn_iter=10, nr_gen_per_disc=2), device)
    eng.cycle_graphs = cycle_graphs
    rng = np.random.default_rng(0)
    state, _ = eng.init_state(1, sample_8gaussians(rng, 64))
    xs = [torch.from_numpy(sample_8gaussians(rng, 64)).to(device) for _ in range(14)]
    return eng, state, xs


@pytest.mark.cuda
def test_fused_cycle_replay_equals_eager(cuda_device):
    """The toy at 2:1 in calls of 3, 3, 2, 3 and 3 batches: the eager
    warm-up, then graphs of three schedules (a full cycle from a critic
    step, a leftover of 2, a full cycle from a generator step, replayed
    once), all in the first graph's pool, against the same calls run
    eagerly: every step's dist and entropy, the parameters, Adam's moments
    and step count, the generator's state and the resident kernel's
    launches, bit for bit."""
    from otgan_tpu_torch.utils.checkpoint import _named_tensors

    out = []
    for graphs in (True, False):
        eng, state, xs = _toy_engine(cuda_device, graphs)
        sinkhorn_resident_cuda.reset_launch_counts()
        mets, i = [], 0
        for n in (3, 3, 2, 3, 3):
            state, m = eng.cycle_step(state, xs[i:i + n])
            mets, i = mets + m, i + n
        torch.cuda.synchronize()
        assert len(eng._graphs) == (3 if graphs else 0)
        assert len({g.pool for g in eng._graphs.values()}) == (1 if graphs else 0)
        out.append((state, mets, dict(sinkhorn_resident_cuda.launches)))
    (a, ma, la), (b, mb, lb) = out
    assert a.step == b.step == 14 and la == lb == {"kernel": 14, "plain": 0}
    for x, y in zip(ma, mb):
        assert torch.equal(x.dist, y.dist) and torch.equal(x.entropy, y.entropy)
    for (k, x), (_, y) in zip(_named_tensors(a), _named_tensors(b)):
        assert torch.equal(x, y), k
    assert torch.equal(a.gen_opt.t, b.gen_opt.t) and torch.equal(a.disc_opt.t, b.disc_opt.t)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.cuda
def test_capture_out_of_memory_switches_to_eager(cuda_device):
    """The toy at 2:1 in calls of 3, 3, 2 and 3 batches, fused and not:
    the eager warm-up, then with the card's free memory held the first
    capture runs out of memory (a graph that already holds a pool may find
    room in it: ``chip_smoke.py`` phase 15 drops one at batch 8000). The
    held memory is let go at the switch; from then on the engine runs
    eagerly, no segment of a private pool is left, the stream is not left
    capturing, and every step, the state and the generator equal the
    unfused engine's bit for bit."""
    from chip_smoke import fill_device_memory
    from otgan_tpu_torch import cycle_graph
    from otgan_tpu_torch.utils.checkpoint import _named_tensors

    (a, sa, xs), (b, sb, _) = _toy_engine(cuda_device, True), _toy_engine(cuda_device, False)
    held, seen = [], {}
    run_eagerly = a._run_eagerly

    def switch(*args):
        held.clear()
        run_eagerly(*args)
        seen.update(capturing=torch.cuda.is_current_stream_capturing(),
                    stream=torch.cuda.current_stream() == torch.cuda.default_stream(),
                    pools=sum(tuple(s.get("segment_pool_id", (0, 0))) != (0, 0)
                              for s in torch.cuda.memory_snapshot()),
                    half_registered=len(cycle_graph._half_registered))

    a._run_eagerly = switch
    mets, i = ([], []), 0
    try:
        for n in (3, 3, 2, 3):
            if i == 3:  # the first capture: its new pool finds no room for a segment
                assert not a._graphs
                held += fill_device_memory(0)
            sa, m = a.cycle_step(sa, xs[i:i + n])
            mets[0].extend(m)
            sb, m = b.cycle_step(sb, xs[i:i + n])
            mets[1].extend(m)
            i += n
    finally:
        held.clear()  # a failure here must not starve the next test
    torch.cuda.synchronize()
    assert a.cycle_graphs is False and a.fused_cycle is False and a._graphs == {}
    assert a._graph_pool is None and "ran out of device memory" in a.fused_cycle_reason
    # a graph left half-registered with a generator would abort the process
    # when freed: the switch completes the registration
    assert seen == {"capturing": False, "stream": True, "pools": 0, "half_registered": 0}
    assert sa.step == sb.step == 11
    for x, y in zip(*mets):
        assert torch.equal(x.dist, y.dist) and torch.equal(x.entropy, y.entropy)
    for (k, x), (_, y) in zip(_named_tensors(sa), _named_tensors(sb)):
        assert torch.equal(x, y), k
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    """A host sync inside the cycle cannot be captured: ``cycle_step``
    raises with the CUDA error, runs nothing eagerly in its place, and
    leaves the step count and the counters as they were."""
    eng, state, xs = _toy_engine(cuda_device, True)
    state, _ = eng.cycle_step(state, xs[:3])  # the eager warm-up
    step, launches = state.step, dict(sinkhorn_resident_cuda.launches)
    cycle = eng.cycle

    def syncing_cycle(st, batches):
        st, mets = cycle(st, batches)
        float(mets[0].dist)  # a readback: illegal while the stream is captured
        return st, mets

    eng.cycle = syncing_cycle
    with pytest.raises(RuntimeError):
        eng.cycle_step(state, xs[3:6])
    torch.cuda.synchronize()
    assert state.step == step and sinkhorn_resident_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("layout,B,kernel,events",
                         [("rows", 64, "local_step", 30), ("rows", 2100, "local_step", 30),
                          ("matrices", 1100, "grid_sinkhorn", 6)],
                         ids=["rows-fused-tier", "rows-stream-tier", "matrices-grid-tier"])
def test_group_matcher_capture_replays_eager(cuda_device, layout, B, kernel, events):
    """A matcher of a process group (one-process NCCL group) captured into
    one CUDA graph, its all-gathers, all-reduces and reduce-scatter
    included, as a fused cycle on K ranks holds it: replayed on new features
    it gives the eager call's outputs bit for bit, and a profiled replay
    launches the matcher's kernel (30 local steps a row-sharded match, 6
    grid launches a matrix-parallel one): the row blocks (6, 32, 32) of the
    fused tier and (6, 1050, 1050) of the stream tier, and 6 whole 550^2
    matrices of the grid tier (``chip_smoke.py`` phase 6 at full size)."""
    import socket

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from otgan_tpu_torch.cycle_graph import TorchGraph
    from otgan_tpu_torch.parallel import matching_matrix, matching_sharded

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        make = (matching_sharded.make_sharded_two_batch_matcher if layout == "rows"
                else matching_matrix.make_matrix_parallel_two_batch_matcher)
        matcher = make(None, 500.0, 30, use_pallas=True)
        if layout == "rows":
            tier = sinkhorn_step_cuda.local_step_mode(B // 2, B // 2)
            assert tier == ("fused" if B == 64 else "stream")
        gen = torch.Generator(device=cuda_device).manual_seed(0)

        def features():
            f = torch.randn((B, 256), generator=gen, device=cuda_device)
            return f / f.norm(dim=1, keepdim=True)

        static = [features(), features()]
        matcher(*static)  # the eager warm-up: the communicator, the kernels' build
        graph = TorchGraph()
        with graph.capture():
            out = matcher(*static)
        new = [features(), features()]
        want = [t.clone() for t in matcher(*new)]
        for s, t in zip(static, new):
            s.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(out, want):
            assert torch.equal(o, w)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert sum(kernel in n for n in names) == events, sorted(set(names))[:20]
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_phase_marks_count_and_time_a_replayed_cycle(cuda_device, tmp_path):
    """One DCGAN 5:1 cycle at batch 128 (50 Sinkhorn iterations) eagerly,
    one captured and replayed, one replayed under ``torch.profiler``: the
    tally counts one a step in each of the five slots of its kind and none
    in ``refeatures`` (whole batches), eager and replayed, from ten marks a
    step; the profiled replay's marks run in
    the cycle's order; each slot's profiled total agrees with the interval
    between its marks in the trace within 2% or 20 us; and every other
    kernel of the replay starts between a step's marks."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.utils import tracing

    eng = Engine(TrainConfig(model="dcgan", batch_size=128, nr_sinkhorn_iter=50), cuda_device)
    rng = np.random.default_rng(0)

    def batches():
        return [torch.from_numpy(rng.integers(0, 256, (128, 32, 32, 3), dtype=np.uint8))
                for _ in range(6)]

    def counts(totals):
        return {kind: {s: v["count"] for s, v in slots.items()} for kind, slots in totals.items()}

    def cycles(n):
        return {kind: {s: 0 if s in tracing.NESTED_SPANS else k * n for s in tracing.SLOTS}
                for kind, k in (("gen", 5), ("disc", 1))}

    state, _ = eng.init_state(1, batches()[0])
    tracing.reset()
    state, _ = eng.cycle_step(state, batches())  # eager
    torch.cuda.synchronize()
    assert counts(tracing.device_ms(cuda_device)) == cycles(1)
    state, _ = eng.cycle_step(state, batches())  # captured, then replayed
    torch.cuda.synchronize()
    assert len(eng._graphs) == 1 and eng.replays == 1
    assert counts(tracing.device_ms(cuda_device)) == cycles(2)
    xs = batches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = eng.cycle_step(state, xs)
        torch.cuda.synchronize()
    assert eng.replays == 2
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    profiled = tracing.profiled_device_ms(cuda_device)
    assert counts(profiled) == cycles(1)
    assert counts(tracing.device_ms(cuda_device)) == cycles(3)

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    marks = sorted((e for e in events if tracing.MARK.search(e["name"])),
                   key=lambda e: float(e["ts"]))
    order = []
    for kind in ["disc"] + ["gen"] * 5:
        order.append((kind, "step", "begin"))
        for p in tracing.PHASE_SPANS:
            order += [(kind, p, "begin"), (kind, p, "end")]
        order.append((kind, "step", "end"))
    assert [tracing.MARK.search(e["name"]).groups() for e in marks] == order
    summary = tracing.summarize(path)
    for kind, slots in profiled.items():
        for slot, v in slots.items():
            n, ms = summary["marks"].get(f"{kind}.{slot}", [0, 0.0])
            assert n == v["count"]
            assert abs(ms - v["ms"]) <= max(0.02 * ms, 0.02), (kind, slot, ms, v["ms"])
    steps = [(a, end) for a, _, end, _, slot in tracing._marked(events) if slot == "step"]
    first, last = float(marks[0]["ts"]), float(marks[-1]["ts"])
    inside = [e for e in events if not tracing.MARK.search(e["name"])
              and first <= float(e["ts"]) <= last]
    assert inside and all(any(a <= float(e["ts"]) < b for a, b in steps) for e in inside)
    phase_ms = summary["phase_device_ms"]
    print(f"phase marks at batch 128: profiled {json.dumps(profiled)}; phase_device_ms "
          f"{json.dumps(phase_ms)}; mean mark "
          f"{sum(float(e['dur']) for e in marks) / len(marks):.2f} us")


def _boundary_inputs(device, name, n, seed):
    mode, shape, arg = BOUNDARIES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((n, *shape), generator=g, device=device).to(torch.bfloat16)
    bias = 0.5 * torch.randn(shape[-1], generator=g, device=device)
    args = (arg,) if mode == "crelu_pad" else arg
    out_shape = getattr(lb, f"{mode}_plain")(y, bias, *args).shape
    gx = (1e-3 * torch.randn(out_shape, generator=g, device=device)).to(torch.bfloat16)
    return getattr(lb, mode), getattr(lb, f"{mode}_plain"), y, bias, args, gx


def _through(op, y, bias, args, gx):
    y, bias = y.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()
    out = op(y, bias, *args)
    gy, gb = torch.autograd.grad(out, (y, bias), gx)
    return out, gy, gb


def _bias_close(got, want, gy):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(gy.float().abs().sum()) / gy.shape[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BOUNDARIES))
def test_layer_boundary_kernel_matches_plain(cuda_device, name):
    """Each boundary on 512 images: the forward and the input gradient bit
    for bit the plain chain's on the card, the bias gradient within the
    tolerance above; one kernel call each way."""
    op, plain, y, bias, args, gx = _boundary_inputs(cuda_device, name, 512, 0)
    lb.reset_launch_counts()
    out, gy, gb = _through(op, y, bias, args, gx)
    torch.cuda.synchronize()
    assert lb.launches == {"kernel": 2, "plain": 0}
    want, want_gy, want_gb = _through(plain, y, bias, args, gx)
    assert out.dtype == gy.dtype == torch.bfloat16 and gb.dtype == torch.float32
    assert torch.equal(out, want) and torch.equal(gy, want_gy)
    _bias_close(gb, want_gb, want_gy)


@pytest.mark.cuda
def test_layer_boundary_capture_replays_eager(cuda_device):
    """A critic and the dense GLU boundary, forward and backward, captured in
    one CUDA graph and replayed on new inputs copied into its buffers: bit
    for bit the eager calls on those inputs, bias gradients included."""
    cases = [_boundary_inputs(cuda_device, name, 64, 1) for name in ("critic_1_2", "gen_dense_0")]
    leaves = [(y.requires_grad_(), bias.requires_grad_(), gx) for _, _, y, bias, _, gx in cases]

    def run():
        outs = []
        for (op, _, _, _, args, _), (y, bias, gx) in zip(cases, leaves):
            out = op(y, bias, *args)
            outs += [out, *torch.autograd.grad(out, (y, bias), gx)]
        return outs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    for seed in (2, 3):
        fresh = [_boundary_inputs(cuda_device, name, 64, seed)
                 for name in ("critic_1_2", "gen_dense_0")]
        with torch.no_grad():
            for (y, bias, gx), (_, _, y2, b2, _, gx2) in zip(leaves, fresh):
                y.copy_(y2), bias.copy_(b2), gx.copy_(gx2)
        graph.replay()
        torch.cuda.synchronize()
        eager = run()
        assert all(torch.equal(a, b) for a, b in zip(static, eager)), seed


@pytest.mark.cuda
def test_layer_boundary_bad_inputs_raise(cuda_device):
    y = torch.randn(2, 4, 4, 16, device=cuda_device).to(torch.bfloat16)
    b = torch.zeros(16, device=cuda_device)
    pads = (1, 2, 1, 2)
    misaligned = y.reshape(-1)[1:257].reshape(1, 4, 4, 16)  # contiguous, 2 bytes off
    for bad in (lambda: lb.crelu_pad_cuda(y.float(), b, pads),         # dtype
                lambda: lb.crelu_pad_cuda(y[..., :8], b[:8], pads),    # not contiguous
                lambda: lb.crelu_pad_cuda(y[..., :12].contiguous(), b[:12], pads),  # C % 8
                lambda: lb.crelu_pad_cuda(y, b[:8], pads),             # bias shape
                lambda: lb.crelu_pad_cuda(y, b.cpu(), pads),           # bias device
                lambda: lb.crelu_pad_cuda(y, b.double(), pads),        # bias dtype
                lambda: lb.crelu_pad_cuda(y, b, (1, -1, 0, 0)),        # pads
                lambda: lb.crelu_pad_cuda(y[0], b, pads),              # rank
                lambda: lb.crelu_pad(misaligned, b, pads),             # alignment
                lambda: lb.glu_upsample_cuda(y, b, 3),                 # factor
                lambda: lb.glu_upsample_cuda(y, b[:8], 2),             # bias shape
                lambda: lb.glu_upsample_cuda(y.reshape(2, -1), b, 2, (3, 3)),  # not 2 x 3 x 3 x C
                lambda: lb.glu_upsample_cuda(y[..., :12].contiguous(), b[:12], 2)):  # C % 8
        with pytest.raises(ValueError):
            bad()
    x = lb.crelu_pad_cuda(y, b, pads)
    with pytest.raises(ValueError):  # the gradient of another shape
        lb.crelu_pad_backward_cuda(x[:, 1:].contiguous(), x, y.shape, pads)
    with pytest.raises(ValueError):  # a CPU tensor never launches
        lb.crelu_pad_cuda(y.cpu(), b.cpu(), pads)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_layer_boundary_model_matches_the_layer_chain(cuda_device, remat):
    """The bf16 critic and generator at batch 64 on the card, the boundaries
    on their kernels against the layers' own chain (cuDNN deterministic, so
    both run the same convolutions): outputs and every gradient bit for bit
    but the biases', with and without remat."""
    from unittest import mock

    from otgan_tpu_torch.models import dcgan
    from otgan_tpu_torch.nn.layers import reset_parameters

    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for make, inp in ((dcgan.make_discriminator,
                           torch.rand(64, 32, 32, 3, device=cuda_device).to(torch.bfloat16)),
                          (dcgan.make_generator, dcgan.sample_latent(64, device=cuda_device))):
            model = make(compute_dtype=torch.bfloat16, remat=remat,
                         remat_policy="disc_c3,gen_g2" if remat else "")
            reset_parameters(model, torch.Generator().manual_seed(0))
            model.to(cuda_device)
            with torch.no_grad():
                for p in model.parameters():
                    if p.dim() == 1:
                        p.add_(0.2 * torch.randn_like(p))
            got = []
            for fused in (True, False):
                lb.reset_launch_counts()
                with mock.patch.object(dcgan, "engages", lambda *a, f=fused: f):
                    x = inp.clone().requires_grad_()
                    out = model(x)
                    w = torch.linspace(-1, 2, out.numel(), device=cuda_device)
                    grads = torch.autograd.grad((out.float() * w.reshape(out.shape)).sum(),
                                                [*model.parameters(), x])
                torch.cuda.synchronize()
                got.append((out, grads, dict(lb.launches)))
            (out, grads, counts), (want, want_grads, plain_counts) = got
            n = 3 if make is dcgan.make_discriminator else 4
            assert counts == {"kernel": (3 if remat else 2) * n, "plain": 0}
            assert plain_counts == {"kernel": 0, "plain": 0}
            assert torch.equal(out, want)
            for (name, _), g, w in zip(model.named_parameters(), grads, want_grads):
                if name.endswith(".b"):
                    torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().sum()))
                else:
                    assert torch.equal(g, w), name
            assert torch.equal(grads[-1], want_grads[-1])
    finally:
        torch.backends.cudnn.deterministic = cudnn


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_layer_boundary_counts_a_step(cuda_device, kind):
    """One engine step of the bf16 DCGAN at batch 128: 17 kernel crossings
    for a generator step, 16 for a critic step (PERF.md), no plain one."""
    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine

    eng = Engine(TrainConfig(model="dcgan", batch_size=128, nr_sinkhorn_iter=20), cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (128, 32, 32, 3),
                                                           dtype=np.uint8))
    state, _ = eng.init_state(1, x)
    lb.reset_launch_counts()
    state, metrics = (eng.gen_step if kind == "gen" else eng.disc_step)(state, x)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics.dist))
    assert lb.launches == {"kernel": 17 if kind == "gen" else 16, "plain": 0}


# -- the DenseNet's list-conv boundaries (csrc/dense_boundary.cu) ------------

def _dense_block(device, n, h, w, widths, seed):
    """A block whose slab holds every element, drawn with zeros of both
    signs, both signs and a spread of magnitudes."""
    from otgan_tpu_torch.nn import dense_boundary as db

    g = torch.Generator(device=device).manual_seed(seed)
    block = db.Block(torch.empty(0, device=device), n, h, w, widths)
    s = torch.randn(block.slab.shape, generator=g, device=device)
    s = s * torch.exp2(torch.randint(-8, 8, s.shape, generator=g, device=device).float())
    r = torch.rand(s.shape, generator=g, device=device)
    block.slab.copy_(torch.where(r < 0.05, 0.0, torch.where(r < 0.1, -0.0, s)))
    return block


@pytest.mark.cuda
def test_dense_boundary_relu_is_the_cards(cuda_device):
    """The plain versions' relu, which the kernels compute, is PyTorch's on
    the card bit for bit: a NaN passes, and a zero of either sign gives +0."""
    from otgan_tpu_torch.nn import dense_boundary as db

    v = torch.tensor([-0.0, 0.0, -1.5, 2.0, float("nan"), -float("inf"), float("inf")] * 40,
                     device=cuda_device).to(torch.bfloat16)
    for x in (v, -v):
        assert torch.equal(db._relu(x).view(torch.int16), torch.relu(x).view(torch.int16))


def _on_cpu(block):
    from otgan_tpu_torch.nn import dense_boundary as db

    twin = db.Block(torch.empty(0), block.n, block.h, block.w, block.widths)
    twin.slab.copy_(block.slab.cpu())
    return twin


class _Conv:
    """The geometry a conv asks of the gather: its SAME pads and upsample."""

    def __init__(self, kernel, stride, upsample):
        from otgan_tpu_torch.nn.layers import same_padding

        self.k, self.stride, self.upsample = kernel, stride, upsample
        self.same_pads = lambda h, w: (same_padding(h, kernel, stride)
                                       + same_padding(w, kernel, stride))


# (pixels, element widths, elements a conv takes, kernel, stride, upsample):
# the cell's block-0 list conv, its down conv, an up conv, widths of every
# vector width the kernels take, and convs of more elements than one launch
# takes (two and three runs)
DENSE_CASES = {
    "list_32": (32, [32] + [16] * 16, 9, 3, 1, False),
    "down_32": (32, [32] + [16] * 16, 17, 3, 2, False),
    "down_16_ragged": (16, [144] + [16] * 16, 17, 3, 2, False),
    "up_8": (8, [16, 16] + [16] * 16, 18, 3, 1, True),
    "up_16": (16, [144, 16] + [16] * 16, 18, 3, 1, True),
    "vec4": (8, [12, 4, 4, 4], 4, 3, 2, False),
    "vec2": (8, [6, 2, 2], 3, 3, 1, True),
    "vec1": (5, [3, 1, 1, 1], 4, 3, 2, False),
    "runs_down": (4, [16] + [8] * 79, 80, 3, 2, False),
    "runs_up": (4, [8] * 70, 70, 3, 1, True),
    "runs_vec1": (5, [3] + [1] * 139, 140, 3, 1, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_boundary_kernels_match_plain(cuda_device, name):
    """Slab write, gather and scatter (a store, then an add) at the
    DenseNet's shapes on 64 images and on ragged widths: bit for bit their
    plain versions on the same values, and the same bits from two runs."""
    from otgan_tpu_torch.nn import dense_boundary as db

    size, widths, k, kernel, stride, up = DENSE_CASES[name]
    n = 64
    block = _dense_block(cuda_device, n, size, size, widths, 0)
    twin = _on_cpu(block)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    # writes: a raw bf16 output with its bias, a float32 noise, a dense row
    y = torch.randn(n, size, size, widths[1], generator=g, device=cuda_device).to(torch.bfloat16)
    b = torch.randn(widths[1], generator=g, device=cuda_device)
    u = torch.rand(n, size, size, widths[-1], generator=g, device=cuda_device) * 2 - 1
    d = torch.randn(n, size * size * widths[0], generator=g, device=cuda_device).to(
        torch.bfloat16)
    bd = torch.randn(size * size * widths[0], generator=g, device=cuda_device)
    for blk, dev in ((block, cuda_device), (twin, torch.device("cpu"))):
        db.reset_launch_counts()
        db._write(blk, 1, y.to(dev), b.to(dev))
        db._write(blk, len(widths) - 1, u.to(dev), None)
        db._write(blk, 0, d.to(dev), bd.to(dev))
        assert db.launches == ({"kernel": 3, "plain": 0} if dev.type == "cuda"
                               else {"kernel": 0, "plain": 3})
    assert torch.equal(block.slab.cpu().view(torch.int16), twin.slab.view(torch.int16))
    geo = db.geometry(block, k, _Conv(kernel, stride, up))
    x = db.gather_cuda(block, geo)
    assert torch.equal(x.cpu().view(torch.int16), db.gather_plain(twin, geo).view(torch.int16))
    gx = (torch.randn(x.shape, generator=g, device=cuda_device)
          * torch.exp2(torch.randint(-6, 6, x.shape, generator=g, device=cuda_device).float())
          ).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        accs = [torch.full((n, size, size, f), float("nan"), device=cuda_device)
                if e % 3 else None for e, f in enumerate(widths[:k])]
        db.scatter_cuda(block, geo, gx, accs, [True] * k)
        db.scatter_cuda(block, geo, gx.flip(0).contiguous(), accs, [False] * k)
        runs.append(accs)
    want = [None if a is None else torch.empty(a.shape) for a in runs[0]]
    db.scatter_plain(twin, geo, gx.cpu(), want, [True] * k)
    db.scatter_plain(twin, geo, gx.flip(0).cpu(), want, [False] * k)
    for e, (a, a2, w) in enumerate(zip(*runs, want)):
        if w is not None:
            assert bool(torch.isfinite(a).all()), e  # every position written
            assert torch.equal(a.cpu().view(torch.int32), w.view(torch.int32)), e
            assert torch.equal(a.view(torch.int32), a2.view(torch.int32)), e


@pytest.mark.cuda
def test_dense_boundary_bad_inputs_raise(cuda_device):
    from otgan_tpu_torch.nn import dense_boundary as db

    block = _dense_block(cuda_device, 2, 4, 4, [16, 16, 16], 0)
    geo = db.geometry(block, 2, _Conv(3, 1, False))
    y = torch.randn(2, 4, 4, 16, device=cuda_device).to(torch.bfloat16)
    b = torch.zeros(16, device=cuda_device)
    x = db.gather_cuda(block, geo)
    acc = torch.zeros(2, 4, 4, 16, device=cuda_device)
    for bad in (lambda: db.write_cuda(block, 1, y.float(), b),         # float32 with a bias
                lambda: db.write_cuda(block, 1, y, None),              # bf16 without
                lambda: db.write_cuda(block, 1, y[:1], b),             # rows
                lambda: db.write_cuda(block, 1, y, b[:8]),             # bias shape
                lambda: db.write_cuda(block, 1, y, b.cpu()),           # bias device
                lambda: db.write_cuda(block, 1, y.transpose(1, 2), b),  # not contiguous
                lambda: db.gather_cuda(block, geo._replace(k=4)),      # elements
                lambda: db.scatter_cuda(block, geo, x[:, 1:].contiguous(), [acc, None],
                                        [True, True]),                # gradient shape
                lambda: db.scatter_cuda(block, geo, x, [acc[:, 1:].contiguous(), None],
                                        [True, True]),                # accumulator shape
                lambda: db.scatter_cuda(block, geo, x, [acc.double(), None], [True, True])):
        with pytest.raises(ValueError):
            bad()
    cpu = _on_cpu(block)
    with pytest.raises(ValueError):  # a CPU tensor never launches
        db.gather_cuda(cpu, geo)


def _fingerprint(t: torch.Tensor) -> int:
    """The bits of ``t`` (zeros of either sign alike, as ``torch.equal``)
    summed with fixed pseudo-random weights in int64: equal tensors give
    equal numbers, different ones almost surely not."""
    flat, total, chunk = t.detach().reshape(-1), 0, 1 << 24
    for i in range(0, flat.numel(), chunk):  # in chunks: the net's own bytes fill the card
        bits = (flat[i:i + chunk] + 0).view(
            torch.int16 if t.element_size() == 2 else torch.int32).long()
        w = torch.arange(i, i + bits.numel(), device=t.device, dtype=torch.int64)
        total += int((bits * ((w * 2654435761 + 12345) % 1000003)).sum())
    return total


def _dense_pass(model, kind, inp, critic=None):
    """One forward and backward at the cell's shapes: the images or
    features, every parameter gradient (and the images' under a critic),
    and each conv call's arguments with its input's fingerprint."""
    import torch.nn.functional as F_

    calls, real = [], F_.conv2d

    def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
        calls.append((tuple(x.shape), x.stride(), x.dtype, tuple(w.shape), stride, padding,
                      dilation, _fingerprint(x), _fingerprint(w)))
        return real(x, w, bias, stride, padding, dilation, groups)

    with mock.patch.object(F_, "conv2d", conv2d):
        if kind == "disc":  # two forwards alive, one backward
            fake, data = inp
            f_fake, f_dat = model(fake), model(data)
            w = torch.linspace(-1, 2, f_fake.shape[1], device=f_fake.device)
            loss = (f_fake * w).sum() - (f_dat * w.flip(0)).sum()
            out = torch.cat([f_fake, f_dat]).detach()
            grads = torch.autograd.grad(loss, list(model.parameters()))
        else:  # the generator through a frozen critic
            x = model(inp)
            for p in critic.parameters():
                p.requires_grad_(False)
            try:
                f = critic(x)
                loss = (f * torch.linspace(-1, 2, f.shape[1], device=f.device)).sum()
                out = x.detach()
                grads = torch.autograd.grad(loss, list(model.parameters()))
            finally:
                for p in critic.parameters():
                    p.requires_grad_(True)
    return out, grads, calls


def _dense_models(device):
    from otgan_tpu_torch.models import densenet
    from otgan_tpu_torch.nn.layers import reset_parameters

    models = []
    for k, make in enumerate((densenet.make_discriminator, densenet.make_generator)):
        m = make(16, 16, compute_dtype=torch.bfloat16)
        reset_parameters(m, torch.Generator().manual_seed(k))
        m.to(device)
        with torch.no_grad():
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.2 * torch.randn_like(p))
        models.append(m)
    return models


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["disc", "gen"])
def test_dense_boundary_model_matches_the_layer_chain(cuda_device, kind):
    """The bf16 DenseNet (L = F = 16) on 1250 rows, the cell's microbatch, with
    cuDNN as the engine leaves it: a critic pass (fakes and data alive, one
    backward) or a generator pass (through the frozen critic) on slabs
    against the layers' own chain. Every conv call's arguments and input, the
    features or images and every parameter gradient bit for bit, and the
    same bits from a second run on slabs. In the generator pass that second
    run fills the input each frozen critic conv's backward gets, which its
    data gradient must not read, with NaN."""
    import gc

    from otgan_tpu_torch.models import densenet
    from otgan_tpu_torch.nn import dense_boundary as db

    gc.collect()  # earlier tests' cached blocks: the layers' chain fills the card
    torch.cuda.empty_cache()
    disc, gen = _dense_models(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    noise = densenet.sample_latent(1250, g, device=cuda_device)
    if kind == "disc":
        with torch.no_grad():
            fake = gen(noise)
        inp = (fake, torch.rand(1250, 32, 32, 3, generator=g, device=cuda_device) * 2 - 1)
        model, critic = disc, None
    else:
        inp, model, critic = noise, gen, disc
    got, unread = [], []

    def nan_unread(shape, stride, device):
        unread.append(shape)
        return torch.empty_strided(shape, stride, dtype=torch.bfloat16,
                                   device=device).fill_(float("nan"))

    for run, slabs in enumerate((False, True, True)):
        db.reset_launch_counts()
        with mock.patch.object(db, "engages", db.engages if slabs else (lambda *a: False)), \
                mock.patch.object(db, "_unread", nan_unread if run == 2 else db._unread):
            out, grads, calls = _dense_pass(model, kind, inp, critic)
        torch.cuda.synchronize()
        got.append((out, grads, calls, dict(db.launches)))
        gc.collect()
        torch.cuda.empty_cache()
    (want, want_grads, want_calls, plain), *slab_runs = got
    assert plain == {"kernel": 0, "plain": 0}
    names = [n for n, _ in model.named_parameters()]
    for out, grads, calls, launches in slab_runs:
        assert launches["plain"] == 0 and launches["kernel"] == (
            4 * 102 if kind == "disc" else 105 + 102 + 51 + 102), launches
        assert len(calls) == len(want_calls)
        bad = [i for i, (a, b) in enumerate(zip(calls, want_calls)) if a != b]
        assert not bad, [(i, calls[i][:7], calls[i][7] == want_calls[i][7]) for i in bad[:5]]
        assert torch.equal(out, want)
        bad = [n for n, a, b in zip(names, grads, want_grads) if not torch.equal(a, b)]
        assert not bad, bad
    assert len(unread) == (0 if kind == "disc" else 51)  # every critic conv's backward
    (_, g1, c1, _), (_, g2, c2, _) = slab_runs
    assert c1 == c2 and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                            for a, b in zip(g1, g2))


@pytest.mark.cuda
def test_dense_boundary_engine_steps_equal_the_layer_chain(cuda_device):
    """One critic step and one generator step of the bf16 DenseNet at batch
    5000, --grad_accum 4, through the engine: the state after each (nets,
    EMA, Adam's moments) bit for bit the layers' chain's from the same
    state, and the counts of a step (PERF.md): on slabs 2868 launches a
    critic step and 2676 a generator step, 1020 list inputs either way."""
    import gc

    from otgan_tpu_torch.config import TrainConfig
    from otgan_tpu_torch.engine import Engine
    from otgan_tpu_torch.nn import dense_boundary as db
    from otgan_tpu_torch.utils import tracing

    gc.collect()  # earlier tests' cached blocks: this test fills the card
    torch.cuda.empty_cache()
    eng = Engine(TrainConfig(model="densenet", batch_size=5000, grad_accum=4,
                             init_batch_size=500, nr_sinkhorn_iter=50,
                             fused_cycle=False), cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (5000, 32, 32, 3),
                                                           dtype=np.uint8))
    results = []
    # the layers' chain first, while the cache is freshest: it holds the most
    for slabs in (False, True):
        state, _ = eng.init_state(1, x[:500])  # on the layers' chain, as --init_batch_size 500
        db.reset_launch_counts()
        tracing.reset_counts()
        counts = []
        with mock.patch.object(db, "engages", db.engages if slabs else (lambda *a: False)):
            for step in (eng.disc_step, eng.gen_step):
                before = dict(db.launches), dict(tracing.counts)
                state, m = step(state, x)
                torch.cuda.synchronize()
                counts.append((db.launches["kernel"] - before[0]["kernel"],
                               db.launches["plain"] - before[0]["plain"],
                               tracing.counts["dense_concat"] - before[1]["dense_concat"]))
                assert np.isfinite(float(m.dist))
        leaves = [t.detach().clone() for t in (
            *state.gen.parameters(), *state.disc.parameters(),
            *torch.utils._pytree.tree_leaves((state.gen_ema, state.gen_opt, state.disc_opt)))
            if isinstance(t, torch.Tensor)]
        results.append((leaves, counts))
        del state
        gc.collect()
        torch.cuda.empty_cache()
    (want, plain_counts), (got, counts) = results
    assert counts == [(2868, 0, 1020), (2676, 0, 1020)]
    assert plain_counts == [(0, 0, 1020), (0, 0, 1020)]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    assert not bad, (bad[:10], len(got))
