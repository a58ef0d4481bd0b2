"""The hand-written CUDA Sinkhorn kernels on a card (the column-potential
loop, the row-sharded matcher's local step, the resident whole-loop kernel
and the grid whole-loop kernel), against their plain PyTorch versions on the
same logits. Every test here needs an NVIDIA GPU and
``nvcc`` (a CUDA kernel has no CPU mode) and skips without one. This file
imports no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: P within 1e-5 and entropy within 1e-4, at lam = 500 on square
matrices. Rectangular matrices have no fixed point with unit marginals:
their potentials drift by log(M/N) per iteration, to |v| ~ 400 after 500
iterations, where float32 spacing is 3e-5; those shapes run 100 iterations
at a small aspect ratio.
"""

import numpy as np
import pytest
import torch

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
