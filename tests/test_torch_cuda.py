"""The hand-written CUDA Sinkhorn kernel on a card, against its plain
PyTorch version on the same logits. Every test here needs an NVIDIA GPU and
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

from otgan_tpu_torch.ops import sinkhorn_cuda
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
    sinkhorn_cuda.reset_launch_counts()
    p, e = sinkhorn_assignment(_costs(6, 64, 64, 32).to(cuda_device), 500.0, 50,
                               use_pallas=True)
    assert sinkhorn_cuda.launches == {"kernel": 1, "plain": 0}
    assert p.shape == (6, 64, 64) and e.shape == (6,)
    torch.testing.assert_close(p.sum(-1), torch.ones(6, 64, device=cuda_device),
                               atol=1e-5, rtol=0)
