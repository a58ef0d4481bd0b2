"""The local Sinkhorn step of the row-sharded matcher: the plain version of
the port's two CUDA kernels against the JAX package's two Pallas kernels
(interpret mode), and the tier rule against the JAX package's.

Limits: m within 1e-6 absolute and s within 1e-5 relative
(tests/test_matching_sharded.py). The Pallas kernels run on blocks padded
onto the TPU's tile grid with ``n_rows``/``n_cols`` marking the valid
region; the port's kernels take the block unpadded, so the comparison is
over the valid region.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.ops import sinkhorn_pallas_step as jax_step
from otgan_tpu_torch.ops import sinkhorn_step_cuda as st


def _block(seed, b, n_loc, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 0, (b, n_loc, n)).astype(np.float32)
    v = rng.uniform(-5, 5, (b, n)).astype(np.float32)
    return x, v


def _padded(x, v, rows, cols):
    b, n_loc, n = x.shape
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, rows - n_loc), (0, cols - n)))
    vp = jnp.pad(jnp.asarray(v)[:, None, :], ((0, 0), (0, 0), (0, cols - n)))
    return xp, vp


def _check(m, s, m_ref, s_ref, n):
    m_ref = np.asarray(m_ref)[:, 0, :n]
    s_ref = np.asarray(s_ref)[:, 0, :n]
    np.testing.assert_allclose(m.numpy(), m_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(3, 16, 128), (2, 21, 200), (1, 5, 7)],
                         ids=["aligned", "unaligned", "tiny"])
def test_plain_matches_fused_pallas_kernel(shape):
    x, v = _block(0, *shape)
    b, n_loc, n = shape
    rows, cols = jax_step.pad_to_grid(n_loc, n)
    xp, vp = _padded(x, v, rows, cols)
    m_ref, s_ref = jax_step.fused_local_sinkhorn_step(xp, vp, interpret=True,
                                                      n_rows=n_loc, n_cols=n)
    m, s = st.local_step_plain(torch.from_numpy(x), torch.from_numpy(v))
    _check(m, s, m_ref, s_ref, n)


@pytest.mark.parametrize("shape,panel", [((3, 21, 200), 8), ((2, 64, 256), 16)],
                         ids=["3-panels-unaligned", "4-panels"])
def test_plain_matches_streaming_pallas_kernel(shape, panel):
    x, v = _block(1, *shape)
    b, n_loc, n = shape
    rows, cols = jax_step.pad_to_stream_grid(n_loc, n, panel)
    assert rows // panel >= 3
    xp, vp = _padded(x, v, rows, cols)
    m_ref, s_ref = jax_step.streaming_local_sinkhorn_step(
        xp, vp, panel=panel, interpret=True, n_rows=n_loc, n_cols=n)
    m, s = st.local_step_plain(torch.from_numpy(x), torch.from_numpy(v))
    _check(m, s, m_ref, s_ref, n)


@pytest.mark.parametrize(
    "n_loc,n,mode",
    [(313, 2500, "fused"), (1000, 1000, "fused"), (1000, 4000, "stream"),
     (4000, 4000, "stream"), (500, 4000, "stream"), (8, 200000, None), (10, 20, "fused")],
)
def test_tier_rule_is_the_jax_packages(n_loc, n, mode):
    """B 5000 on 8 GPUs, B 2000 and B 8000 on one rank, B 8000 on 4 and on 8
    GPUs, a block too wide for either tier, a test block."""
    assert st.local_step_mode(n_loc, n) == jax_step.local_step_mode(n_loc, n) == mode
    assert st.local_step_supported(n_loc, n) == jax_step.local_step_supported(n_loc, n)
    assert st.streaming_panel(n_loc, n) == jax_step.streaming_panel(n_loc, n)


def test_cpu_tensor_takes_the_plain_version():
    x, v = _block(2, 2, 9, 11)
    st.reset_launch_counts()
    step = st.make_local_step(torch.from_numpy(x))
    m, s = step(torch.from_numpy(v))
    m2, s2 = step(torch.from_numpy(v))
    assert st.launches == {"fused": 0, "stream": 0, "plain": 2}
    assert torch.equal(m, m2) and torch.equal(s, s2) and m.shape == (2, 11)
    with pytest.raises(ValueError, match="device"):
        st.make_local_step(torch.empty((2, 9, 11), device="meta"))
