"""The local Sinkhorn step of the row-sharded matcher: the plain version of
the port's CUDA kernel against the JAX package's two Pallas kernels
(interpret mode), the tier rule against the JAX package's, the kernel's
plan, and a float32 model of the kernel's order of work against both.

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


_TIER_SHAPES = [(313, 2500, "fused"), (1000, 1000, "fused"), (1000, 4000, "stream"),
                (4000, 4000, "stream"), (500, 4000, "stream"), (8, 200000, None),
                (10, 20, "fused")]


@pytest.mark.parametrize("n_loc,n,mode", _TIER_SHAPES)
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


# ---- the kernel's plan and its order of work (csrc/sinkhorn_step.cu) ----

_SMEM = 232448  # the shared memory a block may use on an H100


def _plan_shapes():
    """Every tier-rule shape above at b = 6, the fused tier's wide (2, 8,
    40000), the stream tier's widest blocks (28,928 columns, the old stream
    kernel's ceiling, and 163,840, the tier rule's), and b above the SMs."""
    shapes = [(6, n_loc, n) for n_loc, n, _ in _TIER_SHAPES]
    return shapes + [(2, 8, 40000), (6, 16, 28928), (8, 8, 163840), (6, 1000, 11000),
                     (200, 10, 10)]


def _block_rows(plan, n):
    return [range(k * plan.band, min(n, (k + 1) * plan.band)) for k in range(plan.blocks)]


@pytest.mark.parametrize("shape", _plan_shapes(), ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_row_once_within_shared_memory(shape):
    b, n, m = shape
    plan = st.step_plan(b, n, m)
    rows = [r for blk in _block_rows(plan, n) for r in blk]
    assert rows == list(range(n))  # each row in exactly one block, in order
    assert all(len(blk) for blk in _block_rows(plan, n))  # the default plan has no idle block
    assert plan.blocks * min(plan.groups, b) <= 132 and 1 <= plan.groups <= b
    assert plan.smem == st.smem_bytes(m, plan.stage_rows, plan.stages) <= _SMEM
    assert 1 <= plan.stage_rows <= min(st.MAX_STAGE_ROWS, plan.band)
    assert 0 <= plan.stages <= st.MAX_STAGES
    if plan.stages:  # a ring: no more stages than the band fills
        assert (plan.stages - 1) * plan.stage_rows < plan.band


@pytest.mark.parametrize("shape,stages,blocks,ring", [
    ((6, 1000, 4000), None, None, True), ((6, 313, 2500), None, None, True),
    ((6, 500, 2000), None, None, True), ((2, 8, 40000), None, None, False),
    ((6, 16, 28928), None, None, False), ((6, 1000, 4000), 8, 11, True),
    ((2, 37, 50), None, 64, True), ((6, 1000, 4000), None, 133, None),
    ((2, 8, 40000), 2, None, None), ((6, 1000, 4000), 0, None, False),
    ((6, 1000, 4000), 9, None, None)])
def test_plan_ring_direct_and_forced(shape, stages, blocks, ring):
    """The ring where v, the accumulators and the stages fit (22 blocks of
    46 rows at (6, 1000, 4000)); one stage holding the whole band where it
    fits (the fused tier's rank blocks); in place above that or where forced; a
    forced block count past the rows leaves blocks with none; a plan the
    card cannot run is None (more blocks than SMs; a forced ring too wide
    for the memory; more stages than the kernel has barriers)."""
    b, n, m = shape
    plan = st.step_plan(b, n, m, blocks=blocks, stages=stages)
    if ring is None:
        assert plan is None
        return
    assert (plan.stages > 0) == ring
    if blocks:
        assert plan.blocks == blocks
        assert sorted(r for blk in _block_rows(plan, n) for r in blk) == list(range(n))
    if shape == (6, 1000, 4000) and blocks is None:
        assert (plan.blocks, plan.band, plan.groups) == (22, 46, 6)
        assert stages is not None or plan.stages == st.DEFAULT_STAGES
    if shape in ((6, 313, 2500), (6, 500, 2000)) and stages is None:
        assert (plan.stages, plan.stage_rows) == (1, plan.band)
    if stages:
        assert plan.stages == min(stages, -(-plan.band // plan.stage_rows))


def _model_step(x, v, plan):
    """The kernel's float32 order of work, in torch: u per row; per block
    its rows' column (max, sum), stage by stage and within a stage in
    chunks of 8 rows and the rows left as one chunk (float4 columns, ``m %
    4 == 0``) or of 16, 8, 4, 2, 1 rows (scalar columns), one rescale each
    (a block with no rows keeps (-inf, 0)); then the partials folded in
    block order."""
    b, n, m = x.shape
    sizes = (8, 7, 6, 5, 4, 3, 2, 1) if m % 4 == 0 else (16, 8, 4, 2, 1)
    y = x + v[:, None, :]
    rm = torch.amax(y, dim=-1, keepdim=True)
    u = -(rm + torch.log(torch.sum(torch.exp(y - rm), dim=-1, keepdim=True)))
    z = x + u
    parts = []
    for blk in _block_rows(plan, n):
        mx = torch.full((b, m), -float("inf"))
        s = torch.zeros((b, m))
        for r0 in range(blk.start, blk.stop, plan.stage_rows):
            r1 = min(blk.stop, r0 + plan.stage_rows)
            while r0 < r1:
                size = next(c for c in sizes if r0 + c <= r1)
                chunk = z[:, r0:r0 + size]
                new = torch.maximum(mx, chunk.amax(dim=1))
                s = torch.where(mx == -float("inf"), 0.0, s * torch.exp(mx - new))
                s = s + torch.exp(chunk - new[:, None, :]).sum(dim=1)
                mx, r0 = new, r0 + size
        parts.append((mx, s))
    m_out = torch.stack([p[0] for p in parts]).amax(dim=0)
    s_out = torch.zeros((b, m))
    for pm, ps in parts:
        s_out = s_out + torch.where(pm == -float("inf"), 0.0, ps * torch.exp(pm - m_out))
    return m_out, s_out


@pytest.mark.parametrize("shape,blocks,stages", [
    ((2, 21, 200), None, None), ((3, 37, 50), 64, None), ((1, 5, 7), 8, None),
    ((2, 64, 256), 3, 2), ((3, 100, 228), None, 1)],
    ids=["default", "idle-blocks", "tiny-idle", "three-blocks", "one-stage"])
def test_kernel_order_matches_plain_and_pallas(shape, blocks, stages):
    """The model of the kernel's order on ragged shapes against the plain
    version and both Pallas kernels (interpret mode): m within 1e-6, s
    within 1e-5 relative."""
    x, v = _block(3, *shape)
    b, n_loc, n = shape
    plan = st.step_plan(b, n_loc, n, blocks=blocks, stages=stages)
    if blocks and blocks > n_loc:
        assert not all(len(blk) for blk in _block_rows(plan, n_loc))
    m, s = _model_step(torch.from_numpy(x), torch.from_numpy(v), plan)
    m_ref, s_ref = st.local_step_plain(torch.from_numpy(x), torch.from_numpy(v))
    torch.testing.assert_close(m, m_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=0, rtol=1e-5)
    rows, cols = jax_step.pad_to_grid(n_loc, n)
    xp, vp = _padded(x, v, rows, cols)
    _check(m, s, *jax_step.fused_local_sinkhorn_step(xp, vp, interpret=True, n_rows=n_loc,
                                                      n_cols=n), n)
    rows, cols = jax_step.pad_to_stream_grid(n_loc, n, 8)
    xp, vp = _padded(x, v, rows, cols)
    _check(m, s, *jax_step.streaming_local_sinkhorn_step(xp, vp, panel=8, interpret=True,
                                                          n_rows=n_loc, n_cols=n), n)


# ---- the v mode: kernel 1 above the grid kernel's ceiling ----

@pytest.mark.parametrize("shape", [(6, 4000, 4000), (2, 2700, 2650), (1, 2641, 2641),
                                   (2, 10, 60000)], ids=lambda s: "x".join(map(str, s)))
def test_whole_matrix_plan_of_the_v_mode(shape):
    """``col_potential_cuda`` plans the whole (b, N, M) with ``step_plan``:
    every row in one block, within shared memory; the ring where a stage
    fits, in place for rows too wide (60000 columns)."""
    b, n, m = shape
    plan = st.step_plan(b, n, m)
    assert [r for blk in _block_rows(plan, n) for r in blk] == list(range(n))
    assert plan.smem == st.smem_bytes(m, plan.stage_rows, plan.stages) <= _SMEM
    assert (plan.stages > 0) == (m < 14254)
    if shape == (6, 4000, 4000):
        assert (plan.blocks, plan.band, plan.groups) == (22, 182, 6)


def _model_col_potential(x, iters, plan):
    """The v mode's loop: from v = 0, each iteration one local step in the
    kernel's order (``_model_step``) and the fold's v = -(m + log s)."""
    v = torch.zeros((x.shape[0], x.shape[2]))
    for _ in range(iters):
        m, s = _model_step(x, v, plan)
        v = -(m + torch.log(s))
    return v


@pytest.mark.parametrize("shape,lam,iters,blocks", [
    ((2, 64, 128), 50.0, 30, None), ((3, 37, 50), 50.0, 20, 64), ((1, 100, 228), 50.0, 25, 3),
    ((1, 48, 48), 500.0, 200, None)], ids=["default", "idle-blocks", "three-blocks", "lam500"])
def test_v_mode_order_matches_plain_pallas_and_oracle(shape, lam, iters, blocks):
    """The model of the v mode's order against ``col_potential_plain`` (v
    within 1e-5 of its magnitude, P within 1e-5), the Pallas
    ``_col_potential`` in interpret mode (v on the shapes it takes as they
    are; P through ``sinkhorn_assignment_padded`` on all, 1e-4 at lam 500)
    and the float64 oracle (P within 1e-5)."""
    from otgan_tpu.ops.sinkhorn_pallas_tiled import (
        _col_potential,
        _pick_panel,
        sinkhorn_assignment_padded,
    )
    from otgan_tpu_torch.ops.sinkhorn import assignment_and_entropy
    from otgan_tpu_torch.ops.sinkhorn_cuda import col_potential_plain, scaled_logits
    from tests.reference_impl import sinkhorn_np

    b, n, m = shape
    rng = np.random.default_rng(n + m)
    fa = rng.standard_normal((b, n, 32)).astype(np.float32)
    fb = rng.standard_normal((b, m, 32)).astype(np.float32)
    fa /= np.linalg.norm(fa, axis=-1, keepdims=True)
    fb /= np.linalg.norm(fb, axis=-1, keepdims=True)
    costs = 1.0 - fa @ fb.transpose(0, 2, 1)
    x = scaled_logits(torch.from_numpy(costs), lam)
    plan = st.step_plan(b, n, m, blocks=blocks)
    v = _model_col_potential(x, iters, plan)
    v_ref = col_potential_plain(x, iters)
    scale = max(1.0, float(v_ref.abs().max()))
    torch.testing.assert_close(v, v_ref, atol=1e-5 * scale, rtol=0)
    p, e = assignment_and_entropy(x + v[:, None, :])
    p_ref, e_ref = assignment_and_entropy(x + v_ref[:, None, :])
    torch.testing.assert_close(p, p_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=1e-4, rtol=0)
    band = 1e-4 if lam == 500.0 else 1e-5
    for i in range(b):
        if _pick_panel(n, m) is not None:  # a shape the Pallas kernel takes as it is
            v_j = np.asarray(_col_potential(jnp.asarray(x[i].numpy()), iters, interpret=True))
            np.testing.assert_allclose(v[i].numpy(), v_j[0], atol=1e-5 * scale)
        p_j, e_j = sinkhorn_assignment_padded(jnp.asarray(costs[i]), lam, iters)
        np.testing.assert_allclose(p[i].numpy(), np.asarray(p_j), atol=band)
        assert abs(float(e[i]) - float(e_j)) < 1e-4
        p_o, e_o = sinkhorn_np(costs[i], lam, iters)
        np.testing.assert_allclose(p[i].numpy(), p_o, atol=1e-5)
        assert abs(float(e[i]) - e_o) < 1e-4
