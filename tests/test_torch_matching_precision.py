"""``--matching_precision`` in the port (twin of tests/test_matching_precision.py).

On the card ``high`` is 3xTF32 and ``default`` one TF32 pass; on the CPU
the port emulates both (each pass's operands rounded to TF32, then a
float32 product), so these tests exercise the split. The JAX package's CPU
results ignore precision (tests/test_matching_precision.py), so the port's
``high`` is held against them within a band, not for equality: matched
features and entropy within 1e-5 at lam = 500, the band of DESIGN.md
section 7. The split itself is exact: ``hi`` has its low 13 bits zero,
``hi + lo == a`` bit for bit and ``|lo| <= 2^-11 |a|``. Products against
float64, relative to ``|A| @ |B|``: ``high`` within 2^-20, ``default``
within 2^-10 and more than 8x ``high``'s error.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.ops.costs import resolve_precision as jax_resolve_precision
from otgan_tpu.ops.matching import match_single_batch as jax_match_single_batch
from otgan_tpu.ops.matching import match_two_batch as jax_match_two_batch
from otgan_tpu.parallel.matching_matrix import (
    make_matrix_parallel_two_batch_matcher as jax_matrix_two,
)
from otgan_tpu.parallel.matching_sharded import make_sharded_two_batch_matcher as jax_rows_two
from otgan_tpu.parallel.mesh import make_mesh
from otgan_tpu_torch import config as port_config
from otgan_tpu_torch import train as port_train
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.ops import costs, matching
from tests.test_torch_parallel_worker import World

LAM, ITERS, BAND = 500.0, 30, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world2():
    w = World(2)
    yield w
    w.close()


def _features(seed, n, d=48):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _check(got, want, atol=BAND):
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0)
    assert abs(float(got[4]) - float(want[4])) <= atol


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_every_precision_accepted(precision):
    cfg = port_config.TrainConfig(model="toy_mlp", batch_size=8, matching_precision=precision)
    port_config.check_supported(cfg)
    eng = Engine(cfg, "cpu")
    # "highest" maps to None, the matchers' default path (otgan_tpu/engine.py:80-84)
    assert eng.matching_precision == (None if precision == "highest" else precision)
    assert costs.resolve_precision(precision) == precision


def test_unknown_precision_rejected_with_the_jax_message():
    with pytest.raises(ValueError) as jax_err:
        jax_resolve_precision("fast")
    with pytest.raises(ValueError) as port_err:
        Engine(port_config.TrainConfig(matching_precision="fast"), "cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_cli_round_trip_into_config_json(tmp_path, monkeypatch):
    """``--matching_precision high`` through the trainer's CLI into its
    ``config.json``, which both packages read back."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "2")
    port_train.main(["--device", "cpu", "--model", "toy_mlp", "--batch_size", "16",
                     "--sinkhorn_lambda", "50", "--nr_sinkhorn_iter", "5", "--nr_gen_per_disc",
                     "1", "--max_epochs", "1", "--matching_precision", "high",
                     "--save_dir", str(tmp_path)])
    path = str(tmp_path / "config.json")
    assert json.load(open(path))["matching_precision"] == "high"
    assert port_config.TrainConfig.load(path).matching_precision == "high"
    assert JaxConfig.load(path).matching_precision == "high"


def _edge_values():
    rng = np.random.default_rng(0)
    ties = np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(-4, 5, dtype=np.float32)
    return np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(512) * 1e-30).astype(np.float32),
        (rng.standard_normal(512) * 1e30).astype(np.float32),
        ties, -ties, np.float32([0.0, -0.0, 1.0, -1.0, 2.0 ** -126, 3.0e38]),
    ])


def test_tf32_split_is_exact():
    a = torch.from_numpy(_edge_values())
    hi, lo = costs.tf32_split(a)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(hi + lo, a)
    assert (lo.abs() <= a.abs() * 2.0 ** -11).all()
    # round to nearest: hi is the nearer of the two TF32 neighbours
    down = (a.view(torch.int32) & -8192).view(torch.float32)
    assert ((a - hi).abs() <= (a - down).abs()).all()


@pytest.mark.parametrize("shape", [(33, 300, 17), (8, 4096, 8), (8, 4100, 8)],
                         ids=["ragged", "long-k", "uneven-long-k"])
def test_emulated_products_against_float64(shape):
    n, k, m = shape
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, k)).astype(np.float32)
    b = rng.standard_normal((k, m)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = {p: float(np.max(np.abs(costs.matmul(torch.from_numpy(a), torch.from_numpy(b),
                                                p).numpy() - exact) / scale))
           for p in ("highest", "high", "default")}
    assert err["highest"] <= 2.0 ** -20
    assert err["high"] <= 2.0 ** -20
    assert err["default"] <= 2.0 ** -10
    assert 8 * err["high"] < err["default"]  # the split is what buys the accuracy


@pytest.mark.parametrize("k", [4 * costs.HIGH_K_CHUNK, 3 * costs.HIGH_K_CHUNK + 5],
                         ids=["even-chunks", "ragged-chunks"])
def test_high_sums_a_long_k_in_chunks(monkeypatch, k):
    """A product whose K spans several ``HIGH_K_CHUNK`` chunks takes each
    of its 3 passes in chunks: one batched pass over equal chunks, else one
    pass a chunk; the result stays within 2^-20 of float64 relative to
    ``|A| @ |B|``."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 3)).astype(np.float32))
    calls = []
    real = costs._tf32_pass
    monkeypatch.setattr(costs, "_tf32_pass", lambda x, y: calls.append(tuple(x.shape)) or real(x, y))
    got = costs.matmul(a, b, "high")
    c = -(-k // costs.HIGH_K_CHUNK)
    if k % c:
        assert len(calls) == 3 * c and all(s[1] <= costs.HIGH_K_CHUNK for s in calls)
    else:
        assert calls == [(c, 4, k // c)] * 3
    exact = a.double() @ b.double()
    scale = a.abs().double() @ b.abs().double()
    assert float(((got.double() - exact).abs() / scale).max()) <= 2.0 ** -20


@pytest.mark.parametrize("single", [False, True], ids=["two-batch", "single-batch"])
def test_global_matchers_under_high_match_jax(single):
    B = 32
    fa, fb = _features(1, B), _features(2, B)
    port = matching.match_single_batch if single else matching.match_two_batch
    jax_fn = jax_match_single_batch if single else jax_match_two_batch
    got = port(torch.from_numpy(fa), torch.from_numpy(fb), LAM, ITERS, use_pallas=True,
               precision="high")
    want = jax_fn(jnp.asarray(fa), jnp.asarray(fb), LAM, ITERS, precision="high")
    _check([t.numpy() for t in got[:4]] + [float(got.entropy)], want)


def _gather(results):
    outs = [r[0] for r in results]
    return [np.concatenate([o[i] for o in outs]) for i in range(4)] + [outs[0][4]]


@pytest.mark.parametrize("layout", ["rows", "matrices"])
def test_sharded_matchers_under_high_match_jax(world2, layout):
    """Row-sharded and matrix-parallel on 2 gloo ranks under ``high``
    against the JAX matcher of the same layout on a 2-device mesh."""
    B = 16
    fa, fb = _features(3, B), _features(4, B)
    task, make = (("rows_matcher", jax_rows_two) if layout == "rows"
                  else ("matrix_matcher", jax_matrix_two))
    got = _gather(world2.run(task, fa=fa, fb=fb, lam=LAM, iters=ITERS, precision="high"))
    want = make(make_mesh(2), LAM, ITERS, use_pallas=True, precision="high")(
        jnp.asarray(fa), jnp.asarray(fb))
    _check(got, want)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_tf32_switch_is_scoped(monkeypatch, precision):
    """A caller that set TF32 on finds it on again after a match, and every
    matching matmul ran with TF32 as its precision says (off for highest)."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(costs.torch, "matmul", spy)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fa, fb = _features(5, 16), _features(6, 16)
        matching.match_two_batch(torch.from_numpy(fa), torch.from_numpy(fb), 50.0, 5,
                                 precision=precision)
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting is back
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    # 6 cost matmuls and 12 matched-feature ones, 3 passes each under high
    assert len(seen) == 18 * (3 if precision == "high" else 1)
    assert set(seen) == {precision != "highest"}
