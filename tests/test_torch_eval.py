"""The port's eval layer (``otgan_tpu_torch/eval/``) against the JAX
package's on the CPU: the same numpy inputs, made from seeds, through both.

* The network: pool features and logits of both variants with the
  fixed-seed He-scaled weights (``scaled_params(2024)``), float32, within
  1e-4 of the largest value (measured: ~5e-7).
* Bitwise: ``init_params`` / ``scaled_params`` trees for a seed, the npz
  files, the converters' output, the graphdef wire format.
* The golden fixtures of ``tests/test_inception_golden.py`` (resize,
  preprocessing, pooling), with their tolerances.
* The split-KL reductions (device and host) and the one-pass IS + FID
  scorer against the JAX ones on the same probabilities and images; the
  Frechet distance; the statistics file across packages.
* The golden pins of ``tests/test_eval_golden_pins.py``, reproduced by the
  port at that file's own tolerances.
"""

import contextlib
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the numpy BLAS pool then keeps its own size
    threadpool_limits = None

from otgan_tpu.eval import convert_tf2015_inception as jax_tf2015
from otgan_tpu.eval import convert_torch_inception as jax_tv
from otgan_tpu.eval import fid as jax_fid
from otgan_tpu.eval import graphdef as jax_gd
from otgan_tpu.eval import inception as jax_inc
from otgan_tpu.eval import inception_net as jax_net
from otgan_tpu.eval import random_weights as jax_rw
from otgan_tpu_torch.data.cifar10 import DataLoader
from otgan_tpu_torch.eval import convert_tf2015_inception as tf2015
from otgan_tpu_torch.eval import convert_torch_inception as tv
from otgan_tpu_torch.eval import fid as fid_mod
from otgan_tpu_torch.eval import graphdef as gd
from otgan_tpu_torch.eval import inception as inc
from otgan_tpu_torch.eval import inception_net as pnet
from otgan_tpu_torch.eval import random_weights as rw
from otgan_tpu_torch.eval.inception_net import InceptionV3

# the golden pins of tests/test_eval_golden_pins.py (values and tolerances)
IS_MEAN = 1.0160765195518469
IS_STD = 0.0010448366920140506
MU_NORM = 25.178570896546223
SIG_TRACE = 0.30917493054585166
REF_MU_NORM = 25.237122748069535
FID = 0.27727853457426554


@pytest.fixture(autouse=True)
def _two_threads():
    """Full-size InceptionV3 forwards: two intra-op threads. The suite runs
    several pytest workers at once, and oversubscribed thread pools made
    such tests several times slower than alone. numpy's BLAS pool (the FID's 2048^2
    eigendecompositions) is held to two threads too."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2) if threadpool_limits else contextlib.nullcontext():
        yield
    torch.set_num_threads(n)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _net(tree, variant="torchvision"):
    return InceptionV3.from_params(jax.tree.map(np.asarray, tree), variant, device="cpu")


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def _sampler(batches):
    return lambda seed: torch.from_numpy(batches[seed])


# ---------------------------------------------------------------------------
# weights: bitwise the JAX trees and files
# ---------------------------------------------------------------------------


def test_init_and_scaled_params_bitwise_equal_jax():
    """``scaled_params`` scales ``init_params``'s tree, so this holds both."""
    a, b = jax_rw.scaled_params(seed=2024), rw.scaled_params(seed=2024)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_random_weights_npz_round_trip_across_packages(tmp_path, monkeypatch):
    """The port's npz reloads to the identical tree and variant in the port
    and in the JAX package (one weights file serves both), and is the JAX
    writer's file byte for byte in every array."""
    path = str(tmp_path / "rw.npz")
    rw.main(["--out", path, "--seed", "2024"])
    assert inc.get_variant(path) == "tf2015"
    jax_path = jax_rw.save_npz(str(tmp_path / "rw_jax.npz"), seed=2024)
    with np.load(path) as mine, np.load(jax_path) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in mine.files:
            np.testing.assert_array_equal(mine[k], theirs[k])
    w = inc.load_params(path)
    assert w.variant == "tf2015"
    direct = rw.scaled_params(seed=2024)
    for x, y in zip(_leaves(w.params), _leaves(direct)):
        np.testing.assert_array_equal(x, y)
    monkeypatch.setattr(jax_inc, "_params_cache", None)
    monkeypatch.setattr(jax_inc, "_variant_cache", "torchvision")
    loaded = jax_inc.load_params(path)
    assert jax_inc.get_variant() == "tf2015"
    for x, y in zip(_leaves(loaded), _leaves(direct)):
        np.testing.assert_array_equal(x, y)
    monkeypatch.setattr(jax_inc, "_params_cache", None)


def test_load_params_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("OTGAN_INCEPTION_WEIGHTS", str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError, match="random_weights"):
        inc.load_params()
    flat = pnet.flatten_tree(pnet.init_params(np.random.default_rng(0), num_classes=5))
    flat["Mixed_6a/b3x3/w"] = np.zeros((3, 3, 288, 385), np.float32)
    np.savez(tmp_path / "bad.npz", **flat)
    with pytest.raises(ValueError, match="Mixed_6a/b3x3/w"):
        inc.load_params(str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="lacks"):
        InceptionV3(5).load_flat({**flat, "Mixed_9z/w": np.zeros(1)})


# ---------------------------------------------------------------------------
# the network against the JAX one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["torchvision", "tf2015"])
def test_network_matches_jax(variant):
    """Pool features and logits for 2 images at 299^2 with the He-scaled
    weights (IS != 1 there): within 1e-4 of the largest value."""
    tree = jax_rw.scaled_params(seed=2024)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 299, 299, 3)).astype(np.float32)
    want_f = np.asarray(jax_net.pool_features(tree, jnp.asarray(x), variant=variant))
    want_l = np.asarray(jax_net.apply(tree, jnp.asarray(x), variant=variant))
    net = _net(tree, variant)
    with inc.scoring_mode():
        got_f = net.pool_features(torch.from_numpy(x)).numpy()
        got_l = net(torch.from_numpy(x)).numpy()
    assert got_f.shape == (2, 2048) and got_l.shape == (2, 1008)
    assert _rel(got_f, want_f) <= 1e-4
    assert _rel(got_l, want_l) <= 1e-4


def test_variant_changes_pooling():
    tree = pnet.init_params(np.random.default_rng(4), num_classes=10)
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 299, 299, 3))
                         .astype(np.float32))
    with inc.scoring_mode():
        f_tv = _net(tree, "torchvision").pool_features(x)
        f_tf = _net(tree, "tf2015").pool_features(x)
    assert bool(torch.isfinite(f_tf).all())
    assert float((f_tv - f_tf).abs().max()) > 1e-6


def test_scoring_mode_restores_tf32_flags():
    keep = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with inc.scoring_mode():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.is_inference_mode_enabled()
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep


# ---------------------------------------------------------------------------
# twins of tests/test_inception_golden.py and the preprocessing against JAX
# ---------------------------------------------------------------------------


def _resize(x, h, w):
    return inc._resize_bilinear_tf1(torch.from_numpy(np.asarray(x, np.float32)), h, w).numpy()


def test_resize_bilinear_tf1_ramp_golden():
    """2x2 ramp upscaled to 3x3: legacy sampling puts the source grid at
    [0, 2/3, 4/3], so out = row + col with row [0, 4/3, 2], col [0, 2/3, 1]."""
    x = np.arange(4, dtype=np.float32).reshape(1, 2, 2, 1)
    got = _resize(x, 3, 3)[0, :, :, 0]
    want = np.asarray([0.0, 4.0 / 3.0, 2.0])[:, None] + np.asarray([0.0, 2.0 / 3.0, 1.0])[None, :]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_bilinear_tf1_is_not_half_pixel():
    x = np.arange(4, dtype=np.float32).reshape(1, 2, 2, 1)
    got = _resize(x, 3, 3)[0, :, :, 0]
    half = np.asarray([0.0, 1.0, 2.0])[:, None] + np.asarray([0.0, 0.5, 1.0])[None, :]
    assert np.max(np.abs(got - half)) > 0.1


def test_resize_bilinear_tf1_identity_and_downscale():
    x = np.random.default_rng(0).uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(_resize(x, 4, 4), x, atol=0)
    np.testing.assert_allclose(_resize(x, 2, 2), x[:, ::2, ::2, :], atol=0)


def test_preprocess_tf2015_scaling_golden():
    for value, want_tf in [(255.0, 127.0 / 128.0), (0.0, -1.0), (128.0, 0.0)]:
        out = inc.preprocess(torch.full((1, 32, 32, 3), value), variant="tf2015").numpy()
        assert out.shape == (1, 299, 299, 3)
        np.testing.assert_allclose(out, want_tf, atol=1e-6)
    out_tv = inc.preprocess(torch.full((1, 32, 32, 3), 255.0), variant="torchvision").numpy()
    np.testing.assert_allclose(out_tv, 1.0, atol=1e-6)


@pytest.mark.parametrize("variant", ["torchvision", "tf2015"])
def test_preprocess_matches_jax(variant):
    """32^2 -> 299^2: torchvision is the half-pixel upsample
    (``F.interpolate`` against ``jax.image.resize``), tf2015 the legacy
    gather; float32, within 1e-5 absolute of values in [-1, 1]."""
    x = np.random.default_rng(1).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_inc.preprocess(jnp.asarray(x), variant))
    got = inc.preprocess(torch.from_numpy(x), variant).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_avgpool3_exclude_pad_edge_divisors_golden():
    x = torch.arange(1.0, 10.0).reshape(1, 1, 3, 3)  # NCHW inside the port
    sums = np.asarray([[12, 21, 16], [27, 45, 33], [24, 39, 28]], np.float32)
    counts = np.asarray([[4, 6, 4], [6, 9, 6], [4, 6, 4]], np.float32)
    got_ex = pnet._avgpool3(x, exclude_pad=True)[0, 0].numpy()
    np.testing.assert_allclose(got_ex, sums / counts, atol=1e-6)
    got_in = pnet._avgpool3(x, exclude_pad=False)[0, 0].numpy()
    np.testing.assert_allclose(got_in, sums / 9.0, atol=1e-6)
    assert np.sum(np.abs(got_ex - got_in) > 1e-6) == 8


def test_mixed10_pool_branch_is_max_golden():
    """3x3/stride-1 SAME max pool, padded with -inf: on an all-negative
    input a zero pad would leak 0 into the borders."""
    x = np.full((1, 1, 3, 3), -5.0, np.float32)
    x[0, 0, 0, 0] = 7.0
    got = pnet._maxpool(torch.from_numpy(x), 3, 1, same=True)[0, 0].numpy()
    want = np.asarray([[7, 7, -5], [7, 7, -5], [-5, -5, -5]], np.float32)
    np.testing.assert_allclose(got, want, atol=0)


def test_inception_e_pool_max_changes_output():
    rng = np.random.default_rng(1)
    cin = 8
    spec = pnet._spec_e(cin)
    flat = {}
    for unit, leaves in spec.items():
        for leaf, shape in leaves.items():
            w = rng.standard_normal(shape).astype(np.float32) * 0.1
            flat[f"{unit}/{leaf}"] = np.abs(w) + 0.5 if leaf == "var" else w
    blocks = []
    for pool_max in (False, True):
        block = pnet.InceptionE(cin, pool_max=pool_max)
        tensors = {**dict(block.named_parameters()), **dict(block.named_buffers())}
        with torch.no_grad():
            for key, arr in flat.items():
                unit, leaf = key.split("/")
                t = torch.from_numpy(arr)
                tensors[f"{unit}.{'weight' if leaf == 'w' else leaf}"].copy_(
                    t.permute(3, 2, 0, 1) if t.dim() == 4 else t)
        blocks.append(block)
    x = torch.from_numpy(rng.standard_normal((1, cin, 5, 5)).astype(np.float32))
    with torch.no_grad():
        out_avg, out_max = blocks[0](x), blocks[1](x)
        want = jax_net._inception_e(
            {u: {k: jnp.asarray(flat[f"{u}/{k}"]) for k in spec[u]} for u in spec},
            jnp.asarray(x.permute(0, 2, 3, 1).numpy()), pool_max=True)
    assert out_avg.shape == out_max.shape
    assert float((out_avg - out_max).abs().max()) > 1e-6
    np.testing.assert_allclose(out_max.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# score math and the reductions, on the same probabilities as the JAX ones
# ---------------------------------------------------------------------------


def _zero_probs(n=400, c=10, seed=7):
    preds = np.random.default_rng(seed).dirichlet(np.full(c, 0.3), size=n).astype(np.float32)
    preds[preds < 0.05] = 0.0  # exact zeros, as an underflowed float32 softmax gives
    return preds / preds.sum(1, keepdims=True)


def test_score_math_limits():
    mean, std = inc.inception_score_from_preds(np.full((500, 10), 0.1), splits=10)
    assert abs(mean - 1.0) < 1e-9 and std < 1e-9
    n, c = 1000, 10
    preds = np.full((n, c), 1e-12)
    preds[np.arange(n), np.arange(n) % c] = 1.0
    preds /= preds.sum(1, keepdims=True)
    assert abs(inc.inception_score_from_preds(preds, splits=10)[0] - c) / c < 1e-3
    preds = np.full((300, c), 1e-12)
    preds[:, 3] = 1.0
    assert abs(inc.inception_score_from_preds(preds / preds.sum(1, keepdims=True))[0] - 1) < 1e-3


@pytest.mark.parametrize("n,splits", [(400, 10), (13, 3)])
def test_split_reductions_match_jax(n, splits):
    """The host float64 score and the device split statistics (fed in
    ragged chunks) against the JAX package's on the same probabilities with
    exact zeros: host bitwise, device within 1e-5 (float32 sums)."""
    preds = _zero_probs(n=n)
    host = inc.inception_score_from_preds(preds, splits=splits)
    assert host == jax_inc.inception_score_from_preds(preds, splits=splits)
    assert all(np.isfinite(host))

    stats = inc.SplitStats(n, splits, preds.shape[1], "cpu")
    for start in range(0, n, 7):  # chunks that straddle the split edges
        stats.update(torch.from_numpy(preds[start:start + 7]), start)
    s1 = jnp.zeros((splits, preds.shape[1]), jnp.float32)
    s2 = jnp.zeros((splits,), jnp.float32)
    upper = jnp.asarray([n * (i + 1) // splits for i in range(splits)], jnp.int32)
    s1, s2, _ = jax_inc._split_update(jnp.asarray(preds), jnp.int32(0), jnp.int32(n),
                                      jnp.int32(n), upper, s1, s2)
    np.testing.assert_allclose(stats.s1.numpy(), np.asarray(s1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats.s2.numpy(), np.asarray(s2), rtol=1e-5, atol=1e-5)
    dev = stats.finalize()
    want = jax_inc._finalize_split_scores(s1, s2, n, splits)
    np.testing.assert_allclose(dev[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(dev[0], host[0], rtol=1e-4)


def test_stream_chunks_rejects_nonpositive_batch():
    with pytest.raises(ValueError, match="must be >= 1"):
        next(inc._stream_chunks(lambda s: None, 10, 0))
    with pytest.raises(ValueError, match="must be >= 1"):
        next(inc._stream_chunks(lambda s: None, 10, -100))


def test_stream_chunks_cut_ragged_tails_and_overrun():
    """Batches of 5, classifier batch 4, 13 samples: chunks 4, 1 | 4, 1 |
    3 (the rest of the third batch lies past num_samples)."""
    batches = [np.full((5, 2, 2, 3), i, np.float32) for i in range(3)]
    got = [(tuple(c.shape), s) for c, s in inc._stream_chunks(_sampler(batches), 13, 4)]
    assert got == [((4, 2, 2, 3), 0), ((1, 2, 2, 3), 4), ((4, 2, 2, 3), 5),
                   ((1, 2, 2, 3), 9), ((3, 2, 2, 3), 10)]


def test_get_inception_score_range_guard():
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        inc.get_inception_score(np.zeros((4, 32, 32, 3), np.float32), splits=2,
                                net=InceptionV3(5))


# ---------------------------------------------------------------------------
# the scorers on images, against the JAX ones
# ---------------------------------------------------------------------------


def test_scorers_match_jax_on_ragged_samples(monkeypatch):
    """3 generated batches of 3 at 16^2, classifier batch 2, 7 samples, 3
    splits (2/2/3): chunks of 2 and 1 rows and a batch past the last
    sample. The combined scorer, the device- and host-reduced scores and
    the host paths against the JAX package's combined scorer on the same
    images and tf2015 He-scaled weights (IS ~1.03). IS within 1e-5 and its
    std within 1e-3 relative, mu within 1e-4 and sigma within 1e-3 of their
    largest values."""
    monkeypatch.setattr(jax_inc, "_BATCH", 2)
    rng = np.random.default_rng(3)
    tree = jax_rw.scaled_params(seed=5)
    batches = [rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    (m_j, s_j), (mu_j, sig_j) = jax_fid.combined_eval_from_sampler(
        lambda i: jnp.asarray(batches[i]), 7, splits=3, params=tree, variant="tf2015")
    net = _net(tree, "tf2015")
    (m_c, s_c), (mu_c, sig_c) = fid_mod.combined_eval_from_sampler(
        _sampler(batches), 7, splits=3, net=net, batch=2)
    m_d, s_d = inc.inception_score_from_sampler(_sampler(batches), 7, 3, net=net, batch=2,
                                                device_reduce=True)
    m_h, s_h = inc.inception_score_from_sampler(_sampler(batches), 7, 3, net=net, batch=2,
                                                device_reduce=False)
    assert m_j > 1.01  # the He-scaled head gives a score that depends on the images
    for m, s in ((m_c, s_c), (m_d, s_d), (m_h, s_h)):
        np.testing.assert_allclose(m, m_j, rtol=1e-5)
        np.testing.assert_allclose(s, s_j, rtol=1e-3)
    assert _rel(mu_c, mu_j) <= 1e-4 and _rel(sig_c, sig_j) <= 1e-3
    # the host path over the same 7 images
    stacked = 127.5 * (np.concatenate(batches)[:7] + 1.0)
    m_g, _ = inc.get_inception_score(stacked, splits=3, net=net, batch=2)
    np.testing.assert_allclose(m_g, m_h, rtol=1e-6)
    mu_p, sig_p = fid_mod.feature_statistics(fid_mod.pool_features(stacked, net=net, batch=2))
    # float32 raw moments on the device against float64 on the host: the
    # JAX package's own test of this holds sigma to 1e-3 too
    assert _rel(mu_p, mu_c) <= 1e-5 and _rel(sig_p, sig_c) <= 1e-3
    # the streamed feature statistics (feature_statistics_from_sampler)
    # against the host ones: a Frechet distance near 0
    assert abs(fid_mod.fid_from_sampler(_sampler(batches), 7, mu_p, sig_p, net=net,
                                        batch=2)) < 1e-2


def test_eval_chain_golden_pins():
    """``tests/test_eval_golden_pins.py`` through the port: the tf2015
    He-scaled weights (seed 2024), 32 generated images in two batches of
    16, 32 reference images; the pinned values at that file's tolerances."""
    net = _net(rw.scaled_params(seed=2024), "tf2015")
    img_rng = np.random.default_rng(2025)
    gen_imgs = img_rng.integers(0, 256, (32, 32, 32, 3)).astype(np.float32)
    ref_imgs = img_rng.integers(0, 256, (32, 32, 32, 3)).astype(np.float32)
    batches = [gen_imgs[i * 16:(i + 1) * 16] / 127.5 - 1.0 for i in range(2)]
    (m, s), (mu, sig) = fid_mod.combined_eval_from_sampler(_sampler(batches), 32, splits=2,
                                                           net=net, batch=16)
    mu_r, sig_r = fid_mod.feature_statistics(fid_mod.pool_features(ref_imgs, net=net, batch=16))
    f = fid_mod.frechet_distance(mu, sig, mu_r, sig_r)
    np.testing.assert_allclose(m, IS_MEAN, rtol=2e-4)
    np.testing.assert_allclose(s, IS_STD, rtol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(mu), MU_NORM, rtol=1e-4)
    np.testing.assert_allclose(np.trace(sig), SIG_TRACE, rtol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(mu_r), REF_MU_NORM, rtol=1e-4)
    np.testing.assert_allclose(f, FID, rtol=1e-3)


# ---------------------------------------------------------------------------
# FID math and the statistics file
# ---------------------------------------------------------------------------


def test_frechet_distance_matches_jax_and_analytic():
    rng = np.random.default_rng(5)
    fa, fb = rng.standard_normal((500, 16)), rng.standard_normal((400, 16)) + 0.3
    sa, sb = fid_mod.feature_statistics(fa), fid_mod.feature_statistics(fb)
    assert fid_mod.frechet_distance(*sa, *sb) == jax_fid.frechet_distance(*sa, *sb)
    assert abs(fid_mod.frechet_distance(*sa, *sa)) < 1e-8
    d, a, b = 8, 2.0, 0.5
    got = fid_mod.frechet_distance(np.zeros(d), a * np.eye(d), np.full(d, 0.5), b * np.eye(d))
    assert abs(got - (0.25 * d + d * (a + b - 2 * np.sqrt(a * b)))) < 1e-9


def test_reference_statistics_file_across_packages(tmp_path):
    """One package writes, the other loads; the variant guard holds in both."""
    mu, sigma = np.arange(4, dtype=np.float64), np.eye(4) * 2.0
    for write, read in ((fid_mod, jax_fid), (jax_fid, fid_mod)):
        p = str(tmp_path / f"{write.__name__}.npz")
        write.save_reference_statistics(p, mu, sigma, "tf2015", 50000)
        mu2, sig2 = read.load_reference_statistics(p, expect_variant="tf2015")
        np.testing.assert_array_equal(mu, mu2)
        np.testing.assert_array_equal(sigma, sig2)
        with pytest.raises(ValueError, match="variant"):
            read.load_reference_statistics(p, expect_variant="torchvision")
        with np.load(p) as data:
            assert int(data["count"]) == 50000


def test_fid_stats_cli_images_readable_by_jax(tmp_path, monkeypatch):
    """``python -m otgan_tpu_torch.eval.fid --images`` on an NCHW stack with
    --limit: the file loads in the JAX package, holds the port's own
    statistics of the same images and the count."""
    monkeypatch.setenv("OTGAN_INCEPTION_WEIGHTS", rw.save_npz(
        str(tmp_path / "w.npz"), seed=0, variant="torchvision", num_classes=5))
    imgs = np.random.default_rng(1).integers(0, 256, (7, 3, 16, 16), np.uint8)  # NCHW
    src = str(tmp_path / "imgs.npy")
    np.save(src, imgs)
    out = str(tmp_path / "stats.npz")
    monkeypatch.setenv("OTGAN_INCEPTION_BATCH", "2")
    fid_mod.main(["--images", src, "--out", out, "--limit", "3", "--device", "cpu"])
    mu, sigma = jax_fid.load_reference_statistics(out, expect_variant="torchvision")
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    ref = fid_mod.reference_statistics(np.transpose(imgs[:3], (0, 2, 3, 1)),
                                       net=inc.load_net(device="cpu"), batch=3)
    np.testing.assert_allclose(mu, ref[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sigma, ref[1], rtol=1e-4, atol=1e-7)
    with np.load(out) as data:
        assert int(data["count"]) == 3


def test_loader_labels_and_images_255_match_jax():
    """``images_255`` and labelled batches against the JAX loader on the
    same uint8 data, labels and seed."""
    from otgan_tpu.data.cifar10 import DataLoader as JaxLoader

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (20, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 20).astype(np.uint8)
    port = DataLoader("", batch_size=8, rng=np.random.default_rng(3), data=data, labels=labels,
                      return_labels=True)
    ref = JaxLoader("", batch_size=8, rng=np.random.default_rng(3), data=data, labels=labels,
                    return_labels=True, out_dtype="uint8")
    np.testing.assert_array_equal(port.images_255(), ref.images_255())
    np.testing.assert_array_equal(port.images_255(5), ref.images_255(5))
    for (x, y), (xr, yr) in zip(port.epoch(), ref.epoch()):
        np.testing.assert_array_equal(x, np.asarray(xr))
        np.testing.assert_array_equal(y, yr)
    with pytest.raises(ValueError, match="labels"):
        DataLoader("", batch_size=8, data=data, return_labels=True)


# ---------------------------------------------------------------------------
# converters: synthetic graphdefs and state dicts, as tests/test_graphdef.py
# ---------------------------------------------------------------------------


def _synth_tf2015_consts(rng):
    """Constants with the 2015 graph's names and the real shapes."""
    spec = pnet.param_spec(num_classes=tf2015.TF2015_NUM_CLASSES)
    consts = {}

    def add_unit(scope, wshape):
        cout = wshape[-1]
        consts[f"{scope}/conv2d_params"] = (0.05 * rng.standard_normal(wshape)).astype(np.float32)
        consts[f"{scope}/batchnorm/beta"] = (0.01 * rng.standard_normal((cout,))).astype(
            np.float32)
        consts[f"{scope}/batchnorm/gamma"] = np.ones((cout,), np.float32)
        consts[f"{scope}/batchnorm/moving_mean"] = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
        consts[f"{scope}/batchnorm/moving_variance"] = rng.uniform(0.5, 2, cout).astype(
            np.float32)

    for key, scope in tf2015.BLOCK_SCOPES.items():
        if isinstance(scope, str):
            add_unit(scope, spec[key]["w"])
        else:
            prefix, table = scope
            for sub in spec[key]:
                add_unit(f"{prefix}/{table[sub]}", spec[key][sub]["w"])
    consts["softmax/weights"] = (0.02 * rng.standard_normal((2048, 1008))).astype(np.float32)
    consts["softmax/biases"] = np.zeros((1008,), np.float32)
    return consts


def test_graphdef_wire_format_across_packages():
    rng = np.random.default_rng(0)
    consts = {
        "a/b/c": rng.standard_normal((3, 5, 2, 7)).astype(np.float32),
        "scalar": np.asarray(3.25, np.float32).reshape(()),
        "ints": np.arange(12, dtype=np.int32).reshape(3, 4),
    }
    raw = gd.encode_graphdef(consts)
    assert raw == jax_gd.encode_graphdef(consts)
    for got in (gd.extract_constants(raw), jax_gd.extract_constants(raw)):
        assert set(got) == set(consts)
        for k in consts:
            np.testing.assert_array_equal(got[k], consts[k])
            assert got[k].dtype == consts[k].dtype


def test_tf2015_convert_matches_jax_and_loads(tmp_path):
    """The converter CLI on a synthetic frozen graph (digest pinned): the
    same npz as the JAX converter's, which loads into the port's network
    as the tf2015 variant and classifies into 1008 classes."""
    consts = _synth_tf2015_consts(np.random.default_rng(1))
    pb = tmp_path / "classify_image_graph_def.pb"
    raw = gd.encode_graphdef(consts)
    pb.write_bytes(raw)
    out, out_jax = tmp_path / "w.npz", tmp_path / "w_jax.npz"
    tf2015.main(["--pb", str(pb), "--out", str(out),
                 "--expect_sha256", hashlib.sha256(raw).hexdigest()])
    jax_tf2015.convert(str(pb), str(out_jax))
    with np.load(out) as mine, np.load(out_jax) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in mine.files:
            np.testing.assert_array_equal(mine[k], theirs[k])
    w = inc.load_params(str(out))
    assert w.variant == "tf2015"
    np.testing.assert_array_equal(w.params["Mixed_7c"]["b3x3_2b"]["w"],
                                  consts["mixed_10/tower/mixed/conv_1/conv2d_params"])
    net = inc.load_net(str(out), device="cpu")
    assert net.variant == "tf2015" and net.Mixed_7c.pool_max
    with pytest.raises(ValueError, match="digest mismatch"):
        tf2015.convert(str(pb), str(tmp_path / "o.npz"), expect_sha256="0" * 64)
    broken = dict(consts)
    del broken["mixed_4/tower_1/conv_2/conv2d_params"]
    with pytest.raises(KeyError, match="mixed_4/tower_1/conv_2"):
        tf2015.map_tf2015_weights(broken)


def test_torch_state_dict_convert_matches_jax(tmp_path):
    """A torchvision-named state dict (inverting the converter's maps, with
    AuxLogits and num_batches_tracked to be dropped) converts to the JAX
    converter's flat dict exactly; the CLI writes it from a .pth file, and
    it loads into the port's network."""
    rng = np.random.default_rng(2)
    inv_branch = {v: k for k, v in tv._BRANCH_MAP.items()}
    inv_part = {v: k for k, v in tv._PART_MAP.items()}
    sd = {"AuxLogits.fc.weight": torch.zeros(3),
          "Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(1)}
    for key, shape in pnet.flatten_tree(pnet.param_spec(num_classes=1000)).items():
        parts = key.split("/")
        arr = rng.standard_normal(shape).astype(np.float32)
        if parts[0] == "fc":
            sd[f"fc.{'weight' if parts[1] == 'w' else 'bias'}"] = torch.from_numpy(
                arr.T.copy() if parts[1] == "w" else arr)
            continue
        if len(shape) == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        name = (f"{parts[0]}.{inv_part[parts[1]]}" if len(parts) == 2 else
                f"{parts[0]}.{inv_branch[parts[1]]}.{inv_part[parts[2]]}")
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    mine, theirs = tv.convert_state_dict(sd), jax_tv.convert_state_dict(sd)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    torch.save(sd, tmp_path / "inception.pth")
    out = tv.main(["--src", str(tmp_path / "inception.pth"), "--dst", str(tmp_path / "w.npz")])
    w = inc.load_params(out)
    assert w.variant == "torchvision"  # no marker: the torchvision variant
    np.testing.assert_array_equal(w.params["Mixed_6e"]["b7x7dbl_3"]["w"],
                                  mine["Mixed_6e/b7x7dbl_3/w"])
