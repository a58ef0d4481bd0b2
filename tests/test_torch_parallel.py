"""The port's multi-rank training against the JAX package's mesh code, on
worlds of 2 and 4 CPU processes joined by gloo (``tests/test_torch_parallel_worker.py``).

The same numpy features go to the JAX matcher on ``make_mesh(K)`` of the 8
virtual CPU devices (its Pallas local step in interpret mode) and to the
port's matcher on K ranks (its plain local step, the kernels' CPU version).
Limits: matched features 2e-4 and entropy 1e-4 (tests/test_matching_sharded.py);
at lam = 500 the band of the float32 loops, 1e-4 for both. The row-sharded
matcher shifts each logits row by its max, the JAX one does not: that is
rounding, inside the limits. The matrix-parallel matchers run the same
arithmetic as the port's global matcher and agree with it to rounding
(1e-5).

The engine: full-width DCGAN at batch 8, float32, lam 500 with 50
iterations, one critic step and one generator step on 2 ranks, each from the
JAX state before it, against the JAX engine on a 2-device mesh and against
the port's 1-device engine fed the batch in the row-sharded matcher's order
(``sharded_permutation``). Parameters are held to the bound of
tests/test_torch_engine.py.
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu.parallel.matching_matrix import (
    make_matrix_parallel_single_batch_matcher as jax_matrix_single,
)
from otgan_tpu.parallel.matching_matrix import (
    make_matrix_parallel_two_batch_matcher as jax_matrix_two,
)
from otgan_tpu.parallel.matching_sharded import (
    make_sharded_single_batch_matcher as jax_rows_single,
)
from otgan_tpu.parallel.matching_sharded import (
    make_sharded_two_batch_matcher as jax_rows_two,
)
from otgan_tpu.parallel.mesh import make_mesh
from otgan_tpu_torch import config as port_config
from otgan_tpu_torch.convert import state_from_jax, unflatten_params
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.ops import matching
from otgan_tpu_torch.ops.sinkhorn_step_cuda import local_step_mode
from otgan_tpu_torch.parallel import matching_matrix, matching_sharded
from tests.test_torch_engine import _param_check
from tests.test_torch_parallel_worker import World

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world2():
    w = World(2)
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(seed, n, d=32):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _gather(results):
    """Concatenate the ranks' row blocks; the entropy must agree."""
    outs = [r[0] if isinstance(r, tuple) else r for r in results]
    ents = [o[4] for o in outs]
    assert max(ents) == min(ents), ents
    return [np.concatenate([o[i] for o in outs]) for i in range(4)] + [ents[0]]


def _check(got, want, atol, ent_atol=1e-4):
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol)
    assert abs(got[4] - float(want[4])) < ent_atol


def _jax(make, k, fa, fb, lam, iters, **kw):
    mesh = make_mesh(k)
    return make(mesh, lam, iters, **kw)(jnp.asarray(fa), jnp.asarray(fb))


@pytest.mark.parametrize(
    "k,B,lam,iters,atol",
    [(2, 16, 50.0, 30, 2e-4), (2, 16, 500.0, 30, 1e-4),
     (4, 20, 50.0, 30, 2e-4), (4, 20, 500.0, 30, 1e-4)],
    ids=["even-k2-lam50", "even-k2-lam500", "uneven-k4-lam50", "uneven-k4-lam500"],
)
def test_rows_two_batch_matches_jax(world2, world4, k, B, lam, iters, atol):
    """K 2: whole local halves (B/2 = 8 divides); K 4: padded halves
    (B/2 = 10 does not), rows in the global matcher's order."""
    fa, fb = _features(1, B), _features(2, B)
    world = world2 if k == 2 else world4
    res = world.run("rows_matcher", fa=fa, fb=fb, lam=lam, iters=iters)
    got = _gather(res)
    want = _jax(jax_rows_two, k, fa, fb, lam, iters, use_pallas=True)
    _check(got, want, atol)
    n_loc = -(-(B // 2) // k)
    assert local_step_mode(n_loc, k * n_loc) == "fused"
    assert all(r[1] == {"fused": 0, "stream": 0, "plain": iters} for r in res)


def test_rows_even_path_is_global_matcher_permuted(world2):
    """The local-half convention is the global matcher on the permuted
    batch (``sharded_permutation``), row for row."""
    B = 16
    fa, fb = _features(3, B), _features(4, B)
    got = _gather(world2.run("rows_matcher", fa=fa, fb=fb, lam=50.0, iters=30))
    perm = np.asarray(matching_sharded.sharded_permutation(B, 2))
    inv = np.argsort(perm)
    m = matching.match_two_batch(torch.from_numpy(fa[perm]), torch.from_numpy(fb[perm]),
                                 50.0, 30, use_pallas=True)
    want = [t.numpy()[inv] for t in m[:4]] + [float(m.entropy)]
    _check(got, want, 1e-5, 1e-6)


def test_rows_single_batch_uneven_matches_jax(world4):
    """B 18 on 4 ranks: blocks of 5, the last two rows padding."""
    B = 18
    fa, fb = _features(5, B), _features(6, B)
    pad = np.zeros((2, 32), np.float32)
    res = world4.run("rows_matcher", fa=np.concatenate([fa, pad]),
                     fb=np.concatenate([fb, pad]), lam=50.0, iters=30, single=True, batch=B)
    got = [t[:B] for t in _gather(res)[:4]] + [res[0][0][4]]
    want = _jax(jax_rows_single, 4, fa, fb, 50.0, 30, use_pallas=True)
    _check(got, want, 2e-4)
    assert local_step_mode(5, 20) == "fused"


def test_rows_tol_exit_matches_jax(world2):
    B = 16
    fa, fb = _features(7, B), _features(8, B)
    got = _gather(world2.run("rows_matcher", fa=fa, fb=fb, lam=50.0, iters=200, tol=1e-4))
    want = _jax(jax_rows_two, 2, fa, fb, 50.0, 200, use_pallas=True, tol=1e-4)
    _check(got, want, 2e-4)


@pytest.mark.parametrize("single", [False, True], ids=["two-batch", "single-batch"])
def test_matrix_parallel_matches_jax_and_global(world4, single):
    """K 4 owns 6 (two-batch) or 3 (single-batch) matrices: the first two,
    or the first, have two owners and weight 1/2."""
    B = 16
    fa, fb = _features(9, B), _features(10, B)
    rounds, counts = matching_matrix._owner_counts(3 if single else 6, 4)
    assert counts == ([2, 1, 1] if single else [2, 2, 1, 1, 1, 1])
    got = _gather(world4.run("matrix_matcher", fa=fa, fb=fb, lam=50.0, iters=30,
                             single=single))
    make = jax_matrix_single if single else jax_matrix_two
    _check(got, _jax(make, 4, fa, fb, 50.0, 30, use_pallas=True), 2e-4)
    glob = matching.match_single_batch if single else matching.match_two_batch
    m = glob(torch.from_numpy(fa), torch.from_numpy(fb), 50.0, 30, use_pallas=True)
    _check(got, [t.numpy() for t in m[:4]] + [float(m.entropy)], 1e-5, 1e-6)


def test_matrix_parallel_takes_the_grid_tier(world4):
    """Whole 550^2 matrices, above the resident tier (512^2 cells), on 4
    ranks: each rank solves 2 of the 6 (8 slots, matrices 0 and 1 twice),
    each through the grid tier's plain version and no other tier, and the
    outputs are the global matcher's."""
    B = 1100
    fa, fb = _features(11, B), _features(12, B)
    res = world4.run("matrix_matcher", fa=fa, fb=fb, lam=50.0, iters=20)
    rounds, _ = matching_matrix._owner_counts(6, 4)
    assert rounds == 2
    for launches in (r[1] for r in res):
        assert launches["grid_plain"] == rounds
        assert sum(launches.values()) == rounds, launches
    m = matching.match_two_batch(torch.from_numpy(fa), torch.from_numpy(fb), 50.0, 20,
                                 use_pallas=True)
    _check(_gather(res), [t.numpy() for t in m[:4]] + [float(m.entropy)], 1e-5, 1e-6)


def _plain_tree(x):
    """A JAX state after ``device_get`` as dicts of numpy arrays."""
    if hasattr(x, "_fields"):
        return {k: _plain_tree(getattr(x, k)) for k in x._fields}
    if isinstance(x, dict):
        return {k: _plain_tree(v) for k, v in x.items()}
    return np.asarray(x)


def test_engine_two_ranks_match_jax_and_one_device(world2, tmp_path):
    B = 8
    kw = dict(model="dcgan", batch_size=B, compute_dtype="float32", nr_sinkhorn_iter=50,
              matching_layout="rows")
    eng_j = JaxEngine(JaxConfig(num_devices=2, **kw))
    rng = np.random.default_rng(0)
    x_init = rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    xs = [rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8) for _ in range(2)]
    state_j, _ = eng_j.init_state(0, eng_j.shard(x_init))
    eng_1 = Engine(port_config.TrainConfig(num_devices=1, **kw), device="cpu")
    state_1, _ = eng_1.init_state(0, x_init)
    perm = np.asarray(matching_sharded.sharded_permutation(B, 2))
    bound = 2 * port_config.TrainConfig().learning_rate_gen
    for i, (kind, x) in enumerate(zip(["disc", "gen"], xs)):
        host = jax.device_get(state_j)
        path = tmp_path / f"state{i}.pkl"
        with open(path, "wb") as f:
            pickle.dump(_plain_tree(host), f)
        z = np.asarray(jax.random.uniform(
            jax.random.split(state_j.rng)[1], (B, 100), minval=-1.0, maxval=1.0))
        res = world2.run("engine_step", cfg=dict(num_devices=2, **kw), state_path=str(path),
                         x_init=x_init, x=x, z=z, kind=kind)
        jstep = eng_j.disc_step if kind == "disc" else eng_j.gen_step
        state_j, met_j = jstep(state_j, eng_j.shard(x))
        state_1 = state_from_jax(eng_1, state_1, host)
        step_1 = eng_1.disc_step if kind == "disc" else eng_1.gen_step
        state_1, met_1 = step_1(state_1, x[perm], z[perm])
        r0 = res[0]
        assert r0["nf"] == 32768 and r0["init_spread"] == 0.0
        assert r0["desc"] == "row-sharded (two-batch, whole local halves on the 2-device mesh)"
        assert res[1]["dist"] == r0["dist"] and res[1]["entropy"] == r0["entropy"]
        for ref in (met_j, met_1):
            assert abs(r0["dist"] - float(ref.dist)) < 1e-4, (i, kind)
            assert abs(r0["entropy"] - float(ref.entropy)) < 1e-4, (i, kind)
        want_j = getattr(jax.device_get(state_j), f"{kind}_params")
        _param_check(r0["params"], want_j, bound, f"{kind} vs jax")
        module = state_1.disc if kind == "disc" else state_1.gen
        _param_check(r0["params"], unflatten_params(dict(module.named_parameters())),
                     bound, f"{kind} vs 1-device")


def test_engine_matcher_dispatch_on_two_ranks(world2):
    """The engine's multi-rank dispatch: the gathered global matcher
    (``--no_sharded_matching``), the random ablation (a roll by one shard),
    and ``auto`` resolving to matrices and, under a small budget, rows; the
    descriptions are the JAX engine's."""
    B, d = 16, 32
    fa, fb = _features(11, B, d), _features(12, B, d)
    base = dict(batch_size=B, num_devices=2, sinkhorn_lambda=50.0, nr_sinkhorn_iter=30)
    cfgs = [dict(base, sharded_matching=False), dict(base, no_sinkhorn=True),
            dict(base), dict(base, matching_memory_budget_gb=1e-6)]
    res = world2.run("engine_matchers", fa=fa, fb=fb, cfgs=cfgs)
    desc = [d for d, _ in res[0]]
    got = [_gather([r[i][1] for r in res]) for i in range(len(cfgs))]
    ta, tb = torch.from_numpy(fa), torch.from_numpy(fb)
    want = matching.match_two_batch(ta, tb, 50.0, 30, use_pallas=True)
    want = [t.numpy() for t in want[:4]] + [float(want.entropy)]
    assert desc[0] == "global (GSPMD-partitioned)"
    _check(got[0], want, 1e-6, 1e-6)
    assert desc[1] == "random (--no_sinkhorn ablation)"
    want_rnd = matching.match_random(ta, tb, shard_size=B // 2)
    _check(got[1], [t.numpy() for t in want_rnd[:4]] + [0.0], 0.0, 1e-9)
    assert desc[2] == ("matrix-parallel (two-batch, whole matrices round-robined over the "
                       "2-device mesh) [auto: estimated 0.00 GB matrix-parallel residency vs "
                       "4.0 GB budget -> matrices]")
    _check(got[2], want, 1e-5, 1e-6)
    assert desc[3] == ("row-sharded (two-batch, whole local halves on the 2-device mesh) "
                       "[auto: estimated 0.00 GB matrix-parallel residency vs 0.0 GB budget "
                       "-> rows]")


def test_num_devices_must_match_ranks():
    """``--num_devices 2`` without torchrun's 2 ranks raises."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Engine(port_config.TrainConfig(num_devices=2), device="cpu")


def _torchrun_two_ranks(tmp_path, *flags):
    """``torchrun --nproc_per_node 2 -m otgan_tpu_torch.train --device cpu``:
    one 1:1 cycle of full-width DCGAN at batch 4, 5 Sinkhorn iterations; the
    records of ``metrics.jsonl`` after checking that only rank 0 wrote (its
    config, metrics and the two epochs' sample grids)."""
    out_dir = tmp_path / "run"
    cmd = [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "-m", "otgan_tpu_torch.train", "--device", "cpu", "--num_devices", "2",
        "--synthetic_data", "--synthetic_size", "4", "--batch_size", "4",
        "--nr_gen_per_disc", "1", "--max_epochs", "2", "--nr_sinkhorn_iter", "5",
        "--log_every_steps", "1", "--compute_dtype", "float32", "--save_dir", str(out_dir),
        *flags,
    ]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert sorted(os.listdir(out_dir)) == [
        "config.json", "ema_sample0.png", "ema_sample1.png", "metrics.jsonl", "sample0.png",
        "sample1.png"]
    assert out.stdout.count("model has a hidden representation") == 1
    recs = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "step_ms" in r]
    assert [r["kind"] for r in steps] == ["disc", "gen"]
    assert all(np.isfinite(r["dist"]) and np.isfinite(r["entropy"]) for r in steps)
    assert recs[0]["init_spread"] == 0.0  # every rank's init equalled rank 0's
    return recs


def test_torchrun_cli_two_ranks(tmp_path):
    """Layout auto picks matrix-parallel: the single-device Sinkhorn path
    on whole 2 x 2 matrices, its resident tier (plain on the CPU), no local
    step."""
    recs = _torchrun_two_ranks(tmp_path)
    # auto: 4 x 4 x 32768 floats of accumulator fit the 4 GB budget
    assert recs[0]["matcher"] == (
        "matrix-parallel (two-batch, whole matrices round-robined over the 2-device "
        "mesh) [auto: estimated 0.00 GB matrix-parallel residency vs 4.0 GB budget "
        "-> matrices]")
    launches = [r["launches"] for r in recs if "epoch" in r][-1]
    assert launches["resident_plain"] >= 2 and launches["resident"] == 0
    assert launches["col_potential_plain"] == launches["col_potential"] == 0
    assert {k: n for k, n in launches.items() if k.startswith("local_step")} == {
        "local_step_fused": 0, "local_step_stream": 0, "local_step_plain": 0}


def test_torchrun_cli_two_ranks_rows(tmp_path):
    """``--matching_layout rows``: rank 0 logs 5 local steps per match, all
    plain on the CPU, and no column-potential call."""
    recs = _torchrun_two_ranks(tmp_path, "--matching_layout", "rows")
    assert recs[0]["matcher"] == (
        "row-sharded (two-batch, whole local halves on the 2-device mesh)")
    assert [r["launches"] for r in recs if "epoch" in r] == [
        {"col_potential": 0, "col_potential_plain": 0, "resident": 0, "resident_plain": 0,
         "grid": 0, "grid_plain": 0, "local_step_fused": 0, "local_step_stream": 0,
         "local_step_plain": 5 * steps, "layer_boundary": 0, "layer_boundary_plain": 0,
         "dense_boundary": 0, "dense_boundary_plain": 0, "microbatch": 0, "dense_concat": 0}
        for steps in (1, 2)]
