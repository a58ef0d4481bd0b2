"""``--fused_cycle`` on K ranks: each rank's G:D cycle, its collectives
included, as one CUDA graph (``otgan_tpu_torch/engine.py::cycle_step``), on
worlds of 2 and 4 CPU processes joined by gloo
(``tests/test_torch_parallel_worker.py``).

The CPU has no graph, so a rank's graphs are stand-ins: the CPU's own path
(the batches grouped a cycle at a time, each cycle eager); ``StubGraph``,
whose capture runs the cycle's Python for real through ``CycleGraph``,
collectives included, and whose replay does nothing (so only a call that
captures computes, and the tests compare those calls); and an emulated
graph at the engine's level, whose capture runs nothing, as a CUDA graph's
capture executes none of its work, and whose replay runs the cycle. Every
way, the steps of the grouped calls equal the unfused steps of the same
engine on the same batches bit for bit (tolerance 0): the toy in each
matcher layout (rows with whole local halves and with padded halves,
matrices, the gathered global matcher, ``--grad_accum 2``) on 2 and 4
ranks, and the DCGAN at batch 8. A capture that runs out of memory on one
rank sends every rank eager, bit for bit the unfused steps; any other
failed capture on one rank raises on every rank; neither hangs (a hang
fails at the world's timeout). The DCGAN's captured cycle on 2 ranks is
held against the JAX package's ``Engine.cycle_step`` on a 2-device mesh
from the same state with its latents: dist and entropy within 1e-4,
parameters within 2 x lr (the bound of tests/test_torch_engine.py). A
two-rank ``torchrun`` trainer logs the same ``metrics.jsonl`` fused and
``--no_fused_cycle`` (tolerance 0). The card's own K-rank replays are
``chip_smoke.py`` phase 7; its one-rank capture of the matchers with their
collectives is phase 6 and ``tests/test_torch_cuda.py``.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.toy import sample_8gaussians
from tests.test_torch_engine import _param_check
from tests.test_torch_parallel import REPO, _plain_tree
from tests.test_torch_parallel_worker import World


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


# calls of 3, 3, 2, 1 and 3 batches at period 3: an eager warm-up, then a
# full cycle, a leftover of a critic and a generator step and one of a
# generator step, each its schedule's first call (a capture), then the full
# cycle again (a replay)
CALLS = [3, 3, 2, 1, 3]
CAPTURES = sum(CALLS[:4])  # the steps of the calls that warm up or capture


def _toy(k, B, **kw):
    cfg = dict(model="toy_mlp", batch_size=B, num_devices=k, sinkhorn_lambda=50.0,
               nr_sinkhorn_iter=5, nr_gen_per_disc=2)
    cfg.update(kw)
    rng = np.random.default_rng(B + k)
    xs = [sample_8gaussians(rng, B) for _ in range(sum(CALLS))]
    return cfg, sample_8gaussians(rng, B), xs


LAYOUTS = {
    "rows": dict(matching_layout="rows"),
    "rows-padded": dict(matching_layout="rows"),
    "matrices": dict(matching_layout="matrices"),
    "gathered": dict(sharded_matching=False),
    "accum2": dict(matching_layout="rows", grad_accum=2),
}


def _batch(k, layout):
    """Whole local halves where ``B/2`` divides over the ranks, padded
    halves where it does not."""
    return {2: 30, 4: 36}[k] if layout == "rows-padded" else 32


def _run(world, cfg, x_init, xs, calls, graphs="cpu", fail=None):
    return world.run("fused_cycle_ranks", cfg=cfg, x_init=x_init, xs=xs, calls=calls,
                     graphs=graphs, fail=fail)


def _assert_same(got, want, steps=None):
    """Bit for bit: every rank's steps, rank 0's state (parameters, EMA,
    optimizer moments and scalars, step, latent generator)."""
    for g, w in zip(got, want):
        assert g["same_on_every_rank"] and g["error"] is None, g["error"]
        assert g["steps"][:steps] == w["steps"][:steps]
    if steps is None:
        a, b = got[0]["state"], want[0]["state"]
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("k,layout", [(k, layout) for k in (2, 4) for layout in LAYOUTS
                                      if (k, layout) != (4, "accum2")],
                         ids=lambda v: str(v))
def test_grouped_cycles_equal_the_steps(world2, world4, k, layout):
    """The toy on K ranks in one matcher layout, 12 batches: grouped calls
    on the CPU's path and through emulated graphs equal the unfused steps
    bit for bit, state included; through ``StubGraph`` the calls that
    capture do, and the replay after them advances the step and this
    rank's launch counts by one cycle's on every rank."""
    world = world2 if k == 2 else world4
    cfg, x_init, xs = _toy(k, _batch(k, layout), **LAYOUTS[layout])
    n = sum(CALLS)
    want = _run(world, dict(cfg, fused_cycle=False), x_init, xs, [1] * n)
    assert len(want[0]["steps"]) == n and want[0]["fused"][2] == "--no_fused_cycle"
    cpu = _run(world, cfg, x_init, xs, CALLS)
    assert all(r["fused"] == (False, False, "cpu: no CUDA graph; each cycle runs eagerly")
               for r in cpu)
    _assert_same(cpu, want)
    emulated = _run(world, cfg, x_init, xs, CALLS, graphs="emulated")
    assert all(r["graphs"] == 3 and r["fused"][:2] == (True, False) for r in emulated)
    _assert_same(emulated, want)
    stub = _run(world, cfg, x_init, xs, CALLS, graphs="stub")
    _assert_same(stub, want, steps=CAPTURES)
    for r in stub:
        assert r["graphs"] == 3
        (step_a, counts_a), (step_b, counts_b) = r["after_calls"][-2:]
        assert step_b - step_a == 3
        (step_0, counts_0), (step_1, counts_1) = r["after_calls"][:2]
        # the replay adds what the captured full cycle launched, once
        assert {key: counts_b[key] - counts_a[key] for key in counts_a} == {
            key: counts_1[key] - counts_0[key] for key in counts_0}


@pytest.mark.parametrize("k", [2, 4])
def test_capture_out_of_memory_on_one_rank_sends_every_rank_eager(world2, world4, k):
    """The last rank's second capture (the leftover at step 6) runs out of
    memory: every rank drops its graphs and runs that call and the later
    ones eagerly, with no hang, bit for bit the unfused steps; the reason
    names the schedule and says every rank. The same failure at the end of
    a ``StubGraph`` capture (``capture_end``) switches every rank too."""
    world = world2 if k == 2 else world4
    cfg, x_init, xs = _toy(k, 32, matching_layout="rows")
    want = _run(world, dict(cfg, fused_cycle=False), x_init, xs, [1] * sum(CALLS))
    got = _run(world, cfg, x_init, xs, CALLS, graphs="emulated", fail=(k - 1, 1, "oom"))
    _assert_same(got, want)
    for r in got:
        graphs, fused, reason = r["fused"]
        assert (graphs, fused, r["graphs"]) == (False, False, 0)
        assert reason.startswith("capturing the schedule D:G at step 6 ran out of device "
                                 "memory; from then on every cycle runs eagerly on every rank")
        assert f"rank(s) [{k - 1}] of {k}" in reason
    stub = _run(world, cfg, x_init, xs, CALLS, graphs="stub", fail=(k - 1, 1, "oom"))
    for r in stub:
        assert r["error"] is None and r["fused"][:2] == (False, False) and r["graphs"] == 0
        assert "ran out of device memory" in r["fused"][2]
        assert len(r["steps"]) == sum(CALLS)


@pytest.mark.parametrize("graphs", ["stub", "emulated"])
@pytest.mark.parametrize("k", [2, 4])
def test_other_capture_failure_on_one_rank_raises_on_every_rank(world2, world4, k, graphs):
    """A capture that fails otherwise on rank 1 (at the end of a
    ``StubGraph``'s capture, or at an emulated capture's start): rank 1
    raises its own error, every other rank an error naming rank 1, after
    the same steps; no rank hangs."""
    world = world2 if k == 2 else world4
    cfg, x_init, xs = _toy(k, 32, matching_layout="rows")
    got = _run(world, cfg, x_init, xs, CALLS, graphs=graphs, fail=(1, 0, "error"))
    for rank, r in enumerate(got):
        assert r["steps"] == got[0]["steps"] and len(r["steps"]) == 3  # the warm-up only
        if rank == 1:
            assert r["error"] == ("RuntimeError: CUDA error: operation not permitted when "
                                  "stream is capturing")
        else:
            assert r["error"] == (f"RuntimeError: rank(s) [1] of {k} failed to capture the "
                                  "schedule D:G:G at step 3 (their errors are in their logs); "
                                  "every rank stops")


def test_captured_cycle_matches_jax_and_the_steps(world2, tmp_path):
    """The DCGAN at batch 8 on 2 ranks (rows, lam 500, 50 iterations, 1:1):
    one cycle captured through ``CycleGraph`` on each rank from the JAX
    state, with the JAX cycle's latents, against ``Engine.cycle_step`` of
    the JAX package on a 2-device mesh (dist and entropy within 1e-4,
    parameters within 2 x lr) and against the same engine's steps taken one
    by one (bit for bit)."""
    B = 8
    kw = dict(model="dcgan", batch_size=B, compute_dtype="float32", nr_sinkhorn_iter=50,
              matching_layout="rows", nr_gen_per_disc=1)
    eng_j = JaxEngine(JaxConfig(num_devices=2, **kw))
    rng = np.random.default_rng(0)
    x_init = rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    xs = [rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8) for _ in range(2)]
    state_j, _ = eng_j.init_state(0, eng_j.shard(x_init))
    host = jax.device_get(state_j)
    path = tmp_path / "state.pkl"
    with open(path, "wb") as f:
        pickle.dump(_plain_tree(host), f)
    zs, key = [], state_j.rng
    for _ in xs:  # each step splits the state's key and draws from the second half
        key, noise = jax.random.split(key)
        zs.append(np.asarray(jax.random.uniform(noise, (B, 100), minval=-1.0, maxval=1.0)))
    state_j, met_j = eng_j.cycle_step(state_j, eng_j.shard_steps(np.stack(xs)))
    after_j = jax.device_get(state_j)
    runs = [world2.run("fused_cycle_from_jax", cfg=dict(num_devices=2, **kw),
                       state_path=str(path), x_init=x_init, xs=xs, zs=zs, captured=captured)
            for captured in (True, False)]
    (fused, fused_1), (steps, steps_1) = runs
    assert fused["same_on_every_rank"] and fused_1["steps"] == fused["steps"]
    assert fused["steps"] == steps["steps"] and steps_1["steps"] == steps["steps"]
    for kind in ("gen", "disc"):
        _assert_tree_equal(fused[kind], steps[kind])
    for i, (d, e) in enumerate(fused["steps"]):
        assert abs(d - float(met_j.dist[i])) < 1e-4, i
        assert abs(e - float(met_j.entropy[i])) < 1e-4, i
    bound = 2 * TrainConfig().learning_rate_gen
    _param_check(fused["gen"], after_j.gen_params, bound, "gen vs jax")
    _param_check(fused["disc"], after_j.disc_params, bound, "disc vs jax")


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_tree_equal(a[key], b[key])
    else:
        np.testing.assert_array_equal(a, b)


def _torchrun(tmp_path, name, *flags):
    """``torchrun --nproc_per_node 2 -m otgan_tpu_torch.train --device cpu``:
    the toy at batch 32 (rows, lam 50, 5 Sinkhorn iterations, 2:1), 2 epochs
    of 4 batches (a full cycle and a leftover step each); ``metrics.jsonl``'s
    records."""
    out_dir = tmp_path / name
    cmd = [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "-m", "otgan_tpu_torch.train", "--device", "cpu", "--num_devices", "2",
        "--model", "toy_mlp", "--batch_size", "32", "--sinkhorn_lambda", "50",
        "--nr_gen_per_disc", "2", "--max_epochs", "2", "--nr_sinkhorn_iter", "5",
        "--matching_layout", "rows", "--log_every_steps", "1", "--save_dir", str(out_dir),
        *flags,
    ]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OTGAN_TOY_EPOCH_BATCHES="4")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]


def test_torchrun_fused_and_unfused_log_the_same(tmp_path):
    """Two ranks under ``torchrun``: the default ``--fused_cycle`` (on the
    CPU the batches grouped a cycle at a time, an epoch's leftover as one
    group) and ``--no_fused_cycle`` log the same steps and epoch means
    (tolerance 0); rank 0's first record says whether the cycle ran fused
    and why not."""
    fused = _torchrun(tmp_path, "fused")
    unfused = _torchrun(tmp_path, "unfused", "--no_fused_cycle")
    assert fused[0]["fused_cycle_effective"] is unfused[0]["fused_cycle_effective"] is False
    assert fused[0]["fused_cycle_reason"] == "cpu: no CUDA graph; each cycle runs eagerly"
    assert unfused[0]["fused_cycle_reason"] == "--no_fused_cycle"
    assert fused[0]["matcher"] == ("row-sharded (two-batch, whole local halves on the "
                                   "2-device mesh)")
    keys = ("step", "kind", "dist", "entropy")
    steps = [[tuple(r[x] for x in keys) for r in recs if "kind" in r] for recs in (fused, unfused)]
    assert steps[0] == steps[1]
    assert [s[1] for s in steps[0]] == ["disc" if i % 3 == 0 else "gen" for i in range(8)]
    means = [[(r.get("dist_gen"), r.get("dist_disc"), r["entropy"], r["launches"])
              for r in recs if "epoch" in r] for recs in (fused, unfused)]
    assert means[0] == means[1] and len(means[0]) == 2
