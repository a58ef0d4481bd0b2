"""``--fused_cycle`` in the port: one CUDA graph a full G:D cycle on the card
(``otgan_tpu_torch/cycle_graph.py``; the JAX engine's ``_cycle_step``).

On the CPU there is no graph: ``Engine.cycle_step`` runs the cycle eagerly
through the same code, and these tests hold that path to the steps taken
one by one bit for bit (tolerance 0), the trainer's grouping of batches into
cycles (partial cycles, ``disc_freeze_after_steps``, a resume that starts
mid-period) to the unfused trainer's ``metrics.jsonl`` (tolerance 0), and
the graph machinery against a stub graph whose capture runs the cycle on
the CPU and whose replay does nothing: the launch counters and
``state.step`` advance once per replay and never at capture, every schedule
(an epoch's leftover too) gets a graph in the first graph's pool, capture
waits until each kind of step still to come has run eagerly, and
``--debug_nans`` raises from the graph's flags at the step and quantity the
eager path names. A capture that runs out of memory (a stub whose capture
reaches the cycle's first match and raises ``torch.OutOfMemoryError``
there, as an allocation under capture does on the card) leaves the state,
the step, the counters and the latent generator as they were, drops every
graph and the pool, and the engine takes that call and every later one
eagerly, bit for bit the steps of an unfused engine (tolerance 0); the
trainer logs the switch; any other failed capture still raises. Adam's
step count is a device tensor: its updates against
the JAX package's ``adam_update`` (rtol 1e-6, as tests/test_torch_nn.py),
and the npz checkpoint and the JAX-format leaves still carry it as before.
The card's own replays are held in tests/test_torch_cuda.py and
``chip_smoke.py`` phase 13b.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu.nn.optim import adam_init as jax_adam_init
from otgan_tpu.nn.optim import adam_update as jax_adam_update
from otgan_tpu.utils import checkpoint as jax_ckpt
from otgan_tpu_torch import convert
from otgan_tpu_torch import train as port_train
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.nn import optim
from otgan_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_parallel_worker import StubGraph


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_cfg(**kw):
    base = dict(model="toy_mlp", batch_size=32, sinkhorn_lambda=50.0, nr_sinkhorn_iter=5,
                nr_gen_per_disc=2)
    base.update(kw)
    return TrainConfig(**base)


def _engine(**kw):
    eng = Engine(_toy_cfg(**kw), "cpu")
    rng = np.random.default_rng(0)
    state, _ = eng.init_state(1, sample_8gaussians(rng, 32))
    return eng, state, rng


def _batches(rng, n):
    return [torch.from_numpy(sample_8gaussians(rng, 32)) for _ in range(n)]


def _named(state):
    return {k: t.detach().clone() for k, t in ckpt._named_tensors(state)}


@pytest.mark.parametrize("freeze", [0, 4], ids=["5-2-schedule", "critic-frozen"])
def test_cycle_step_equals_the_steps(freeze):
    """Three full cycles and a partial one through ``cycle_step`` against
    the same batches through ``gen_step``/``disc_step``: the same metrics
    and the same state, bit for bit."""
    a, sa, rng = _engine(disc_freeze_after_steps=freeze)
    b, sb, _ = _engine(disc_freeze_after_steps=freeze)
    xs = _batches(rng, 11)
    got = []
    for i in range(0, 11, 3):
        sa, mets = a.cycle_step(sa, xs[i:i + 3])
        got += mets
    want = []
    for x in xs:
        step = b.disc_step if b.is_disc_step(sb.step) else b.gen_step
        sb, met = step(sb, x)
        want.append(met)
    assert sa.step == sb.step == 11
    for g, w in zip(got, want):
        assert torch.equal(g.dist, w.dist) and torch.equal(g.entropy, w.entropy)
    for (k, t), u in zip(_named(sa).items(), _named(sb).values()):
        assert torch.equal(t, u), k
    assert torch.equal(sa.gen_opt.t, sb.gen_opt.t) and float(sa.gen_opt.t) == 1.0 + (
        11 - sum(b.is_disc_step(s) for s in range(11)))


def _run_trainer(tmp_path, name, extra, monkeypatch, batches=4):
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", str(batches))
    d = tmp_path / name
    port_train.main(["--device", "cpu", "--model", "toy_mlp", "--batch_size", "32",
                     "--sinkhorn_lambda", "50", "--nr_sinkhorn_iter", "5", "--nr_gen_per_disc",
                     "2", "--log_every_steps", "1", "--save_every_epochs", "1",
                     "--save_dir", str(d)] + extra)
    recs = [json.loads(line) for line in open(d / "metrics.jsonl")]
    return d, recs


def _step_records(recs):
    return [(r["step"], r["kind"], r["dist"], r["entropy"]) for r in recs if "kind" in r]


@pytest.mark.parametrize("extra", [[], ["--disc_freeze_after_steps", "5"]],
                         ids=["partial-cycles", "critic-frozen"])
def test_trainer_fused_and_unfused_log_the_same(tmp_path, monkeypatch, extra):
    """Epochs of 4 batches at period 3 (one full cycle and a leftover step
    each), 2 epochs, then a resume at step 8 (mid-period) for 2 more: the
    per-step records and the epochs' means of both runs are equal."""
    out = {}
    for mode in ("--fused_cycle", "--no_fused_cycle"):
        name = mode.strip("-")
        d, first = _run_trainer(tmp_path, name, extra + [mode, "--max_epochs", "2"], monkeypatch)
        _, both = _run_trainer(tmp_path, name, extra + [mode, "--max_epochs", "4",
                                                       "--load_params"], monkeypatch)
        out[mode] = (first, both[len(first):])
        cfg = json.load(open(d / "config.json"))
        assert cfg["fused_cycle_effective"] is False  # no graph on the CPU
        assert cfg["fused_cycle_reason"].startswith(
            "cpu: " if mode == "--fused_cycle" else "--no_fused_cycle")
    (f1, f2), (u1, u2) = out["--fused_cycle"], out["--no_fused_cycle"]
    assert _step_records(f1) == _step_records(u1) and len(_step_records(f1)) == 8
    assert _step_records(f2)[0][0] == 9  # resumed at step 8, not a multiple of 3
    assert _step_records(f2) == _step_records(u2)
    for a, b in ((f1, u1), (f2, u2)):
        ea = [(r.get("dist_gen"), r.get("dist_disc")) for r in a if "epoch" in r]
        eb = [(r.get("dist_gen"), r.get("dist_disc")) for r in b if "epoch" in r]
        assert ea == eb


def test_sinkhorn_tol_runs_unfused_and_says_why(tmp_path, monkeypatch):
    d, recs = _run_trainer(tmp_path, "tol", ["--sinkhorn_tol", "1e-3", "--max_epochs", "1"],
                           monkeypatch, batches=3)
    for where in (recs[0], json.load(open(d / "config.json"))):
        assert where["fused_cycle_effective"] is False
        assert where["fused_cycle_reason"].startswith("--sinkhorn_tol > 0")


def test_adam_device_step_count_matches_jax():
    """Adam's ``t`` is a float32 tensor on the parameters' device, updated
    in place (a graph keeps its address); the updates are the JAX
    package's."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    gs = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(4)]
    params = {"w": torch.from_numpy(p0.copy())}
    state = optim.adam_init(params)
    t_obj = state.t
    jp, js = {"w": jnp.asarray(p0)}, jax_adam_init({"w": jnp.asarray(p0)})
    for g in gs:
        state = optim.adam_update(params, {"w": torch.from_numpy(g)}, state, -3e-4,
                                  mom1=0.5, mom2=0.999)
        jp, js = jax_adam_update(jp, {"w": jnp.asarray(g)}, js, -3e-4, mom1=0.5, mom2=0.999)
    assert state.t is t_obj and state.t.dtype == torch.float32 and state.t.dim() == 0
    assert float(state.t) == float(js.t) == 5.0
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)


def test_checkpoints_carry_the_device_step_count(tmp_path):
    """The npz file keeps ``t`` as before (a float64 scalar), a restore
    writes it into the state's tensor in place, and the JAX-format leaves
    the port writes restore in the JAX package with ``t`` float32."""
    eng, state, rng = _engine()
    state, _ = eng.cycle_step(state, _batches(rng, 3))
    path = ckpt.save_checkpoint(str(tmp_path), state, 0)
    with np.load(path) as f:
        assert f["gen_opt/t"].dtype == np.float64 and float(f["gen_opt/t"]) == 3.0
        assert float(f["disc_opt/t"]) == 2.0
    _, fresh, _ = _engine()
    t_obj = fresh.gen_opt.t
    ckpt.restore_checkpoint(path, fresh)
    assert fresh.gen_opt.t is t_obj and float(fresh.gen_opt.t) == 3.0
    leaves = convert.jax_leaves(state)
    jpath = tmp_path / "otgan_state-1.npz"
    np.savez(jpath, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    jeng = JaxEngine(JaxConfig(model="toy_mlp", batch_size=32, sinkhorn_lambda=50.0,
                               nr_sinkhorn_iter=5, nr_gen_per_disc=2))
    jstate, _ = jeng.init_state(0, jeng.shard(sample_8gaussians(rng, 32)))
    back = jax.device_get(jax_ckpt.restore_checkpoint(str(jpath), jstate))
    assert np.asarray(back.gen_opt.t).dtype == np.float32 and float(back.gen_opt.t) == 3.0


def _stub_engine(**kw):
    eng, state, rng = _engine(**kw)
    eng.cycle_graphs, eng.graph_factory = True, StubGraph
    return eng, state, rng


def test_counters_and_step_advance_once_per_replay():
    """Warm-up (eager), capture and replay, replay: the plain Sinkhorn's
    counter and ``state.step`` move by one cycle each time; the capture's
    own counts are taken back."""
    eng, state, rng = _stub_engine()
    counts = []
    for _ in range(3):
        state, mets = eng.cycle_step(state, _batches(rng, 3))
        counts.append((state.step, port_train.kernel_launches()["resident_plain"]))
        assert len(mets) == 3
    base = counts[0][1] - 3
    assert counts == [(3, base + 3), (6, base + 6), (9, base + 9)]
    graph = next(iter(eng._graphs.values()))
    assert graph.delta[2] == {"kernel": 0, "plain": 3}  # the resident tier's counter
    assert isinstance(graph.graph.gen, torch.Generator)  # the latents' generator is registered
    # a partial cycle and each new schedule get a graph of their own, all
    # captured into the first graph's pool
    state, _ = eng.cycle_step(state, _batches(rng, 1))
    state, _ = eng.cycle_step(state, _batches(rng, 3))
    assert state.step == 13 and list(eng._graphs) == [(True, False, False), (True,),
                                                      (False, False, True)]
    pools = [g.pool for g in eng._graphs.values()]
    assert pools == [graph.graph.pool()] * 3 and eng._graph_pool == pools[0]
    assert port_train.kernel_launches()["resident_plain"] == base + 13


@pytest.mark.parametrize("start, freeze, eager", [(1, 0, [2, 3]), (1, 3, [2]), (4, 2, [2])],
                         ids=["resumed-mid-period", "critic-freezes", "critic-frozen"])
def test_calls_run_eagerly_until_each_kind_has_run(start, freeze, eager):
    """Capture waits until every kind of step still to come has run once
    eagerly: a resume whose first call holds only generator steps runs the
    next (with the critic's step) eagerly too; where the critic takes no
    more steps (it freezes at step 3, or has frozen), generator steps alone
    warm up. Calls of 2, 3 and 3 batches."""
    eng, state, rng = _stub_engine(disc_freeze_after_steps=freeze)
    state.step = start
    ran_eagerly, cycles, cycle = [], [], eng.cycle
    eng.cycle = lambda *a: cycles.append(1) or cycle(*a)  # eager runs and captures
    for n in (2, 3, 3):
        graphs, ran = len(eng._graphs), len(cycles)
        state, _ = eng.cycle_step(state, _batches(rng, n))
        if len(cycles) > ran and len(eng._graphs) == graphs:
            ran_eagerly.append(n)
    assert ran_eagerly == eager and state.step == start + 8


@pytest.mark.parametrize("bad_step", [0, 2])
def test_debug_nans_raises_at_the_same_step_both_ways(bad_step):
    """A NaN batch in the second cycle: the eager path and the graph's
    flags name the same step and quantity."""
    msgs = []
    for make in (_engine, _stub_engine):
        eng, state, rng = make(debug_nans=True)
        state, _ = eng.cycle_step(state, _batches(rng, 3))
        xs = _batches(rng, 3)
        xs[bad_step] = torch.full_like(xs[bad_step], float("nan"))
        with pytest.raises(FloatingPointError) as err:
            eng.cycle_step(state, xs)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == f"--debug_nans: non-finite loss at step {3 + bad_step} (0-based)"


class OomStubGraph(StubGraph):
    """A stub whose capture runs the cycle until its first match, which runs
    out of device memory; with ``invalidated`` the capture's end then raises
    too (``capture_end`` on a broken capture), so the memory error is only
    the context of the one raised."""

    invalidated = False

    @contextlib.contextmanager
    def capture(self, pool=None):
        self.given_pool = pool
        try:
            yield
        except RuntimeError:
            if self.invalidated:
                raise RuntimeError("CUDA error: operation failed due to a previous error "
                                   "during capture")
            raise


def _oom_at_capture(eng, graph_factory):
    """The engine's next capture uses ``graph_factory``, whose match raises
    while a capture is on (``deferred_checks`` is set only then)."""
    matcher = eng._matcher

    def match(*a):
        if eng.deferred_checks is not None:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.50 GiB")
        return matcher(*a)

    eng._matcher, eng.graph_factory = match, graph_factory


@pytest.mark.parametrize("invalidated", [False, True], ids=["oom", "oom-then-invalidated"])
def test_capture_out_of_memory_switches_to_eager(invalidated):
    """Warm-up (eager), a full cycle captured and replayed, then the
    leftover's capture runs out of memory: nothing of the failed capture
    remains (state, step, counters, the generator's draws), graphs and pool
    are gone, and that call and the later ones run eagerly, equal bit for
    bit to an unfused engine over the same 10 batches."""
    eng, state, rng = _stub_engine()
    ref, rstate, _ = _engine(fused_cycle=False)
    xs = _batches(rng, 10)
    for i in (0, 3):
        state, _ = eng.cycle_step(state, xs[i:i + 3])
    assert len(eng._graphs) == 1 and eng._graph_pool is not None
    graph = type("Oom", (OomStubGraph,), {"invalidated": invalidated})
    _oom_at_capture(eng, graph)
    before, counts = _named(state), port_train.kernel_launches()
    rng_state, step = state.rng.get_state(), state.step
    import otgan_tpu_torch.engine as engine_mod
    seen = []
    run_eagerly = eng._run_eagerly

    def spy(*a):  # the moment of the switch, before this call's eager steps
        seen.append((_named(state), port_train.kernel_launches(), state.rng.get_state(),
                     state.step))
        run_eagerly(*a)

    eng._run_eagerly = spy
    state, mets = eng.cycle_step(state, xs[6:7])
    assert engine_mod.CaptureOutOfMemory and len(seen) == 1
    named, counts_then, rng_then, step_then = seen[0]
    assert step_then == step and counts_then == counts
    assert torch.equal(rng_then, rng_state)
    for k, t in before.items():
        assert torch.equal(named[k], t), k
    assert eng.cycle_graphs is False and eng.fused_cycle is False
    assert eng._graphs == {} and eng._graph_pool is None
    assert eng.fused_cycle_reason.startswith("capturing the schedule D at step 6 ran out of "
                                             "device memory")
    got = list(mets)
    for i in (7, 10):  # later calls: eager, the old graph never replays
        cycles = []
        cycle = eng.cycle
        eng.cycle = lambda *a: cycles.append(1) or cycle(*a)
        state, mets = eng.cycle_step(state, xs[i:i + 3])
        eng.cycle = cycle
        assert cycles == [1] and eng._graphs == {}
        got += mets
    want = []
    for x in xs:
        rstate, met = ref.cycle_step(rstate, [x])
        want += met
    assert state.step == rstate.step == 13 - 3  # 10 batches
    for g, w in zip(got, want[6:]):
        assert torch.equal(g.dist, w.dist) and torch.equal(g.entropy, w.entropy)
    for (k, t), u in zip(_named(state).items(), _named(rstate).values()):
        assert torch.equal(t, u), k
    assert torch.equal(state.rng.get_state(), rstate.rng.get_state())


def test_other_capture_failures_still_raise():
    """A capture that fails for another reason than memory raises as before
    and leaves the engine fused."""
    eng, state, rng = _stub_engine()
    state, _ = eng.cycle_step(state, _batches(rng, 3))
    matcher = eng._matcher

    def match(*a):
        if eng.deferred_checks is not None:
            raise RuntimeError("CUDA error: operation not permitted when stream is capturing")
        return matcher(*a)

    eng._matcher = match
    with pytest.raises(RuntimeError, match="not permitted when stream is capturing") as err:
        eng.cycle_step(state, _batches(rng, 3))
    assert not isinstance(err.value, torch.OutOfMemoryError)
    assert eng.cycle_graphs is True and state.step == 3


def test_trainer_logs_the_switch_to_eager(tmp_path, monkeypatch):
    """The trainer under an engine whose second capture runs out of memory:
    the record after the switch says ``fused_cycle_effective`` false and
    why, echoed once, and the run goes on to its end with the steps of an
    unfused run."""

    class OomEngine(port_train.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.cycle_graphs = self.fused_cycle = True
            self.graph_factory = StubGraph
            self._captures = 0
            matcher = self._matcher

            def match(*m):
                if self.deferred_checks is not None and self._captures:
                    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
                return matcher(*m)

            self._matcher = match

        def cycle_step(self, state, xs):
            out = super().cycle_step(state, xs)
            self._captures += len(self._graphs)
            return out

    monkeypatch.setattr(port_train, "Engine", OomEngine)
    _, recs = _run_trainer(tmp_path, "oom", ["--max_epochs", "2"], monkeypatch)
    monkeypatch.setattr(port_train, "Engine", Engine)
    _, plain = _run_trainer(tmp_path, "plain", ["--max_epochs", "2", "--no_fused_cycle"],
                            monkeypatch)
    assert recs[0]["fused_cycle_effective"] is True
    switched = [r for r in recs[1:] if "fused_cycle_effective" in r]
    assert len(switched) == 1 and switched[0]["fused_cycle_effective"] is False
    assert "ran out of device memory" in switched[0]["fused_cycle_reason"]
    assert _step_records(recs) == _step_records(plain) and len(_step_records(recs)) == 8


def test_trainer_drops_its_graphs_at_the_end(tmp_path, monkeypatch):
    """The trainer's engine (stub graphs, so its calls capture and replay)
    holds no graph once the run ends, though the engine itself may live on:
    on K ranks a live graph holds NCCL work, and NCCL will not destroy the
    group's communicator while it does."""
    engines = []

    class StubEngine(port_train.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.cycle_graphs, self.graph_factory = True, StubGraph
            engines.append(self)

    monkeypatch.setattr(port_train, "Engine", StubEngine)
    _run_trainer(tmp_path, "drop", ["--max_epochs", "2"], monkeypatch)
    (eng,) = engines
    assert eng.replays >= 2 and eng._graphs == {} and eng._graph_pool is None
