"""The trainer's ``--profile_dir`` and ``--debug_nans``, and the engine's
phase marks, on the CPU, on the toy (batch 16 or 32, short epochs).

``--profile_dir`` writes a Chrome trace of the run that holds the step
spans and their phase spans, also when the run raises. ``--debug_nans``
raises ``FloatingPointError`` at the step whose batch carries a NaN, naming
it, and not before; without the flag the same run ends with the NaN
visible in ``dist`` (the JAX package's probe: NaN in, NaN out, not masked).

The marks (``utils/tracing.py::phase``) run on the host clock here, through
the same state machine as the card's kernels: each kind of step counts one
in each slot a step, eager or replayed (a stub graph's capture runs the
cycle; its marks are taken back and added once a replay, as the card runs
them in each replay and none at capture), ``profiled_device_ms`` counts only
the calls made under a profiler, and the epoch record carries the ms a step.
The trace reader attributes kernels to phases by the marks on the device
timeline (a hand-written trace of a replay: one ``cycle`` host span) and
finds the gaps between steps. The benchmark's readers of the marks give
nothing where the program has no marks, counted no step, or runs off the
card.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.utils import tracing
from otgan_tpu_torch.utils.tracing import NESTED_SPANS, PHASE_SPANS, SLOTS, summarize, trace_path
from portbench import spec
from tests.test_torch_parallel_worker import StubGraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("features_device_ms", "match_device_ms", "backward_device_ms", "update_device_ms",
           "step_device_ms", "refeatures_device_ms")

POISONED = 3  # 0-based index of the step whose batch holds a NaN


@pytest.fixture
def toy_run(tmp_path, monkeypatch):
    """argv of a toy run of 6 steps whose 4th batch holds a NaN."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "3")
    seen = []

    def poisoned_epoch(rng, batch_size, n_batches=78):
        for _ in range(n_batches):
            x = sample_8gaussians(rng, batch_size)
            if len(seen) == POISONED:
                x[0, 0] = np.nan
            seen.append(1)
            yield x

    monkeypatch.setattr(train_mod, "_toy_epoch", poisoned_epoch)
    return ["--model", "toy_mlp", "--batch_size", "16", "--sinkhorn_lambda", "50",
            "--nr_sinkhorn_iter", "10", "--nr_gen_per_disc", "1", "--max_epochs", "2",
            "--log_every_steps", "1", "--save_dir", str(tmp_path / "run"), "--device", "cpu"]


def test_profile_dir_writes_a_trace_with_the_step_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "1")
    trace_dir = str(tmp_path / "trace")
    result = train_mod.main(["--model", "toy_mlp", "--batch_size", "16", "--nr_sinkhorn_iter",
                             "10", "--nr_gen_per_disc", "1", "--max_epochs", "2",
                             "--save_dir", str(tmp_path / "run"), "--device", "cpu",
                             "--profile_dir", trace_dir])
    assert result.state.step == 2
    summary = summarize(trace_path(trace_dir))
    spans = summary["spans"]
    assert spans["disc_step"][0] == 1 and spans["gen_step"][0] == 1
    assert all(spans[name][0] == 2 for name in PHASE_SPANS), spans
    assert summary["kernels"] == {}  # no card: the trace holds host activity only


def test_debug_nans_raises_at_the_poisoned_step(toy_run, tmp_path):
    trace_dir = str(tmp_path / "trace")
    with pytest.raises(FloatingPointError, match=f"non-finite loss at step {POISONED} "):
        train_mod.main(toy_run + ["--debug_nans", "--profile_dir", trace_dir])
    with open(os.path.join(tmp_path / "run", "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "dist" in r and "epoch" not in r]
    # the steps before it ran, were checked and logged finite values
    assert [r["step"] for r in steps] == list(range(1, POISONED + 1))
    assert all(math.isfinite(r["dist"]) for r in steps)
    # the trace is written when the run raises too
    assert summarize(trace_path(trace_dir))["spans"]["gen_step"][0] >= 1


def test_without_debug_nans_the_nan_stays_visible(toy_run):
    result = train_mod.main(toy_run)
    dists = [r["dist"] for r in result.steps]
    assert len(dists) == 6 and all(math.isfinite(d) for d in dists[:POISONED])
    assert math.isnan(dists[POISONED]) and math.isnan(dists[-1])


@pytest.fixture
def toy_engine():
    """A toy engine on the CPU at 2:1 (calls of 3 batches are whole
    cycles, a critic step first) with every tally zeroed, and its batches."""
    torch.manual_seed(0)
    eng = Engine(TrainConfig(model="toy_mlp", batch_size=32, sinkhorn_lambda=50.0,
                             nr_sinkhorn_iter=5, nr_gen_per_disc=2), "cpu")
    rng = np.random.default_rng(0)
    state, _ = eng.init_state(1, sample_8gaussians(rng, 32))
    tracing.reset()
    batches = [torch.from_numpy(sample_8gaussians(rng, 32)) for _ in range(15)]
    yield eng, state, batches
    tracing.reset()


def _counts(totals):
    return {kind: {slot: v["count"] for slot, v in slots.items()}
            for kind, slots in totals.items()}


def _each_slot(n_gen, n_disc, nested=0):
    """Counts of each slot: ``n_gen`` and ``n_disc`` steps, ``nested`` marks a
    step in ``refeatures`` (none where a step takes its whole batch)."""
    return {kind: {slot: n * nested if slot in NESTED_SPANS else n for slot in SLOTS}
            for kind, n in (("gen", n_gen), ("disc", n_disc))}


def test_eager_marks_count_each_step_once(toy_engine):
    """Two eager cycles and a lone critic step: each kind counts one in each
    of its five slots a step and none in ``refeatures`` (whole batches), and
    its four phases fit inside its steps."""
    eng, state, xs = toy_engine
    state, _ = eng.cycle_step(state, xs[:3])
    state, _ = eng.cycle_step(state, xs[3:6])
    state, _ = eng.disc_step(state, xs[6])
    totals = tracing.device_ms("cpu")
    assert _counts(totals) == _each_slot(4, 3)
    for kind, slots in totals.items():
        phases = sum(slots[p]["ms"] for p in PHASE_SPANS)
        assert 0 < phases <= slots["step"]["ms"], kind
        assert all(slots[p]["ms"] > 0 for p in PHASE_SPANS), kind


def test_profiled_totals_count_only_calls_under_a_profiler(toy_engine):
    """Two calls before a profiler, two under it, one after: the profiled
    totals are the middle two's steps, read after the profiler stopped
    (with no call since: the totals as they stand) and after the next call
    (the copy taken at that call)."""
    eng, state, xs = toy_engine
    for i in range(2):
        state, _ = eng.cycle_step(state, xs[3 * i:3 * i + 3])
    assert _counts(tracing.profiled_device_ms("cpu")) == _each_slot(0, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(2, 4):
            state, _ = eng.cycle_step(state, xs[3 * i:3 * i + 3])
    under = tracing.profiled_device_ms("cpu")
    assert _counts(under) == _each_slot(4, 2)
    state, _ = eng.cycle_step(state, xs[12:15])
    assert tracing.profiled_device_ms("cpu") == under
    assert _counts(tracing.device_ms("cpu")) == _each_slot(10, 5)


def test_replayed_steps_are_counted_under_a_stub_graph(toy_engine):
    """An eager call, a capture and its replay, two more replays: every
    step counts once (the capture's own marks are taken back), under a
    profiler too."""
    eng, state, xs = toy_engine
    eng.cycle_graphs, eng.graph_factory = True, StubGraph
    state, _ = eng.cycle_step(state, xs[:3])
    state, _ = eng.cycle_step(state, xs[3:6])
    graph = next(iter(eng._graphs.values()))
    assert _counts(tracing.device_ms("cpu")) == _each_slot(4, 2)
    assert graph.marks[..., 0].abs().sum() == 0 and int(graph.marks[..., 2].sum()) == 15
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(2, 4):
            state, _ = eng.cycle_step(state, xs[3 * i:3 * i + 3])
    assert eng.replays == 3 and state.step == 12
    assert _counts(tracing.profiled_device_ms("cpu")) == _each_slot(4, 2)
    assert _counts(tracing.device_ms("cpu")) == _each_slot(8, 4)


def _trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": [dict(e, ph="X") for e in events]}, f)
    return str(path)


def _kernel(name, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _marks(kind, slot, ts, dur=1.0):
    return [_kernel(f"void otgan_mark<{kind}, {slot}, {edge}>(unsigned long long*)", t, dur)
            for edge, t in (("begin", ts[0]), ("end", ts[1]))]


def _replayed_step(kind, t0):
    """One step of a replay from device time ``t0`` (us): its marks, a
    latent draw, a kernel in each phase (10, 20, 30 and 4 us) and 100 us in
    all."""
    ev = _marks(kind, "step", (t0, t0 + 99))
    ev.append(_kernel("uniform_", t0 + 2, 1))
    for slot, (a, b, dur) in (("features", (4, 20, 10)), ("match", (20, 50, 20)),
                              ("loss_backward", (50, 90, 30)), ("update", (90, 97, 4))):
        ev += _marks(kind, slot, (t0 + a, t0 + b))
        ev.append(_kernel(f"{slot}_kernel", t0 + a + 2, dur))
    return ev


def test_summarize_and_step_gaps_read_a_replay_by_its_marks(tmp_path):
    """Two calls, each one ``cycle`` host span whose replay runs a critic
    and a generator step back to back; between them the card idles 100 us
    less a 20 us copy, under the trainer's ``data_wait`` and ``dispatch``
    spans. Every kernel but the marks and the latent draws is in its phase,
    the gaps are between the steps' marks, and each idle interval is named
    by the span that covers most of it."""
    events = [{"cat": "user_annotation", "name": "cycle", "ts": 0, "dur": 5},
              {"cat": "user_annotation", "name": "data_wait", "ts": 195, "dur": 50},
              {"cat": "user_annotation", "name": "dispatch", "ts": 276, "dur": 50},
              {"cat": "user_annotation", "name": "cycle", "ts": 280, "dur": 5},
              {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 220,
               "dur": 20}]
    for kind, t0 in (("disc", 0), ("gen", 100), ("disc", 300), ("gen", 400)):
        events += _replayed_step(kind, t0)
    path = _trace(tmp_path / "trace.json", events)
    summary = summarize(path)
    phase_ms = summary["phase_device_ms"]
    assert phase_ms["features"] == pytest.approx(0.04) and phase_ms["match"] == pytest.approx(0.08)
    assert phase_ms["loss_backward"] == pytest.approx(0.12)
    assert phase_ms["update"] == pytest.approx(0.016)
    assert phase_ms["other"] == pytest.approx(4 * (10 + 1) * 1e-3)  # the marks, the draws
    assert summary["marks"]["gen.step"] == [2, pytest.approx(0.198)]
    assert summary["marks"]["disc.match"] == [2, pytest.approx(0.06)]
    assert summary["spans"]["gen_step"] == [0, 0.0]  # a replay has no step span
    gaps = tracing.step_gaps(path)
    assert gaps["gaps_ms"] == pytest.approx([0.0, 0.1, 0.0])
    assert gaps["idle_ms"] == pytest.approx([0.0, 0.08, 0.0])
    assert gaps["copy_ms"] == pytest.approx([0.0, 0.02, 0.0])
    idle = summary["idle_gaps"]
    assert idle[:2] == [["dispatch", pytest.approx(0.06)], ["data_wait", pytest.approx(0.02)]]
    assert all(ms < 0.01 for _, ms in idle[2:])  # between the kernels of a step


def test_summarize_gives_a_kernel_to_the_innermost_slot(tmp_path):
    """A generator step whose loss_backward holds two microbatches' second
    forwards (``refeatures`` marks): a kernel between those marks goes to
    ``refeatures``, one between them and loss_backward's own marks to
    ``loss_backward``; the marks count each slot's intervals."""
    ev = _marks("gen", "step", (0, 99))
    for slot, (a, b, dur) in (("features", (4, 20, 10)), ("match", (20, 50, 20)),
                              ("loss_backward", (50, 90, 2)), ("update", (90, 97, 4))):
        ev += _marks("gen", slot, (a, b))
        ev.append(_kernel(f"{slot}_kernel", a + 2, dur))
    for a in (55, 70):  # each microbatch: its forward (8 us), then its backward (5 us)
        ev += _marks("gen", "refeatures", (a, a + 10))
        ev.append(_kernel("conv_fprop", a + 1, 8))
        ev.append(_kernel("conv_dgrad", a + 11, 5))
    summary = summarize(_trace(tmp_path / "trace.json", ev))
    phase_ms = summary["phase_device_ms"]
    assert phase_ms["refeatures"] == pytest.approx(0.016)
    assert phase_ms["loss_backward"] == pytest.approx(0.012)  # its own 2 us and the two backwards
    assert phase_ms["features"] == pytest.approx(0.01) and phase_ms["other"] == pytest.approx(
        (2 * 5 + 2 * 2) * 1e-3)  # the marks
    assert summary["marks"]["gen.refeatures"] == [2, pytest.approx(0.02)]
    assert summary["marks"]["gen.loss_backward"] == [1, pytest.approx(0.04)]


def _densenet_engine(accum: int, layers: int = 2):
    torch.manual_seed(0)
    eng = Engine(TrainConfig(model="densenet", layers_per_block=layers, filters_per_layer=4,
                             batch_size=8, nr_sinkhorn_iter=3, grad_accum=accum), "cpu")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), np.uint8))
               for _ in range(3)]
    state, _ = eng.init_state(1, batches[0])
    return eng, state, batches[1:]


@pytest.mark.parametrize("accum", [1, 4])
def test_microbatches_mark_their_second_forward(accum):
    """The DenseNet at L = 2 (9 list convs a net), a critic step and a
    generator step: under ``--grad_accum 4`` each counts 4 ``refeatures``
    begin/end pairs and 4 ``microbatch`` passes, and concatenates
    4 x (3 x 9) lists in its features (generator, critic on fakes, critic on
    data) and 4 x (2 x 9) in its second forwards (critic step: the critic on
    fakes and on data; generator step: generator and critic); whole
    batches, none and 3 x 9."""
    eng, state, xs = _densenet_engine(accum)
    tracing.reset()
    before = dict(tracing.counts)
    state, _ = eng.disc_step(state, xs[0])
    state, _ = eng.gen_step(state, xs[1])
    counts = _counts(tracing.device_ms("cpu"))
    want = _each_slot(1, 1, nested=accum if accum > 1 else 0)
    assert counts == want
    per = 9 * (3 * accum + 2 * accum) if accum > 1 else 9 * 3
    assert {k: tracing.counts[k] - before[k] for k in before} == {
        "microbatch": 2 * accum if accum > 1 else 0, "dense_concat": 2 * per}
    totals = tracing.device_ms("cpu")
    for kind in ("gen", "disc"):
        assert totals[kind]["refeatures"]["ms"] <= totals[kind]["loss_backward"]["ms"]
    tracing.reset()


def test_dense_concat_counts_each_list_a_conv_concatenates():
    """At the source's L = F = 16, one critic forward and one generator
    forward each concatenate 51 lists (each of the critic's convs but its
    first, which reads the images; each of the generator's); the DCGAN's
    nets, whose convs read single tensors, count none. (A whole-batch step
    counts no microbatch: ``test_microbatches_mark_their_second_forward``.)"""
    from otgan_tpu_torch.models import dcgan, densenet

    before = dict(tracing.counts)
    with torch.no_grad():
        densenet.make_discriminator()(torch.zeros(1, 32, 32, 3))
        assert tracing.counts["dense_concat"] - before["dense_concat"] == 51
        densenet.make_generator()(densenet.sample_latent(1))
        assert tracing.counts["dense_concat"] - before["dense_concat"] == 102
        before = dict(tracing.counts)
        dcgan.make_discriminator()(dcgan.make_generator()(dcgan.sample_latent(1)))
    assert dict(tracing.counts) == before


def test_epoch_record_holds_device_ms(tmp_path, monkeypatch):
    """The toy at 1:1 for two epochs of 3 batches: each epoch's record
    carries the ms a step of each kind and slot, its phases within its
    step."""
    monkeypatch.setenv("OTGAN_TOY_EPOCH_BATCHES", "3")
    run = tmp_path / "run"
    train_mod.main(["--model", "toy_mlp", "--batch_size", "16", "--nr_sinkhorn_iter", "5",
                    "--nr_gen_per_disc", "1", "--max_epochs", "2", "--save_dir", str(run),
                    "--device", "cpu"])
    with open(run / "metrics.jsonl") as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]
    assert len(epochs) == 2
    for rec in epochs:
        assert set(rec["device_ms"]) == {"gen", "disc"}
        for kind, slots in rec["device_ms"].items():
            assert set(slots) == set(SLOTS)
            assert 0 < sum(slots[p] for p in PHASE_SPANS) <= slots["step"], (kind, slots)


# ms a step in each slot of ``_profiled``
SLOT_MS = dict(zip(SLOTS, (1.0, 2.0, 3.0, 4.0, 11.0, 1.5)))


def _profiled(steps, slots=SLOTS):
    """``profiled_device_ms`` with ``steps`` generator steps of 1, 2, 3, 4,
    11 and 1.5 ms in ``slots``."""
    zero = {slot: {"ms": 0.0, "count": 0} for slot in slots}
    return {"gen": {s: {"ms": steps * SLOT_MS[s], "count": steps} for s in slots}, "disc": zero}


@pytest.mark.parametrize("name", READERS)
def test_mark_readers_give_nothing_without_the_counters(name, monkeypatch):
    """A reader of the marks is None where the program has no
    ``profiled_device_ms`` (the parent's), where it counted no step, and
    off the card; on the card it is the slot's ms over the steps."""
    read = spec.load_reader(ROOT, name)
    assert read(None) is None  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tracing, "profiled_device_ms", lambda device=None: _profiled(0))
    assert read(None) is None
    monkeypatch.setattr(tracing, "profiled_device_ms", lambda device=None: _profiled(3))
    slot = {"backward_device_ms": "loss_backward"}.get(name, name[:-len("_device_ms")])
    assert read(None) == pytest.approx(SLOT_MS[slot])
    monkeypatch.delattr(tracing, "profiled_device_ms")
    assert read(None) is None


def test_refeatures_reader_gives_nothing_without_the_slot(monkeypatch):
    """A program whose tally has no ``refeatures`` slot (the five slots of
    an older one) reads None, and does not raise."""
    read = spec.load_reader(ROOT, "refeatures_device_ms")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tracing, "profiled_device_ms",
                        lambda device=None: _profiled(3, SLOTS[:5]))
    assert read(None) is None
