"""Fixtures of the benchmark's own tests: a benchmark root at a tiny size
(the DCGAN at its published widths, batch 4, 5 Sinkhorn iterations, 8
images), built from the real configuration file, so the harness runs on
the CPU in seconds."""

from __future__ import annotations

import contextlib
import json
import os
import shutil

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
TINY = "tiny.t8"


def make_root(path: str, limits: dict) -> str:
    """A benchmark root under ``path``: BENCHMARK.json with one cell,
    ``tiny.t8``, and its configuration, traffic, limits, and the metric
    readers and model families' references of the real benchmark."""
    base = os.path.join(path, "portbench")
    for sub in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for sub in ("metrics", "reference"):
        shutil.copytree(os.path.join(PORTBENCH, sub), os.path.join(base, sub), dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(PORTBENCH, "configs", "dcgan_train_py.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", batch_size=4, nr_sinkhorn_iter=5)
    argv = cfg["argv"]
    argv[argv.index("--batch_size") + 1] = "4"
    argv[argv.index("--nr_sinkhorn_iter") + 1] = "5"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="tiny", file="portbench/configs/tiny.json")]
    bench["workloads"] = [{"name": TINY, "config": "tiny", "traffic": "t8", "chips": 1,
                           "why": "the harness end to end at a tiny size"}]
    files = {"configs/tiny.json": cfg,
             "traffic/t8.json": {"synthetic_size": 8, "ranks": 1, "trace_groups": 2},
             f"workloads/{TINY}.json": {"limits": limits}}
    for rel, obj in files.items():
        with open(os.path.join(base, rel), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


# limits at the tiny size, from CPU readings on seeds 1-3 (the calls after
# the first replaying emulated graphs): the program read at most dist_first
# 3.3e-7, entropy_first 5.8e-7, dist 1.1e-4, grad 2.7e-4, change 1.5e-3,
# replay_dist_first 0, replay_entropy_first 2.5e-7, replay_dist 1.3e-4 and
# replay_change 1.6e-3; the control (TF32 matching) dist_first 1.1e-5 to
# 1.0e-3, replay_dist_first 5.3e-7 to 2.1e-5, replay_entropy_first 2.2e-5 to
# 5.1e-4; half the batch entropy_first 1.0; an unchanged state change 1.0;
# stale replays replay_dist_first 1.0e-3 to 1.4e-2, replay_dist 2.9e-3 to
# 1.5e-2, replay_change 7.6e-3 to 2.5e-2 (the replay distance numbers are
# gaps over the reference's dist_scale)
TINY_LIMITS = {"dist_first": 5e-6, "entropy_first": 5e-6, "dist": 2e-3, "grad": 5e-3,
               "change": 2e-2, "replay_dist_first": 3e-6, "replay_entropy_first": 5e-6,
               "replay_dist": 1e-3, "replay_change": 5e-3}


class EmulatedGraph:
    """``cycle_graph.CycleGraph`` without a card, as the engine sees it: the
    capture keeps copies of its call's batches and runs nothing (a CUDA
    graph's capture runs none of its work); a replay copies the call's
    batches into them and runs the cycle on them, eagerly."""

    def __init__(self, engine, state, xs, graph_factory=None, pool=None):
        self.engine = engine
        self.static_xs = [x.clone() for x in xs]
        self.pool = pool if pool is not None else ("pool", id(self))

    def replay(self, state, xs):
        for s, x in zip(self.static_xs, xs):
            s.copy_(x)
        return self.engine.cycle(state, self.static_xs)


@contextlib.contextmanager
def emulated_graphs():
    """Engines built inside take the card's fused-cycle path with
    :class:`EmulatedGraph`s: the first call eager, every later one a replay
    of its schedule's graph. Yields the patch that turns an engine's graphs
    on."""
    from otgan_tpu_torch import engine as engine_mod

    real = engine_mod.CycleGraph
    engine_mod.CycleGraph = EmulatedGraph

    def graphs_on(engine):
        engine.cycle_graphs = True

    try:
        yield graphs_on
    finally:
        engine_mod.CycleGraph = real


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(str(tmp_path_factory.mktemp("bench")), TINY_LIMITS)


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
