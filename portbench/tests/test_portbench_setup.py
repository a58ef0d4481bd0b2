"""Set-up's calls on the CPU at the tiny size: a fused configuration runs
calls until every schedule the window meets has been captured; an engine
that runs eagerly captures nothing, so its set-up ends once each kind of
step has run."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness, spec
from portbench.tests.conftest import TINY, emulated_graphs


class OutOfMemoryGraph:
    """A capture that runs out of device memory, as ``CycleGraph`` raises it."""

    def __init__(self, *args, **kwargs):
        from otgan_tpu_torch.cycle_graph import CaptureOutOfMemory

        raise CaptureOutOfMemory("a capture that ran out of memory")


def setup_calls(cell, way: str):
    """The items set-up's loop took after the first call (a call's step
    count, None at an epoch's end) and the engine's ``fused_cycle_reason``."""
    if way == "no_fused_cycle":
        argv = [a if a != "--fused_cycle" else "--no_fused_cycle" for a in cell.config["argv"]]
        cell = dataclasses.replace(cell, config=dict(cell.config, fused_cycle=False, argv=argv))
    with emulated_graphs() as graphs_on:
        if way == "capture_oom":
            from otgan_tpu_torch import engine as engine_mod

            engine_mod.CycleGraph = OutOfMemoryGraph
        patch = graphs_on if way in ("fused", "capture_oom") else None
        prog = harness.Program(cell, 1, torch.device("cpu"), patch=patch)
        spans = harness.Spans()
        harness.first_cycle(prog, spans)
        taken = []
        call = prog.call

        def counted(s):
            taken.append(call(s))
            return taken[-1]

        prog.call = counted
        harness.setup(prog, spans)
        prog.close()
    return taken, prog.engine.fused_cycle_reason


@pytest.mark.parametrize("way,want", [
    # 2-batch epochs, 6-batch cycles (5:1): the first call ran steps 0-1
    # (D, G); set-up captures G:G (steps 2-3, 4-5) and D:G (6-7), each at
    # its first call, with an epoch's end before each
    ("fused", [None, 2, None, 2, None, 2]),
    # the CPU's engine: no graph, the first call already ran both kinds
    ("eager", []),
    # the first capture runs out of memory: that call runs eagerly, and
    # nothing is left to capture
    ("capture_oom", [None, 2]),
    # a configuration that states --no_fused_cycle: a call is one step; the
    # first ran a critic step, the next a generator's
    ("no_fused_cycle", [1]),
])
def test_setup_calls(tiny_root, way, want):
    taken, reason = setup_calls(spec.load(tiny_root, TINY), way)
    assert taken == want
    if way == "capture_oom":
        assert "ran out of device memory" in reason
