"""The trainer's host prefetch (``otgan_tpu_torch/train.py``,
``_prefetch_placed``, the counterpart of ``otgan_tpu/train.py:51-102``):
the same items in the same order as placing inline, the next item placed
on the worker thread while the caller holds the current one (across an
epoch's end too), a worker's error raised at the consuming ``yield``, and
the trainer's metrics and final state equal (tolerance 0) with
``--host_prefetch`` and ``--no_host_prefetch``."""

import threading

import numpy as np
import pytest
import torch

from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.utils.checkpoint import _named_tensors

ITEMS = [(0, "a"), (0, "b"), (0, None), (1, "c"), (1, "d"), (1, None)]


@pytest.mark.parametrize("depth", [0, 1])
def test_same_items_in_the_same_order(depth):
    threads = []

    def place(x):
        threads.append(threading.current_thread().name)
        return x.upper()

    got = list(train_mod._prefetch_placed(iter(ITEMS), place, depth=depth))
    assert got == [(ep, None if x is None else x.upper()) for ep, x in ITEMS]
    main = threading.current_thread().name
    assert len(threads) == 4 and all((t == main) == (depth == 0) for t in threads)


def test_the_next_item_is_placed_while_the_caller_holds_this_one():
    """While the caller holds item i, item i + 1 is placed on the worker:
    after a batch, and after an epoch's end (the next epoch's first)."""
    placed = {x: threading.Event() for _, x in ITEMS if x is not None}

    def place(x):
        placed[x].set()
        return x

    for i, _ in enumerate(train_mod._prefetch_placed(iter(ITEMS), place, depth=1)):
        if i + 1 < len(ITEMS) and ITEMS[i + 1][1] is not None:
            assert placed[ITEMS[i + 1][1]].wait(10), f"item {i + 1} was not placed during {i}"


def test_a_worker_error_is_raised_at_the_consuming_yield():
    def place(x):
        if x == "c":
            raise OSError("copy failed")
        return x

    got = []
    with pytest.raises(OSError, match="copy failed"):
        for item in train_mod._prefetch_placed(iter(ITEMS), place, depth=1):
            got.append(item)
    assert got == ITEMS[:3]


def _densenet_run(tmp_path, prefetch: bool):
    torch.set_num_threads(2)
    return train_mod.main([
        "--device", "cpu", "--model", "densenet", "--layers_per_block", "1",
        "--filters_per_layer", "4", "--batch_size", "8", "--synthetic_data", "--synthetic_size",
        "24", "--nr_sinkhorn_iter", "10", "--max_epochs", "2", "--log_every_steps", "1",
        "--save_every_epochs", "100", "--save_dir", str(tmp_path / str(prefetch)),
        "--host_prefetch" if prefetch else "--no_host_prefetch"])


def test_trainer_metrics_equal_with_and_without_prefetch(tmp_path):
    on, off = _densenet_run(tmp_path, True), _densenet_run(tmp_path, False)
    strip = lambda steps: [{k: v for k, v in r.items() if k != "step_ms"} for r in steps]  # noqa: E731
    assert len(on.steps) == 6 and strip(on.steps) == strip(off.steps)
    assert all(np.isfinite(r["dist"]) for r in on.steps)
    for (k, a), (_, b) in zip(_named_tensors(on.state), _named_tensors(off.state)):
        assert torch.equal(a, b), k


def test_step_gaps_read_the_idle_time_between_steps(tmp_path):
    """``utils/tracing.py::step_gaps`` on a written trace: two steps whose
    marks (``csrc/phase_marks.cu``) end at 100 and begin again at 130 us, a
    host-to-device copy of 10 us inside the gap, a kernel outside every
    step that runs 5 us of it, and one after the steps."""
    import json

    from otgan_tpu_torch.utils.tracing import step_gaps

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    def mark(kind, edge, ts):
        return ev("kernel", f"void otgan_mark<{kind}, step, {edge}>(unsigned long long*)", ts, 1)

    events = [ev("user_annotation", "cycle", 0, 10),
              mark("disc", "begin", 25), ev("kernel", "a", 30, 40), ev("kernel", "b", 70, 28),
              mark("disc", "end", 99), mark("gen", "begin", 130), ev("kernel", "c", 131, 19),
              mark("gen", "end", 150), ev("kernel", "d", 300, 5),
              ev("kernel", "sample", 122, 5),
              ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 110, 10)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = step_gaps(str(path))
    assert got["gaps_ms"] == [0.03] and got["copy_ms"] == [0.01]
    assert got["idle_ms"] == pytest.approx([0.015])  # 30 us less the copy's 10 and the 5 beside
