"""Finding a cell's pieces by name under a benchmark root (the checkout, or
a test's directory):

* ``BENCHMARK.json``: the cell's configuration, traffic and chips, and the
  metrics it reports;
* ``portbench/configs/<config>.json``: the configuration as it is run (its
  trainer flags, the sizes the yardstick counts, its source and cuts);
* ``portbench/reference/<model>.py``: the plain reference of the
  configuration's model family (``reference/train.py`` names the interface);
* ``portbench/traffic/<traffic>.json``: the data stream (synthetic set size,
  ranks, the traced stretch);
* ``portbench/workloads/<cell>.json``: the limits of the cell's check;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    per_layer: List[dict]
    end_to_end: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)
    family: Optional[ModuleType] = None


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: str, name: str) -> Callable:
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    return _module(path, f"portbench_metric_{name.replace('.', '_')}").read


def load_family(root: str, model: str) -> ModuleType:
    """The plain reference of the model family ``model``:
    ``portbench/reference/<model>.py`` under ``root``."""
    path = os.path.join(root, "portbench", "reference", f"{model}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"model {model!r} has no plain reference: {path} is missing")
    return _module(path, f"portbench_reference_{model.replace('.', '_')}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, cell_name: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[cell_name]
    base = os.path.join(root, "portbench")
    config = _json(os.path.join(base, "configs", f"{w['config']}.json"))
    traffic = _json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    if traffic["ranks"] != w["chips"]:
        raise ValueError(f"cell {cell_name}: traffic {w['traffic']} runs {traffic['ranks']} "
                         f"ranks on {w['chips']} chips")
    try:
        family = load_family(root, config["model"])
    except FileNotFoundError as e:
        raise FileNotFoundError(f"cell {cell_name}, configuration {w['config']}: {e}") from None
    limits = _json(os.path.join(base, "workloads", f"{cell_name}.json"))["limits"]
    per_layer = [m for m in bench["per_layer"] if applies(m, cell_name)]
    end_to_end = [m for m in bench["end_to_end"] if applies(m, cell_name)]
    cell = Cell(cell_name, config, traffic, w["chips"], limits, per_layer, end_to_end,
                family=family)
    cell.readers = {m["name"]: load_reader(root, m["name"]) for m in per_layer}
    return cell
