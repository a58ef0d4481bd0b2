"""Nothing a run loads has the top-level name ``jax``, ``jaxlib`` or
``otgan_tpu`` (names compared whole: the port's own name begins with the
JAX package's), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "otgan_tpu"}

PROBE = """
import json, sys, time, torch
torch.set_num_threads(2)
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    mods = loaded("from portbench.reference import train\n"
                  "train.follow  # the whole reference")
    assert not mods & (FORBIDDEN | {"otgan_tpu_torch"})


def test_a_run_loads_no_jax(tiny_root):
    mods = loaded(f"from portbench import harness, spec\n"
                  f"cell = spec.load({tiny_root!r}, {TINY!r})\n"
                  f"harness.run(cell, 3, 0.1, False, time.time(), device=torch.device('cpu'))")
    assert "otgan_tpu_torch" in mods
    assert not mods & FORBIDDEN
