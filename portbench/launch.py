"""Running a cell's K rank processes to their end (after ``chip_smoke.py``'s
``run_group``): the kernels are built once, then ``torchrun --standalone``
(which picks a free local port for the rendezvous itself) starts K copies
of a ``portbench`` module with ``--worker``. The group gets its own
session; on a timeout every process it started gets SIGABRT first (under
``PYTHONFAULTHANDLER`` each prints its threads' stacks: where a rank hung),
then all are killed and waited for."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Sequence


def descendants(pid: int) -> list:
    """The processes ``pid`` started, and theirs, from ``/proc``."""
    children = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def run_group(cmd, timeout: float, env, cwd: str) -> subprocess.CompletedProcess:
    proc = subprocess.Popen(cmd, cwd=cwd, env=dict(env, PYTHONFAULTHANDLER="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        started = descendants(proc.pid)
        for sig in (signal.SIGABRT, signal.SIGKILL):
            for pid in started + ([proc.pid] if sig == signal.SIGKILL else []):
                try:
                    os.kill(pid, sig)
                except ProcessLookupError:
                    pass
            time.sleep(5)
        out, err = proc.communicate()
        print(out[-3000:], flush=True)
        print(err[-12000:], file=sys.stderr, flush=True)
        raise
    finally:
        for pid in descendants(proc.pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def ranks(module: str, args: Sequence[str], chips: int, timeout: float, cwd: str,
          env=None) -> subprocess.CompletedProcess:
    """``python -m module --worker *args`` on ``chips`` ranks, the kernels
    built first (once, not in every rank at once)."""
    from otgan_tpu_torch.kernels.build import build_all

    build_all()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={chips}", "-m", module, "--worker", *args]
    return run_group(cmd, timeout, dict(os.environ) if env is None else env, cwd)
