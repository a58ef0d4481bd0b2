"""Launch watchdog (counterpart of ``otgan_tpu/utils/init_watchdog.py``):
fail loudly instead of hanging when a run cannot start.

A multi-host launch blocks in ``init_process_group`` until every peer has
joined, and the first CUDA call of a process can block on a card that does
not answer; neither prints anything while it waits. ``arm(timeout)``
starts a daemon thread that ends the process with a FATAL line unless
:meth:`InitWatchdog.disarm` is called within ``timeout`` seconds. The
trainer arms it with ``OTGAN_INIT_TIMEOUT`` seconds (off by default: peers
may legitimately take long to come up) around process-group init and the
first device query only; kernel builds and the first steps are never under
it.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Optional


class InitWatchdog:
    def __init__(self, event: threading.Event):
        self._event = event

    def disarm(self) -> None:
        """Call as soon as the process group is up and the device answered."""
        self._event.set()


def _default_timeout_action(timeout: float) -> None:  # pragma: no cover
    print(
        f"FATAL: launch did not complete within {timeout:.0f}s: process-group init "
        "(peers missing or unreachable) or the first CUDA device query hung",
        file=sys.stderr,
        flush=True,
    )
    os._exit(2)


def arm(timeout: float, on_timeout: Optional[Callable[[], None]] = None) -> InitWatchdog:
    """Arm a watchdog; returns the handle whose ``disarm()`` stands it
    down. ``timeout <= 0`` disables it (an already-disarmed handle).
    ``on_timeout`` defaults to a FATAL line and ``os._exit(2)`` (an
    exception raised in a daemon thread would vanish)."""
    ev = threading.Event()
    wd = InitWatchdog(ev)
    if timeout <= 0:
        ev.set()
        return wd
    action = on_timeout or (lambda: _default_timeout_action(timeout))

    def _watch() -> None:
        if not ev.wait(timeout):
            action()

    threading.Thread(target=_watch, name="init-watchdog", daemon=True).start()
    return wd
