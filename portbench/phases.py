"""The program's own phase marks, for the per-layer readers that read them.

The engine marks each step and each of its phases on the card, inside its
CUDA graphs as in eager steps (``otgan_tpu_torch/utils/tracing.py``), and
counts the device time between the marks itself.
``tracing.profiled_device_ms`` holds the totals of the calls that ran while
the traced stretch's profiler recorded. :func:`per_step` is a slot's device
ms over the steps the program counted there: None where the program has no
marks, counted no step, or runs off the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def per_step(slot: str) -> Optional[float]:
    try:
        from otgan_tpu_torch.utils.tracing import profiled_device_ms
    except ImportError:
        return None
    if not torch.cuda.is_available():
        return None
    totals = profiled_device_ms(torch.device("cuda", torch.cuda.current_device()))
    steps = sum(kind["step"]["count"] for kind in totals.values())
    if not steps:
        return None
    return sum(kind[slot]["ms"] for kind in totals.values()) / steps
