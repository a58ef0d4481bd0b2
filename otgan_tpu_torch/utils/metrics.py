"""JSONL metric logging (counterpart of ``otgan_tpu/utils/metrics.py``):
one JSON record per ``log`` call, mirrored to stdout."""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


class MetricLogger:
    def __init__(self, save_dir: str, filename: str = "metrics.jsonl", echo: bool = True):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, filename)
        self.echo = echo
        self._fh = open(self.path, "a", buffering=1)

    def log(self, step: int, **values: Any) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            if not isinstance(v, bool):
                v = float(v) if isinstance(v, (int, float, np.floating)) else v
            rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            parts = ", ".join(
                f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in values.items()
            )
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
