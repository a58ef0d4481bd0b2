"""JSONL metric logging (counterpart of ``otgan_tpu/utils/metrics.py``):
one JSON record per ``log`` call, mirrored to stdout, and the reference's
per-epoch ``distances.npz`` history (``train.py:229-231,277``)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, List, Optional

import numpy as np


class MetricLogger:
    def __init__(self, save_dir: str, filename: str = "metrics.jsonl", echo: bool = True):
        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
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

    @staticmethod
    def _nan_free(vals: List[Optional[float]]) -> np.ndarray:
        """A per-epoch history as an array with no NaN: a ``None`` (an epoch
        before the first step of that kind) takes the first observed value,
        so the array keeps one entry an epoch; a history of only ``None``
        gives an empty array."""
        first = next((v for v in vals if v is not None), None)
        if first is None:
            return np.asarray([], dtype=np.float64)
        return np.asarray([first if v is None else v for v in vals])

    def save_distances(self, mean_dist_gen: List[Optional[float]],
                       mean_dist_disc: List[Optional[float]]) -> str:
        """Writes ``distances.npz`` (``mean_dist_gen``, ``mean_dist_disc``,
        one entry an epoch) into the run directory; returns its path."""
        path = os.path.join(self.save_dir, "distances.npz")
        np.savez(path, mean_dist_gen=self._nan_free(mean_dist_gen),
                 mean_dist_disc=self._nan_free(mean_dist_disc))
        return path

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
