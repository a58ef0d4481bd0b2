"""CIFAR-10 data (counterpart of ``otgan_tpu/data/cifar10.py``, after the
reference's ``data/cifar10_data.py``).

``load`` unpickles the 5 train / 1 test batches to ``(N, 3, 32, 32)``
uint8, downloading and extracting the archive first if it is absent.
``DataLoader`` keeps the dataset uint8 NHWC in host memory and emits
shuffled, randomly flipped batches: raw uint8 by default (the engine
normalises on the device), or float32 in [-1, 1], with their labels under
``return_labels``; ``images_255`` gives the real side of the FID
statistics. It is the JAX package's numpy path, drawing from the same
``numpy.random.Generator`` in the same order, so one seed gives both
packages the same batches. The native ctypes assembler and the background
prefetch thread come in a later slice.
"""

from __future__ import annotations

import os
import pickle
import tarfile
import urllib.request
from typing import Iterator, Optional, Tuple

import numpy as np

CIFAR_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"


def maybe_download_and_extract(data_dir: str, url: str = CIFAR_URL) -> None:
    """Fetch and untar if ``cifar-10-batches-py`` is absent; members that
    would land outside ``data_dir`` are refused."""
    batches_dir = os.path.join(data_dir, "cifar-10-batches-py")
    if os.path.exists(batches_dir):
        return
    os.makedirs(data_dir, exist_ok=True)
    filepath = os.path.join(data_dir, url.split("/")[-1])
    if not os.path.exists(filepath):
        print(f"downloading {url} -> {filepath}")
        urllib.request.urlretrieve(url, filepath)
    with tarfile.open(filepath, "r:gz") as tar:
        tar.extractall(data_dir, filter="data")


def _unpickle(path: str):
    with open(path, "rb") as fo:
        d = pickle.load(fo, encoding="latin1")
    return d["data"].reshape((-1, 3, 32, 32)), np.asarray(d["labels"], np.uint8)


def load(data_dir: str, subset: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """``(x, y)`` with x uint8 ``(N, 3, 32, 32)``."""
    maybe_download_and_extract(data_dir)
    bdir = os.path.join(data_dir, "cifar-10-batches-py")
    if subset == "train":
        parts = [_unpickle(os.path.join(bdir, f"data_batch_{i}")) for i in range(1, 6)]
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
        )
    if subset == "test":
        return _unpickle(os.path.join(bdir, "test_batch"))
    raise NotImplementedError("subset should be either train or test")


def random_flip(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """50% horizontal flip of an NHWC batch."""
    mask = rng.random(x.shape[0]) < 0.5
    out = x.copy()
    out[mask] = out[mask, :, ::-1, :]
    return out


def synthetic(rng: np.random.Generator, size: int) -> np.ndarray:
    """CIFAR-shaped random uint8 images, as ``--synthetic_data`` draws them."""
    return rng.integers(0, 256, (size, 32, 32, 3)).astype(np.uint8)


class DataLoader:
    """In-RAM epoch iterator with shuffle and flip over uint8 NHWC images.

    ``data`` (uint8 NHWC) and ``labels`` replace loading ``data_dir``;
    ``out_dtype`` is ``"uint8"`` (raw bytes) or ``"float32"`` (``x / 127.5 -
    1``); ``return_labels`` makes batches ``(x, labels)``.
    """

    def __init__(self, data_dir: str, subset: str = "train", batch_size: int = 256,
                 rng: Optional[np.random.Generator] = None, shuffle: bool = True,
                 augment_flip: bool = True, data: Optional[np.ndarray] = None,
                 out_dtype: str = "uint8", labels: Optional[np.ndarray] = None,
                 return_labels: bool = False):
        if data is None:
            raw, labels = load(os.path.join(data_dir, "cifar-10-python"), subset)
            data = np.transpose(raw, (0, 2, 3, 1))
        if data.dtype != np.uint8 or data.ndim != 4:
            raise ValueError(f"expected uint8 NHWC images, got {data.dtype} {data.shape}")
        if out_dtype not in ("uint8", "float32"):
            raise ValueError(f"out_dtype must be uint8 or float32, got {out_dtype!r}")
        self.data = np.ascontiguousarray(data)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment_flip = augment_flip
        self.rng = rng if rng is not None else np.random.default_rng(1)
        self.out_dtype = out_dtype
        if return_labels and labels is None:
            raise ValueError("return_labels needs labels (the synthetic set has none)")
        self.labels = labels
        self.return_labels = return_labels

    @property
    def num_batches(self) -> int:
        return self.data.shape[0] // self.batch_size

    def _emit(self, x: np.ndarray) -> np.ndarray:
        if self.out_dtype == "float32":
            return x.astype(np.float32) / 127.5 - 1.0
        return x

    def _make_batch(self, idx: np.ndarray):
        x = self.data[idx]
        if self.augment_flip:
            x = random_flip(x, self.rng)
        x = self._emit(x)
        return (x, self.labels[idx]) if self.return_labels else x

    def init_batch(self, n: Optional[int] = None) -> np.ndarray:
        """The first ``n`` (default ``batch_size``) examples, unshuffled and
        unflipped, for the data-dependent init; consumes no randomness."""
        n = n or self.batch_size
        if n > self.data.shape[0]:
            raise ValueError(
                f"init_batch({n}) exceeds the {self.data.shape[0]} data rows"
            )
        return self._emit(self.data[:n].copy())

    def images_255(self, limit: Optional[int] = None) -> np.ndarray:
        """The first ``limit`` (default all) images, uint8 NHWC in [0, 255],
        unshuffled and unflipped: the real side of the FID statistics."""
        return self.data if limit is None else self.data[:limit]

    def epoch(self) -> Iterator[np.ndarray]:
        """One pass: ``num_batches`` whole batches."""
        n = self.data.shape[0]
        inds = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for t in range(self.num_batches):
            yield self._make_batch(inds[t * self.batch_size:(t + 1) * self.batch_size])

    def __iter__(self):
        return self.epoch()
