"""CIFAR-10 data (counterpart of ``otgan_tpu/data/cifar10.py``, after the
reference's ``data/cifar10_data.py``).

``load`` unpickles the 5 train / 1 test batches to ``(N, 3, 32, 32)``
uint8, downloading and extracting the archive first if it is absent.
``DataLoader`` keeps the dataset uint8 NHWC in host memory and emits
shuffled, randomly flipped batches: raw uint8 by default (the engine
normalises on the device), float32 in [-1, 1], or bfloat16 (a CPU torch
tensor), with their labels under ``return_labels``; ``images_255`` gives
the real side of the FID statistics. Batches are assembled by the native
library (``data/native.py``; ``native=False``, or a host without ``g++``:
numpy, the same bytes). Under several processes each keeps the dataset's
rows ``process_index::process_count`` and its ``batch_size`` is the
per-process batch; every process emits ``common_num_batches`` a epoch.
``prefetch`` > 0 assembles batches ahead on a producer thread. The loader
draws its permutations and flips from the same ``numpy.random.Generator``
in the same order as the JAX package's, native or not, with the thread or
without, so one seed gives both packages the same batches on every
process.
"""

from __future__ import annotations

import os
import pickle
import queue
import tarfile
import threading
import urllib.request
from typing import Iterator, Optional, Tuple

import numpy as np

from otgan_tpu_torch.data import native as native_mod

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
    ``out_dtype`` is ``"uint8"`` (raw bytes), ``"float32"`` (``x / 127.5 -
    1``) or ``"bfloat16"`` (those values rounded to nearest even, as a CPU
    ``torch.bfloat16`` tensor); ``return_labels`` makes batches ``(x,
    labels)``. ``native`` assembles in the C library (and transposes a
    loaded dataset there); ``process_index`` / ``process_count`` keep this
    process's rows; ``prefetch`` is the depth of the producer thread's queue
    (0: assemble on the consuming thread).
    """

    def __init__(self, data_dir: str, subset: str = "train", batch_size: int = 256,
                 rng: Optional[np.random.Generator] = None, shuffle: bool = True,
                 augment_flip: bool = True, data: Optional[np.ndarray] = None,
                 out_dtype: str = "uint8", labels: Optional[np.ndarray] = None,
                 return_labels: bool = False, native: bool = True, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 0):
        if data is None:
            raw, labels = load(os.path.join(data_dir, "cifar-10-python"), subset)
            data = (native_mod.nchw_to_nhwc_u8(raw) if native
                    else np.transpose(raw, (0, 2, 3, 1)))
        if data.dtype != np.uint8 or data.ndim != 4:
            raise ValueError(f"expected uint8 NHWC images, got {data.dtype} {data.shape}")
        if out_dtype not in ("uint8", "float32", "bfloat16"):
            raise ValueError(f"out_dtype must be uint8, float32 or bfloat16, got {out_dtype!r}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in [0, {process_count})")
        if return_labels and labels is None:
            raise ValueError("return_labels needs labels (the synthetic set has none)")
        # the dataset's size before the shards: every process derives the
        # same batch count from it (common_num_batches)
        self.global_rows = data.shape[0]
        self.process_count = process_count
        if process_count > 1:
            data = data[process_index::process_count]
            if labels is not None:
                labels = labels[process_index::process_count]
        self.data = np.ascontiguousarray(data)
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment_flip = augment_flip
        self.rng = rng if rng is not None else np.random.default_rng(1)
        self.out_dtype = out_dtype
        self.return_labels = return_labels
        self.native = native
        self.prefetch = prefetch

    @property
    def num_batches(self) -> int:
        """Whole batches in this process's shard."""
        return self.data.shape[0] // self.batch_size

    @property
    def common_num_batches(self) -> int:
        """Batches a epoch on every process: from the smallest shard
        (``global_rows // process_count`` rows), since shards that differ by
        a row would otherwise disagree on the count and leave a collective
        without its peers."""
        return (self.global_rows // self.process_count) // self.batch_size

    def native_available(self) -> bool:
        """Whether this loader's batches come from the native library."""
        return self.native and native_mod.native_available()

    def _assemble(self, idx: np.ndarray, flips: Optional[np.ndarray]):
        assemble = (native_mod.assemble_batch_u8 if self.native
                    else native_mod.assemble_batch_numpy)
        return assemble(self.data, idx, flips, out_dtype=self.out_dtype)

    def _make_batch(self, idx: np.ndarray):
        flips = ((self.rng.random(idx.shape[0]) < 0.5).astype(np.uint8)
                 if self.augment_flip else None)
        x = self._assemble(idx, flips)
        return (x, self.labels[idx]) if self.return_labels else x

    def init_batch(self, n: Optional[int] = None):
        """The first ``n`` (default ``batch_size``) examples of this
        process's shard, unshuffled and unflipped, for the data-dependent
        init; consumes no randomness and starts no thread."""
        n = n or self.batch_size
        if n > self.data.shape[0]:
            raise ValueError(
                f"init_batch({n}) exceeds this process's {self.data.shape[0]} data rows: lower "
                "--init_batch_size (or --batch_size), or use fewer processes"
            )
        return self._assemble(np.arange(n), None)

    def images_255(self, limit: Optional[int] = None) -> np.ndarray:
        """The first ``limit`` (default all) images of this process's shard,
        uint8 NHWC in [0, 255], unshuffled and unflipped: the real side of
        the FID statistics."""
        return self.data if limit is None else self.data[:limit]

    def epoch(self) -> Iterator:
        """One pass: ``common_num_batches`` whole batches, assembled ahead on
        a producer thread when ``prefetch`` > 0; an error there is raised
        here, at the batch it would have made."""
        n = self.data.shape[0]
        inds = self.rng.permutation(n) if self.shuffle else np.arange(n)
        slices = [inds[t * self.batch_size:(t + 1) * self.batch_size]
                  for t in range(self.common_num_batches)]
        if self.prefetch <= 0:
            for idx in slices:
                yield self._make_batch(idx)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce() -> None:
            try:
                for idx in slices:
                    if not put(self._make_batch(idx)):
                        return
                put(done)
            except BaseException as e:  # re-raised by the consumer below
                put(e)

        thread = threading.Thread(target=produce, name="cifar10-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (or raised) releases the producer
            stop.set()
            thread.join()

    def __iter__(self):
        return self.epoch()
