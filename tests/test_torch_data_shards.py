"""The port's loader (``otgan_tpu_torch/data/cifar10.py``) against the JAX
package's (``otgan_tpu/data/cifar10.py``) per process: for 1, 2 and 3
processes (3: shards of uneven size), each loader with the generator
``default_rng((seed, pid))``, the same batches over two epochs (tolerance
0), the same ``common_num_batches``, with the producer thread on and off
and on the native and the numpy path; ``--ingest_dtype compute`` in
bfloat16; and a producer's error, which re-raises in the consumer without
a hang."""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from otgan_tpu.data.cifar10 import DataLoader as JaxLoader
from otgan_tpu_torch import train as train_mod
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.cifar10 import DataLoader

SEED, ROWS, BATCH = 5, 101, 8  # 101 rows: shards of 34, 34 and 33 over 3 processes


def _data():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (ROWS, 32, 32, 3)).astype(np.uint8),
            rng.integers(0, 10, ROWS).astype(np.uint8))


def _as_np(x):
    if isinstance(x, torch.Tensor):  # the port's bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _batches(loader, epochs=2):
    out = []
    for _ in range(epochs):
        out.extend(loader.epoch())
    return out


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("pcount", [1, 2, 3])
def test_shards_match_the_jax_loader(pcount, prefetch, native):
    data, labels = _data()
    for pid in range(pcount):
        port = DataLoader("", batch_size=BATCH, rng=np.random.default_rng((SEED, pid)), data=data,
                          labels=labels, return_labels=True, process_index=pid,
                          process_count=pcount, prefetch=prefetch, native=native)
        ref = JaxLoader("", batch_size=BATCH, rng=np.random.default_rng((SEED, pid)), data=data,
                        labels=labels, return_labels=True, process_index=pid,
                        process_count=pcount, out_dtype="uint8")
        assert port.common_num_batches == ref.common_num_batches == (ROWS // pcount) // BATCH
        assert port.global_rows == ref.global_rows == ROWS
        np.testing.assert_array_equal(port.images_255(), ref.images_255())
        np.testing.assert_array_equal(port.init_batch(), ref.init_batch())
        got, want = _batches(port), _batches(ref)
        assert len(got) == len(want) == 2 * port.common_num_batches
        for (x, y), (xr, yr) in zip(got, want):
            assert x.dtype == np.uint8 and x.shape == (BATCH, 32, 32, 3)
            np.testing.assert_array_equal(x, xr)
            np.testing.assert_array_equal(y, yr)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_converted_batches_match_the_jax_loader(out_dtype):
    data, _ = _data()
    port = DataLoader("", batch_size=BATCH, rng=np.random.default_rng((SEED, 1)), data=data,
                      process_index=1, process_count=2, prefetch=2, out_dtype=out_dtype)
    ref = JaxLoader("", batch_size=BATCH, rng=np.random.default_rng((SEED, 1)), data=data,
                    process_index=1, process_count=2, out_dtype=out_dtype)
    np.testing.assert_array_equal(_as_np(port.init_batch()), _as_np(ref.init_batch()))
    for x, xr in zip(_batches(port), _batches(ref)):
        np.testing.assert_array_equal(_as_np(x), _as_np(xr))


def test_ingest_dtype_compute_emits_bfloat16():
    """``make_loader`` maps ``--ingest_dtype compute`` to the compute dtype,
    as ``otgan_tpu/train.py:299-303`` does; the synthetic set of several
    processes is one set, sharded."""
    cfg = TrainConfig(synthetic_data=True, synthetic_size=48, batch_size=16,
                      ingest_dtype="compute", seed=SEED)
    one = train_mod.make_loader(cfg, np.random.default_rng(SEED))
    x = next(iter(one.epoch()))
    assert x.dtype == torch.bfloat16 and x.shape == (16, 32, 32, 3)
    assert train_mod.make_loader(
        TrainConfig(synthetic_data=True, synthetic_size=48, batch_size=16,
                    ingest_dtype="compute", compute_dtype="float32"),
        np.random.default_rng(SEED)).init_batch().dtype == np.float32
    shards = [train_mod.make_loader(cfg, np.random.default_rng((SEED, p)), p, 2) for p in (0, 1)]
    full = train_mod.make_loader(cfg, np.random.default_rng(SEED))  # one process: the same set
    assert [s.batch_size for s in shards] == [8, 8]
    np.testing.assert_array_equal(shards[1].images_255(), full.images_255()[1::2])


def _consume(gen, out):
    try:
        for item in gen:
            out.append(item)
    except Exception as e:
        out.append(e)


def test_producer_error_reraises_in_the_consumer():
    data, _ = _data()
    loader = DataLoader("", batch_size=BATCH, data=data, prefetch=2)
    real, calls = loader._make_batch, []

    def fails_third(idx):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk gone")
        return real(idx)

    loader._make_batch = fails_third
    out = []
    worker = threading.Thread(target=_consume, args=(loader.epoch(), out))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive(), "the consumer hung on a failed producer"
    assert len(out) == 3 and isinstance(out[2], OSError) and "disk gone" in str(out[2])


def test_a_consumer_that_stops_early_releases_the_producer():
    data, _ = _data()
    loader = DataLoader("", batch_size=1, data=data, prefetch=1)
    gen = loader.epoch()
    next(gen)
    done = threading.Thread(target=gen.close)
    done.start()
    done.join(timeout=60)
    assert not done.is_alive(), "closing the epoch did not stop its producer"
    assert not [t for t in threading.enumerate() if t.name == "cifar10-prefetch"]
