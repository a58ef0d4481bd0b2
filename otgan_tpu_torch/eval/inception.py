"""Inception score (counterpart of ``otgan_tpu/eval/inception.py``).

API of the reference: ``get_inception_score(images, splits=10) -> (mean,
std)`` over uint8-range RGB images (``utils/inception.py:24-52``), plus the
JAX package's streaming scorers, which classify generated batches where
they are made and move only per-split statistics to the host.

* Weights: the converters' npz (``convert_tf2015_inception.py``,
  ``convert_torch_inception.py``, or ``random_weights.py``) at
  ``OTGAN_INCEPTION_WEIGHTS``, default ``/tmp/imagenet/inception_v3_jax.npz``
  - the same files as the JAX package's, so one converted file serves both.
  Its ``__variant__`` marker picks the network and preprocessing variant
  (``torchvision`` when absent). Missing weights raise
  ``FileNotFoundError``; the trainer then skips its eval events.
* Classifier batch: ``batch=`` or ``OTGAN_INCEPTION_BATCH`` (default 100,
  the reference protocol, ``utils/inception.py:34``). Each image's
  probabilities do not depend on its batch, so the batch changes only the
  speed.
* Every scorer runs in float32 under ``torch.inference_mode()`` with TF32
  off for cuDNN convs and for matmuls (:func:`scoring_mode`; the caller's
  settings are restored after). TF32's 10-bit mantissa would move the pool
  features by ~1e-3 relative.
* Entry points take ``net`` (an :class:`~otgan_tpu_torch.eval.inception_net.
  InceptionV3`) or load it onto ``device``, which defaults to the card.

Split-KL math is the reference's (``utils/inception.py:46-52``): over
``splits`` chunks of the edges i*n//splits, ``exp(mean_i KL(p(y|x_i) ||
mean_j p(y|x_j)))``; returns (mean, std). ``x log x`` takes its limit 0 at
exact zeros (float32 softmax underflows there for extreme logits). The
device reduction keeps per-split sufficient statistics in float32, ``S1 =
sum p`` and ``S2 = sum_j p_j log p_j``, and finishes on the host in float64;
``OTGAN_EVAL_DEVICE_REDUCE=0`` stages every probability on the host and
reduces in float64 instead.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from otgan_tpu_torch.engine import resolve_device
from otgan_tpu_torch.eval.inception_net import InceptionV3, param_spec

DEFAULT_WEIGHTS = "/tmp/imagenet/inception_v3_jax.npz"
DEFAULT_BATCH = 100


class Weights(NamedTuple):
    params: Dict  # the JAX-layout tree (float32 numpy)
    variant: str


def load_params(path: Optional[str] = None) -> Weights:
    """The classifier weights of the npz at ``path`` (default
    ``OTGAN_INCEPTION_WEIGHTS``, else :data:`DEFAULT_WEIGHTS`), shapes
    checked against the spec."""
    path = path or os.environ.get("OTGAN_INCEPTION_WEIGHTS", DEFAULT_WEIGHTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Inception weights not found at {path}. Convert the reference's "
            "frozen TF-2015 graph with otgan_tpu_torch/eval/"
            "convert_tf2015_inception.py (exact IS parity) or a torchvision "
            "checkpoint with convert_torch_inception.py, write fixed-seed "
            "random weights with random_weights.py, or set OTGAN_INCEPTION_WEIGHTS."
        )
    with np.load(path) as data:
        variant = _variant(data)
        spec = param_spec(num_classes=int(data["fc/b"].shape[0]))

        def build(spec, prefix=""):
            out = {}
            for k, v in spec.items():
                key = f"{prefix}{k}"
                if isinstance(v, tuple):
                    arr = data[key]
                    if tuple(arr.shape) != v:
                        raise ValueError(f"weight {key}: expected {v}, got {arr.shape}")
                    out[k] = np.asarray(arr, np.float32)
                else:
                    out[k] = build(v, prefix=f"{key}/")
            return out

        return Weights(build(spec), variant)


def _variant(data) -> str:
    return bytes(data["__variant__"]).decode("utf-8") if "__variant__" in data else "torchvision"


def get_variant(path: Optional[str] = None) -> str:
    """The network and preprocessing variant of the weights at ``path``
    (default as :func:`load_params`), from the npz's ``__variant__``
    marker alone; a loaded network carries it as ``net.variant``."""
    with np.load(path or os.environ.get("OTGAN_INCEPTION_WEIGHTS", DEFAULT_WEIGHTS)) as data:
        return _variant(data)


def load_net(path: Optional[str] = None, device=None) -> InceptionV3:
    """The network of :func:`load_params` on ``device`` (default: the card)."""
    w = load_params(path)
    return InceptionV3.from_params(w.params, w.variant, resolve_device(device))


def default_batch() -> int:
    return int(os.environ.get("OTGAN_INCEPTION_BATCH", str(DEFAULT_BATCH)))


def _check_batch(batch: int) -> None:
    """A non-positive batch makes every chunk loop empty, and the scorers
    would finish from all-zero statistics (IS 1.0, FID NaN) silently."""
    if batch < 1:
        raise ValueError(
            f"inception classifier batch must be >= 1, got {batch} "
            "(--inception_batch / OTGAN_INCEPTION_BATCH)"
        )


def _net_device(net: InceptionV3) -> torch.device:
    return next(net.parameters()).device


@contextlib.contextmanager
def scoring_mode():
    """``torch.inference_mode()`` with TF32 off for cuDNN and for matmuls;
    the caller's TF32 settings come back afterwards."""
    keep = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep


def _resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 ``ResizeBilinear`` (align_corners=False, legacy sampling without
    the half-pixel offset: src = out_idx * in/out), the resize the frozen
    2015 graph applies to its input. NHWC."""
    _, h, w, _ = x.shape

    def grid(in_s, out_s):
        src = torch.arange(out_s, dtype=torch.float32, device=x.device) * (in_s / out_s)
        i0 = torch.floor(src).long()
        frac = src - i0.float()
        i1 = torch.clamp(i0 + 1, max=in_s - 1)
        return i0, i1, frac

    y0, y1, fy = grid(h, out_h)
    x0, x1, fx = grid(w, out_w)
    top, bot = x[:, y0], x[:, y1]
    rows = top + (bot - top) * fy[None, :, None, None]
    left, right = rows[:, :, x0], rows[:, :, x1]
    return left + (right - left) * fx[None, None, :, None]


def preprocess(x_uint8_range: torch.Tensor, variant: str = "torchvision") -> torch.Tensor:
    """(B, H, W, 3) in [0, 255] -> (B, 299, 299, 3) network inputs.

    tf2015: legacy bilinear resize, then (x - 128) / 128, as the frozen
    ``classify_image`` graph does. torchvision: x / 127.5 - 1, then
    half-pixel bilinear (``F.interpolate``, which for this upsample equals
    the JAX package's ``jax.image.resize``)."""
    x = x_uint8_range.float()
    if variant == "tf2015":
        return (_resize_bilinear_tf1(x, 299, 299) - 128.0) / 128.0
    x = x / 127.5 - 1.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                      align_corners=False)
    return x.permute(0, 2, 3, 1)


def _pm1_to_255(x_pm1: torch.Tensor) -> torch.Tensor:
    return 127.5 * (x_pm1.float() + 1.0)  # train.py:260-261


def _features(net: InceptionV3, x_uint8_range: torch.Tensor) -> torch.Tensor:
    return net.pool_features(preprocess(x_uint8_range, net.variant))


def _probs(net: InceptionV3, x_uint8_range: torch.Tensor) -> torch.Tensor:
    return torch.softmax(net.fc(_features(net, x_uint8_range)), dim=-1)


def host_chunks(images: np.ndarray, batch: int, device) -> Iterator[torch.Tensor]:
    """A host stack of uint8-range images as float32 chunks of ``batch`` on
    ``device`` (cast per chunk: a whole 50 000-image stack in float32 would
    be a ~600 MB transient)."""
    _check_batch(batch)
    for i in range(0, images.shape[0], batch):
        yield torch.from_numpy(np.asarray(images[i:i + batch], np.float32)).to(device)


def predict_probs(images: np.ndarray, net: Optional[InceptionV3] = None,
                  batch: Optional[int] = None, device=None) -> np.ndarray:
    """Classifier probabilities of a stack of uint8-range images."""
    net = net if net is not None else load_net(device=device)
    with scoring_mode():
        out = [_probs(net, x).cpu().numpy()
               for x in host_chunks(images, batch or default_batch(), _net_device(net))]
    return np.concatenate(out)


def _stream_chunks(sample_fn, num_samples: int, batch: int):
    """Yield ``(chunk, start)`` over generated batches: ``sample_fn(seed)``
    gives (B, H, W, 3) in [-1, 1] on the device for seeds 0, 1, ...; each
    is cut into chunks of at most ``batch`` rows, ``start`` the global
    index of a chunk's first row. Rows past ``num_samples`` are cut off, so
    every row yielded counts. The one streaming loop of the probability,
    split-KL, FID-feature and combined scorers."""
    _check_batch(batch)
    got, seed = 0, 0
    while got < num_samples:
        x = sample_fn(seed)
        seed += 1
        for i in range(0, min(int(x.shape[0]), num_samples - got), batch):
            yield x[i:min(i + batch, num_samples - got)], got + i
        got += int(x.shape[0])


def predict_probs_from_sampler(sample_fn, num_samples: int, net: Optional[InceptionV3] = None,
                               batch: Optional[int] = None, device=None) -> np.ndarray:
    """Probabilities of ``num_samples`` generated images; the images stay
    on the device, only the (n, classes) probabilities come to the host."""
    net = net if net is not None else load_net(device=device)
    with scoring_mode():
        probs = [_probs(net, _pm1_to_255(chunk)).cpu().numpy()
                 for chunk, _ in _stream_chunks(sample_fn, num_samples, batch or default_batch())]
    return np.concatenate(probs)


class SplitStats:
    """Per-split sufficient statistics of the Inception score on the device,
    float32: ``s1`` (splits, classes) sums of p, ``s2`` (splits,) sums of
    ``sum_j p_j log p_j``. Split i holds samples [i*n//splits,
    (i+1)*n//splits) (``utils/inception.py:48``)."""

    def __init__(self, num_samples: int, splits: int, n_classes: int, device):
        self.num_samples, self.splits = num_samples, splits
        self.upper = torch.tensor([num_samples * (i + 1) // splits for i in range(splits)],
                                  device=device)
        self.s1 = torch.zeros((splits, n_classes), device=device)
        self.s2 = torch.zeros((splits,), device=device)

    def update(self, p: torch.Tensor, start: int) -> None:
        gidx = start + torch.arange(p.shape[0], device=p.device)
        sid = torch.searchsorted(self.upper, gidx, right=True).clamp_(max=self.splits - 1)
        # a (splits, rows) one-hot matmul sums in a fixed order (an
        # index_add_ on the card would add with atomics, in any order)
        onehot = (sid[None, :] == torch.arange(self.splits, device=p.device)[:, None]).float()
        self.s1 += onehot @ p
        # x log x with its limit 0 at exact zeros (xlogy(0, 0) = 0)
        self.s2 += onehot @ torch.xlogy(p, p).sum(dim=-1)

    def finalize(self) -> Tuple[float, float]:
        return _finalize_split_scores(self.s1.cpu().numpy(), self.s2.cpu().numpy(),
                                      self.num_samples, self.splits)


def inception_score_from_sampler(sample_fn, num_samples: int, splits: int = 10,
                                 net: Optional[InceptionV3] = None, batch: Optional[int] = None,
                                 device_reduce: Optional[bool] = None,
                                 device=None) -> Tuple[float, float]:
    """Inception score of ``num_samples`` generated images, the reference's
    protocol and split-KL math. ``device_reduce`` (default on;
    ``OTGAN_EVAL_DEVICE_REDUCE=0`` turns it off) reduces to per-split
    statistics on the device; off, every probability goes to the host and
    the score is :func:`inception_score_from_preds` in float64."""
    if device_reduce is None:
        device_reduce = os.environ.get("OTGAN_EVAL_DEVICE_REDUCE", "1") == "1"
    net = net if net is not None else load_net(device=device)
    if not device_reduce:
        preds = predict_probs_from_sampler(sample_fn, num_samples, net=net, batch=batch)
        return inception_score_from_preds(preds, splits=splits)
    stats = SplitStats(num_samples, splits, net.num_classes, _net_device(net))
    with scoring_mode():
        for chunk, start in _stream_chunks(sample_fn, num_samples, batch or default_batch()):
            stats.update(_probs(net, _pm1_to_255(chunk)), start)
        return stats.finalize()


def _finalize_split_scores(s1, s2, num_samples: int, splits: int) -> Tuple[float, float]:
    """(mean, std) of the split scores from the sufficient statistics: a
    split's mean KL is ``(S2 - sum_j S1_j log(S1_j / n)) / n``, in float64."""
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    edges = [num_samples * i // splits for i in range(splits + 1)]
    counts = np.diff(edges).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(s1 > 0.0, s1 * np.log(s1 / counts[:, None]), 0.0)
    scores = np.exp((s2 - term.sum(axis=1)) / counts)
    return float(np.mean(scores)), float(np.std(scores))


def inception_score_from_preds(preds: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """The reference's split-KL math (``utils/inception.py:46-52``) in
    float64, with ``x log x -> 0`` at exact-zero probabilities."""
    preds = np.asarray(preds, np.float64)
    n = preds.shape[0]
    scores = []
    for i in range(splits):
        part = preds[i * n // splits:(i + 1) * n // splits]
        marginal = np.mean(part, axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            kl = np.where(part > 0.0, part * (np.log(part) - np.log(marginal)), 0.0)
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def get_inception_score(images, splits: int = 10, net: Optional[InceptionV3] = None,
                        batch: Optional[int] = None, device=None) -> Tuple[float, float]:
    """The reference's API: uint8-range RGB images (N, H, W, 3) -> (score
    mean, score std)."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"need (N, H, W, 3) images, got {images.shape}")
    if not (images.max() > 10.0 and images.min() >= 0.0):
        raise ValueError("images must be in [0, 255] range (reference utils/inception.py:28-29)")
    preds = predict_probs(images, net=net, batch=batch, device=device)
    return inception_score_from_preds(preds, splits=splits)
