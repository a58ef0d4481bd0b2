"""Frechet Inception Distance (counterpart of ``otgan_tpu/eval/fid.py``).

FID = ||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2)) over the 2048-d
InceptionV3 pool features of real and generated images. The square root's
trace is tr(sqrt(S1^1/2 S2 S1^1/2)), from two eigendecompositions in numpy
float64 (no scipy). The features come from the same float32 forward as the
Inception score (``inception.py``); the streamed scorers keep the
sufficient statistics (sum f, sum f^T f, in float32) on the device and
read back one 2048 x 2048 matrix, and :func:`combined_eval_from_sampler`
gives the Inception score and the FID statistics from one pass.

Reference statistics files (:func:`save_reference_statistics`) are the JAX
package's: ``mu``, ``sigma``, the weight ``variant`` and the image
``count``, so a file written by either package loads in the other. Make one
offline with ``python -m otgan_tpu_torch.eval.fid`` (:func:`main`).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from otgan_tpu_torch.eval import inception as _inception
from otgan_tpu_torch.eval.inception import (
    SplitStats,
    _features,
    _net_device,
    _pm1_to_255,
    _stream_chunks,
    default_batch,
    host_chunks,
    load_net,
    scoring_mode,
)
from otgan_tpu_torch.eval.inception_net import InceptionV3


def pool_features(images: np.ndarray, net: Optional[InceptionV3] = None,
                  batch: Optional[int] = None, device=None) -> np.ndarray:
    """2048-d pool features (float32) of a stack of uint8-range images."""
    net = net if net is not None else load_net(device=device)
    with scoring_mode():
        out = [_features(net, x).cpu().numpy()
               for x in host_chunks(images, batch or default_batch(), _net_device(net))]
    return np.concatenate(out)


def _sqrtm_psd_trace_product(s1: np.ndarray, s2: np.ndarray) -> float:
    """tr(sqrt(S1 S2)) for symmetric PSD S1, S2 without scipy."""
    w1, v1 = np.linalg.eigh(s1)
    w1 = np.clip(w1, 0.0, None)
    s1h = (v1 * np.sqrt(w1)) @ v1.T  # S1^(1/2)
    m = s1h @ s2 @ s1h  # symmetric PSD, similar to S1 S2
    wm = np.clip(np.linalg.eigvalsh(m), 0.0, None)
    return float(np.sum(np.sqrt(wm)))


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    diff = mu1 - mu2
    tr_cov = _sqrtm_psd_trace_product(sigma1, sigma2)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_cov)


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def get_fid(images_a: np.ndarray, images_b: np.ndarray, net: Optional[InceptionV3] = None,
            batch: Optional[int] = None, device=None) -> float:
    """FID between two stacks of uint8-range RGB images."""
    net = net if net is not None else load_net(device=device)
    fa = pool_features(images_a, net=net, batch=batch)
    fb = pool_features(images_b, net=net, batch=batch)
    return frechet_distance(*feature_statistics(fa), *feature_statistics(fb))


class FeatureStats:
    """Feature sufficient statistics on the device, float32: ``f1`` (d,)
    = sum f, ``f2`` (d, d) = sum f^T f, and the row count."""

    def __init__(self, d: int, device):
        self.f1 = torch.zeros((d,), device=device)
        self.f2 = torch.zeros((d, d), device=device)
        self.n = 0

    def update(self, f: torch.Tensor) -> None:
        self.f1 += f.sum(dim=0)
        self.f2 += f.T @ f
        self.n += int(f.shape[0])

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma) in float64, sigma with np.cov's N - 1."""
        f1 = self.f1.cpu().numpy().astype(np.float64)
        f2 = self.f2.cpu().numpy().astype(np.float64)
        mu = f1 / self.n
        return mu, (f2 - self.n * np.outer(mu, mu)) / (self.n - 1.0)


def feature_statistics_from_sampler(sample_fn, num_samples: int,
                                    net: Optional[InceptionV3] = None,
                                    batch: Optional[int] = None,
                                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of the pool features of ``num_samples`` generated images
    (``sample_fn(seed)``: (B, H, W, 3) in [-1, 1] on the device), reduced on
    the device; agrees with :func:`feature_statistics` of the host path to
    ~1e-4 relative."""
    net = net if net is not None else load_net(device=device)
    stats = FeatureStats(net.fc.weight.shape[1], _net_device(net))
    with scoring_mode():
        for chunk, _ in _stream_chunks(sample_fn, num_samples, batch or default_batch()):
            stats.update(_features(net, _pm1_to_255(chunk)))
        return stats.finalize()


def combined_eval_from_sampler(
    sample_fn, num_samples: int, splits: int = 10, net: Optional[InceptionV3] = None,
    batch: Optional[int] = None, device=None,
) -> Tuple[Tuple[float, float], Tuple[np.ndarray, np.ndarray]]:
    """The Inception score and the FID feature statistics from ONE pass
    over the generated images: ``((is_mean, is_std), (mu, sigma))``. The
    pool features feed the FID statistics and, through the fc head, the
    split-KL statistics; the trunk runs once instead of twice."""
    net = net if net is not None else load_net(device=device)
    dev = _net_device(net)
    split_stats = SplitStats(num_samples, splits, net.num_classes, dev)
    feat_stats = FeatureStats(net.fc.weight.shape[1], dev)
    with scoring_mode():
        for chunk, start in _stream_chunks(sample_fn, num_samples, batch or default_batch()):
            f = _features(net, _pm1_to_255(chunk))
            split_stats.update(torch.softmax(net.fc(f), dim=-1), start)
            feat_stats.update(f)
        return split_stats.finalize(), feat_stats.finalize()


def fid_from_sampler(sample_fn, num_samples: int, mu_ref: np.ndarray, sigma_ref: np.ndarray,
                     net: Optional[InceptionV3] = None, batch: Optional[int] = None,
                     device=None) -> float:
    """FID of generated images against precomputed reference statistics."""
    mu, sigma = feature_statistics_from_sampler(sample_fn, num_samples, net=net, batch=batch,
                                                device=device)
    return frechet_distance(mu, sigma, mu_ref, sigma_ref)


def reference_statistics(images_255: np.ndarray, net: Optional[InceptionV3] = None,
                         batch: Optional[int] = None,
                         device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a stack of REAL uint8-range images: the fixed side of
    the FID comparison, computed once per dataset."""
    return feature_statistics(pool_features(images_255, net=net, batch=batch, device=device))


def save_reference_statistics(path: str, mu: np.ndarray, sigma: np.ndarray, variant: str,
                              count: int) -> None:
    """Write dataset statistics with the weight variant they were computed
    under (mixing variants silently breaks the comparison). Atomic: written
    to a temporary name, then renamed, so a reader never sees half a file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    np.savez_compressed(tmp, mu=mu, sigma=sigma,
                        variant=np.frombuffer(variant.encode("utf-8"), np.uint8),
                        count=np.int64(count))
    # savez appends .npz when missing; the pid suffix has no extension
    os.replace(tmp if os.path.exists(tmp) else f"{tmp}.npz", path)


def load_reference_statistics(path: str, expect_variant: Optional[str] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as data:
        variant = bytes(data["variant"]).decode("utf-8")
        if expect_variant is not None and variant != expect_variant:
            raise ValueError(
                f"FID reference statistics at {path} were computed with variant "
                f"'{variant}' but the loaded weights are '{expect_variant}' — "
                "recompute them (delete the file)"
            )
        return data["mu"], data["sigma"]


def _load_images(args) -> np.ndarray:
    """The CLI's image stack, NHWC in [0, 255]."""
    if args.synthetic_data:
        from otgan_tpu_torch.data.cifar10 import synthetic

        # the trainer's --synthetic_data set for the same --seed and size
        return synthetic(np.random.default_rng(args.seed), args.synthetic_size)
    if args.images:
        arr = np.load(args.images)
        if hasattr(arr, "files"):  # npz: the first array
            arr = arr[arr.files[0]]
        imgs = np.asarray(arr)
    else:
        from otgan_tpu_torch.data.cifar10 import load

        # the trainer's DataLoader layout: <data_dir>/cifar-10-python/...
        x, _ = load(os.path.join(args.data_dir, "cifar-10-python"), subset=args.subset)
        imgs = np.transpose(x, (0, 2, 3, 1))
    if imgs.ndim != 4:
        raise ValueError(f"expected NHWC/NCHW images, got shape {imgs.shape}")
    if imgs.shape[1] == 3 and imgs.shape[-1] != 3:  # NCHW -> NHWC
        imgs = np.transpose(imgs, (0, 2, 3, 1))
    if float(imgs.max()) <= 2.0:
        # a [0, 1] or [-1, 1] stack would give finite, meaningless
        # statistics to every later --fid_stats_path run
        raise ValueError(
            f"--images values span [{imgs.min():.3f}, {imgs.max():.3f}] — expected "
            "uint8-range [0, 255]; rescale normalized stacks (e.g. x*255 or "
            "(x+1)*127.5) before computing statistics"
        )
    return imgs


def main(argv=None) -> str:
    """Precompute dataset FID reference statistics offline:

        python -m otgan_tpu_torch.eval.fid --data_dir /data --out fid_stats.npz

    The .npz feeds ``--fid_stats_path`` of the trainer and of ``evaluate``.
    Images: the CIFAR-10 pickles (``--data_dir``), an image stack
    (``--images`` .npy/.npz, NHWC or NCHW, uint8 or [0, 255] float), or the
    trainer's ``--synthetic_data`` set (``--synthetic_size``, ``--seed``).
    The classifier batch is ``OTGAN_INCEPTION_BATCH``'s (default 100)."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data_dir", default="", help="CIFAR-10 directory")
    ap.add_argument("--subset", default="train", choices=("train", "test"))
    ap.add_argument("--images", default="", help=".npy/.npz image stack instead of --data_dir")
    ap.add_argument("--synthetic_data", action="store_true",
                    help="the trainer's CIFAR-shaped random set for --seed")
    ap.add_argument("--synthetic_size", type=int, default=5120)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--limit", type=int, default=0, help="use only the first N images")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    if sum(map(bool, (args.data_dir, args.images, args.synthetic_data))) != 1:
        ap.error("pass exactly one of --data_dir / --images / --synthetic_data")
    imgs = _load_images(args)
    if args.limit:
        imgs = imgs[:args.limit]
    net = _inception.load_net(device=args.device)
    print(f"computing FID statistics over {imgs.shape[0]} images ({net.variant})")
    mu, sigma = reference_statistics(imgs, net=net)
    save_reference_statistics(args.out, mu, sigma, net.variant, imgs.shape[0])
    print(f"wrote {args.out} (mu {mu.shape}, sigma {sigma.shape})")
    return args.out


if __name__ == "__main__":
    main()
