"""Convert the frozen TF-2015 ``classify_image_graph_def.pb`` weights to the
InceptionV3 parameter tree — the reference's exact evaluation network
(counterpart of ``otgan_tpu/eval/convert_tf2015_inception.py``; the npz it
writes is the same file for both packages).

The reference scores samples with the 2015-12-05 frozen Inception graph
(``utils/inception.py:55-96``; download at ``:19,60-70``:
``http://download.tensorflow.org/models/image/imagenet/inception-2015-12-05.tgz``,
member ``classify_image_graph_def.pb``). Absolute Inception-score parity
(the paper's 8.47) requires THOSE weights — a torchvision InceptionV3 is a
different training run. This converter reads the .pb with the dependency-free
protobuf parser (``graphdef.py``) and emits the ``.npz`` layout consumed by
``otgan_tpu_torch.eval.inception.load_params`` (and the JAX package's).

Usage (one command once the file is present):

    python -m otgan_tpu_torch.eval.convert_tf2015_inception \
        --pb /path/to/classify_image_graph_def.pb \
        --out /tmp/imagenet/inception_v3_jax.npz

Checksum protocol: the converter always prints the sha256 of the .pb it
reads, so every conversion is auditable. This environment has no network
egress, so the canonical digest cannot be recorded here; on the first
verified download (compare against TF's published tutorial artifacts),
pin it with ``--expect_sha256 <digest>`` and commit that value — later
conversions then refuse tampered files.

Graph name mapping (2015 scopes -> torchvision-style spec keys used by
``inception_net.param_spec``): stem ``conv..conv_4``; A blocks
``mixed{,_1,_2}``; B ``mixed_3``; C ``mixed_4..7``; D ``mixed_8``;
E ``mixed_9,_10``; head ``softmax/weights|biases`` (2048 x 1008). Each conv
unit stores its kernel as ``<scope>/conv2d_params`` (HWIO — our layout
directly) and batch norm as ``<scope>/batchnorm/{beta,gamma,moving_mean,
moving_variance}`` with ``scale_after_normalization=false`` (gamma unused,
scale == 1).

The 2015 network is NOT byte-identical in topology to torchvision's: its
avg-pools exclude padding from the divisor and ``mixed_10``'s pool branch
is a MAX pool. ``inception_net`` exposes this as ``variant="tf2015"``; the
emitted npz carries a ``__variant__`` marker so ``load_params`` selects it
automatically (including the (x-128)/128 input scaling and legacy
non-half-pixel bilinear resize the frozen graph applies).
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Dict

import numpy as np

from otgan_tpu_torch.eval import inception_net
from otgan_tpu_torch.eval.graphdef import extract_constants

TF2015_NUM_CLASSES = 1008

# spec key -> 2015 scope, per inception block type (see module docstring)
_A = {
    "b1x1": "conv",
    "b5x5_1": "tower/conv", "b5x5_2": "tower/conv_1",
    "b3x3dbl_1": "tower_1/conv", "b3x3dbl_2": "tower_1/conv_1",
    "b3x3dbl_3": "tower_1/conv_2",
    "bpool": "tower_2/conv",
}
_B = {
    "b3x3": "conv",
    "b3x3dbl_1": "tower/conv", "b3x3dbl_2": "tower/conv_1",
    "b3x3dbl_3": "tower/conv_2",
}
_C = {
    "b1x1": "conv",
    "b7x7_1": "tower/conv", "b7x7_2": "tower/conv_1", "b7x7_3": "tower/conv_2",
    "b7x7dbl_1": "tower_1/conv", "b7x7dbl_2": "tower_1/conv_1",
    "b7x7dbl_3": "tower_1/conv_2", "b7x7dbl_4": "tower_1/conv_3",
    "b7x7dbl_5": "tower_1/conv_4",
    "bpool": "tower_2/conv",
}
_D = {
    "b3x3_1": "tower/conv", "b3x3_2": "tower/conv_1",
    "b7x7x3_1": "tower_1/conv", "b7x7x3_2": "tower_1/conv_1",
    "b7x7x3_3": "tower_1/conv_2", "b7x7x3_4": "tower_1/conv_3",
}
_E = {
    "b1x1": "conv",
    "b3x3_1": "tower/conv",
    "b3x3_2a": "tower/mixed/conv", "b3x3_2b": "tower/mixed/conv_1",
    "b3x3dbl_1": "tower_1/conv", "b3x3dbl_2": "tower_1/conv_1",
    "b3x3dbl_3a": "tower_1/mixed/conv", "b3x3dbl_3b": "tower_1/mixed/conv_1",
    "bpool": "tower_2/conv",
}

BLOCK_SCOPES = {
    "Conv2d_1a_3x3": "conv",
    "Conv2d_2a_3x3": "conv_1",
    "Conv2d_2b_3x3": "conv_2",
    "Conv2d_3b_1x1": "conv_3",
    "Conv2d_4a_3x3": "conv_4",
    "Mixed_5b": ("mixed", _A),
    "Mixed_5c": ("mixed_1", _A),
    "Mixed_5d": ("mixed_2", _A),
    "Mixed_6a": ("mixed_3", _B),
    "Mixed_6b": ("mixed_4", _C),
    "Mixed_6c": ("mixed_5", _C),
    "Mixed_6d": ("mixed_6", _C),
    "Mixed_6e": ("mixed_7", _C),
    "Mixed_7a": ("mixed_8", _D),
    "Mixed_7b": ("mixed_9", _E),
    "Mixed_7c": ("mixed_10", _E),
}


def _conv_unit(consts: Dict[str, np.ndarray], scope: str, want_shape):
    """One conv+BN unit from graph constants. scale == 1 everywhere because
    the frozen graph runs BatchNormWithGlobalNormalization with
    scale_after_normalization=false (gamma present but dead)."""
    try:
        w = consts[f"{scope}/conv2d_params"]
        beta = consts[f"{scope}/batchnorm/beta"]
        mean = consts[f"{scope}/batchnorm/moving_mean"]
        var = consts[f"{scope}/batchnorm/moving_variance"]
    except KeyError as e:
        near = sorted(k for k in consts if k.startswith(scope))[:8]
        raise KeyError(
            f"missing constant {e.args[0]!r}; nodes under {scope!r}: {near}"
        ) from None
    if tuple(w.shape) != tuple(want_shape):
        raise ValueError(
            f"{scope}/conv2d_params: expected {tuple(want_shape)}, "
            f"got {tuple(w.shape)}"
        )
    cout = w.shape[-1]
    return {
        "w": w.astype(np.float32),
        "scale": np.ones((cout,), np.float32),
        "bias": beta.astype(np.float32),
        "mean": mean.astype(np.float32),
        "var": var.astype(np.float32),
    }


def map_tf2015_weights(consts: Dict[str, np.ndarray]) -> Dict:
    """Graph constants -> nested param tree matching
    ``inception_net.param_spec(num_classes=1008)``."""
    spec = inception_net.param_spec(num_classes=TF2015_NUM_CLASSES)
    params: Dict = {}
    for key, scope in BLOCK_SCOPES.items():
        if isinstance(scope, str):  # stem conv unit
            params[key] = _conv_unit(consts, scope, spec[key]["w"])
        else:
            prefix, table = scope
            params[key] = {
                sub: _conv_unit(
                    consts, f"{prefix}/{table[sub]}", spec[key][sub]["w"]
                )
                for sub in spec[key]
            }
    w = consts["softmax/weights"].astype(np.float32)
    b = consts["softmax/biases"].astype(np.float32)
    if w.shape != (2048, TF2015_NUM_CLASSES):
        raise ValueError(f"softmax/weights: got {w.shape}")
    params["fc"] = {"w": w, "b": b}
    return params


def convert(pb_path: str, out_path: str, expect_sha256: str = "") -> str:
    with open(pb_path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    print(f"sha256({pb_path}) = {digest}")
    if expect_sha256 and digest != expect_sha256:
        raise ValueError(
            f"GraphDef digest mismatch: expected {expect_sha256}, got {digest}"
        )
    consts = extract_constants(raw)
    print(f"parsed {len(consts)} Const nodes")
    params = map_tf2015_weights(consts)
    flat = inception_net.flatten_tree(params)
    # variant marker: selects tf2015 pooling/preprocessing at load time
    flat["__variant__"] = np.frombuffer(b"tf2015", dtype=np.uint8).copy()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **flat)
    print(f"wrote {out_path} ({len(flat)} arrays)")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pb", required=True, help="classify_image_graph_def.pb")
    ap.add_argument("--out", default="/tmp/imagenet/inception_v3_jax.npz")
    ap.add_argument(
        "--expect_sha256",
        default="",
        help="pin the GraphDef digest (printed on every run for auditing)",
    )
    args = ap.parse_args(argv)
    return convert(args.pb, args.out, args.expect_sha256)


if __name__ == "__main__":
    main()
