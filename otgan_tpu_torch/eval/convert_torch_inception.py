"""Convert torchvision InceptionV3 weights to the classifiers' npz
(counterpart of ``otgan_tpu/eval/convert_torch_inception.py``; the npz is
the same file for both packages).

Usage (on a machine with the torchvision checkpoint available):

    python -m otgan_tpu_torch.eval.convert_torch_inception \
        --src /path/to/inception_v3_google-*.pth \
        --dst /tmp/imagenet/inception_v3_jax.npz

Mapping: torchvision module names -> this package's parameter tree
(``inception_net.param_spec``). Conv kernels transpose OIHW -> HWIO. The
resulting scores use torchvision's ImageNet training run; the reference's
frozen TF-2015 graph (``utils/inception.py:19``) is a different training run
of the same architecture, so absolute Inception scores differ by a small
constant factor — comparisons within a framework remain valid, and the
score *math* is identical (tested in tests/test_inception.py).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from otgan_tpu_torch.eval.inception_net import InceptionV3

# torchvision branch names -> our block-local names
_BRANCH_MAP = {
    "branch1x1": "b1x1",
    "branch5x5_1": "b5x5_1",
    "branch5x5_2": "b5x5_2",
    "branch3x3dbl_1": "b3x3dbl_1",
    "branch3x3dbl_2": "b3x3dbl_2",
    "branch3x3dbl_3": "b3x3dbl_3",
    "branch3x3dbl_3a": "b3x3dbl_3a",
    "branch3x3dbl_3b": "b3x3dbl_3b",
    "branch_pool": "bpool",
    "branch3x3": "b3x3",
    "branch3x3_1": "b3x3_1",
    "branch3x3_2": "b3x3_2",
    "branch3x3_2a": "b3x3_2a",
    "branch3x3_2b": "b3x3_2b",
    "branch7x7_1": "b7x7_1",
    "branch7x7_2": "b7x7_2",
    "branch7x7_3": "b7x7_3",
    "branch7x7dbl_1": "b7x7dbl_1",
    "branch7x7dbl_2": "b7x7dbl_2",
    "branch7x7dbl_3": "b7x7dbl_3",
    "branch7x7dbl_4": "b7x7dbl_4",
    "branch7x7dbl_5": "b7x7dbl_5",
    "branch7x7x3_1": "b7x7x3_1",
    "branch7x7x3_2": "b7x7x3_2",
    "branch7x7x3_3": "b7x7x3_3",
    "branch7x7x3_4": "b7x7x3_4",
}

_PART_MAP = {
    "conv.weight": "w",
    "bn.weight": "scale",
    "bn.bias": "bias",
    "bn.running_mean": "mean",
    "bn.running_var": "var",
}


def convert_state_dict(sd) -> dict:
    """torch state_dict (tensors or numpy) -> flat {path: ndarray} npz dict."""
    out = {}
    for name, tensor in sd.items():
        arr = np.asarray(
            tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor
        )
        if name.startswith("AuxLogits") or "num_batches_tracked" in name:
            continue
        if name == "fc.weight":
            out["fc/w"] = arr.T.astype(np.float32)  # (out,in) -> (in,out)
            continue
        if name == "fc.bias":
            out["fc/b"] = arr.astype(np.float32)
            continue
        parts = name.split(".")
        block = parts[0]  # e.g. Conv2d_1a_3x3 or Mixed_5b
        rest = ".".join(parts[1:])
        if block.startswith("Conv2d"):
            key = f"{block}/{_PART_MAP[rest]}"
        else:
            branch = parts[1]
            key = f"{block}/{_BRANCH_MAP[branch]}/{_PART_MAP['.'.join(parts[2:])]}"
        if key.endswith("/w"):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[key] = arr.astype(np.float32)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="torchvision .pth checkpoint")
    ap.add_argument("--dst", default="/tmp/imagenet/inception_v3_jax.npz")
    args = ap.parse_args(argv)

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    flat = convert_state_dict(sd)
    # every key of the spec, with its shape, and nothing else
    InceptionV3(num_classes=flat["fc/b"].shape[0]).load_flat(flat)
    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    np.savez(args.dst, **flat)
    print(f"wrote {len(flat)} arrays to {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
