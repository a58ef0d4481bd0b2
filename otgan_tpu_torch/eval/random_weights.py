"""Fixed-seed random classifier weights for scoring without the real ones
(counterpart of ``otgan_tpu/eval/random_weights.py``).

The real scores need converted weights (``convert_tf2015_inception.py``,
``convert_torch_inception.py``), which this repository does not hold. This
module makes a deterministic InceptionV3 weight set whose scores depend on
the inputs, so the whole eval chain (sampling -> resize -> trunk -> IS and
FID) runs end to end on any machine: ``init_params`` with its conv kernels
He-scaled (x sqrt(2), variance-preserving under ReLU) and its fc head x20.
Raw ``init_params`` washes the input out over the ~47 convs (IS = 1, FID =
0, what a broken chain gives too). For a seed the tree is bitwise the JAX
package's, so the golden pins of ``tests/test_eval_golden_pins.py`` hold
for both packages.

CLI::

    python -m otgan_tpu_torch.eval.random_weights --out rw.npz \\
        [--seed 2024] [--variant tf2015] [--num_classes 1008]

The npz is the converters' wire format (flat ``a/b/c`` keys and a
``__variant__`` marker), which either package's ``inception.load_params``
reads (``OTGAN_INCEPTION_WEIGHTS``).
"""

from __future__ import annotations

import argparse

import numpy as np

from otgan_tpu_torch.eval import inception_net

# BN statistics and biases stay at their init values; everything else scales
_PASSTHROUGH_KEYS = ("mean", "bias", "b", "var", "scale")


def scaled_params(seed: int = 2024, num_classes: int = 1008):
    """He-scaled fixed-seed random parameter tree (float32 numpy)."""

    def rec(tree, in_fc):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = rec(v, in_fc or k == "fc")
            elif k in _PASSTHROUGH_KEYS:
                out[k] = v
            else:
                out[k] = v * np.float32(20.0 if (in_fc or k == "fc") else np.sqrt(2.0))
        return out

    rng = np.random.default_rng(seed)
    return rec(inception_net.init_params(rng, num_classes=num_classes), False)


def save_npz(path: str, seed: int = 2024, variant: str = "tf2015",
             num_classes: int = 1008) -> str:
    """Write the weight set in the converters' npz wire format."""
    flat = inception_net.flatten_tree(scaled_params(seed=seed, num_classes=num_classes))
    flat["__variant__"] = np.frombuffer(variant.encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--variant", default="tf2015", choices=["tf2015", "torchvision"])
    ap.add_argument("--num_classes", type=int, default=1008)
    ns = ap.parse_args(argv)
    path = save_npz(ns.out, seed=ns.seed, variant=ns.variant, num_classes=ns.num_classes)
    print(f"wrote fixed-seed random weights (seed={ns.seed}, variant={ns.variant}) -> {path}")


if __name__ == "__main__":
    main()
