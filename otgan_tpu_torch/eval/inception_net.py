"""InceptionV3 classifier for the Inception score and FID (counterpart of
``otgan_tpu/eval/inception_net.py``).

The same network as the JAX package's, as an ``nn.Module`` in inference
form: conv stem, Inception A/B/C/D/E blocks, global average pool, linear
classifier. Each conv unit is conv (no bias) + inference BatchNorm + relu
with the JAX package's formula, ``x * inv + (bias - mean * inv)``, ``inv =
scale / sqrt(var + 1e-3)``. Module and buffer names follow the JAX
parameter tree (``Mixed_5b.b1x1.weight`` is ``Mixed_5b/b1x1/w``), so
:meth:`InceptionV3.load_tree` reads the tree of ``init_params`` and the flat
``"<scope>/<name>"`` npz of the converters (:meth:`InceptionV3.load_flat`).

Layouts: the forward takes NHWC images in [-1, 1] (as the JAX package's
``apply``) and runs NCHW inside; conv kernels are HWIO in the tree and OIHW
here; ``fc/w`` is (2048, classes) in the tree and (classes, 2048) here.

``variant="tf2015"`` is the frozen 2015 ``classify_image`` graph's pooling:
its 3x3 average pools exclude the padding from the divisor
(``count_include_pad=False``) and ``Mixed_7c``'s pool branch is a 3x3
max pool, padded with -inf. ``variant="torchvision"`` divides every window
by 9, as torchvision's ``avg_pool2d(3, 1, 1)`` does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NUM_CLASSES = 1000
BN_EPS = 1e-3
VARIANTS = ("torchvision", "tf2015")


# ---------------------------------------------------------------------------
# parameter-tree spec (shapes, HWIO) and random init, as the JAX package's
# ---------------------------------------------------------------------------


def _cb(cin, cout, kh, kw):
    return {"w": (kh, kw, cin, cout), "scale": (cout,), "bias": (cout,),
            "mean": (cout,), "var": (cout,)}


def _spec_a(cin, pool):
    return {
        "b1x1": _cb(cin, 64, 1, 1),
        "b5x5_1": _cb(cin, 48, 1, 1), "b5x5_2": _cb(48, 64, 5, 5),
        "b3x3dbl_1": _cb(cin, 64, 1, 1), "b3x3dbl_2": _cb(64, 96, 3, 3),
        "b3x3dbl_3": _cb(96, 96, 3, 3),
        "bpool": _cb(cin, pool, 1, 1),
    }


def _spec_b(cin):
    return {
        "b3x3": _cb(cin, 384, 3, 3),
        "b3x3dbl_1": _cb(cin, 64, 1, 1), "b3x3dbl_2": _cb(64, 96, 3, 3),
        "b3x3dbl_3": _cb(96, 96, 3, 3),
    }


def _spec_c(cin, c7):
    return {
        "b1x1": _cb(cin, 192, 1, 1),
        "b7x7_1": _cb(cin, c7, 1, 1), "b7x7_2": _cb(c7, c7, 1, 7),
        "b7x7_3": _cb(c7, 192, 7, 1),
        "b7x7dbl_1": _cb(cin, c7, 1, 1), "b7x7dbl_2": _cb(c7, c7, 7, 1),
        "b7x7dbl_3": _cb(c7, c7, 1, 7), "b7x7dbl_4": _cb(c7, c7, 7, 1),
        "b7x7dbl_5": _cb(c7, 192, 1, 7),
        "bpool": _cb(cin, 192, 1, 1),
    }


def _spec_d(cin):
    return {
        "b3x3_1": _cb(cin, 192, 1, 1), "b3x3_2": _cb(192, 320, 3, 3),
        "b7x7x3_1": _cb(cin, 192, 1, 1), "b7x7x3_2": _cb(192, 192, 1, 7),
        "b7x7x3_3": _cb(192, 192, 7, 1), "b7x7x3_4": _cb(192, 192, 3, 3),
    }


def _spec_e(cin):
    return {
        "b1x1": _cb(cin, 320, 1, 1),
        "b3x3_1": _cb(cin, 384, 1, 1), "b3x3_2a": _cb(384, 384, 1, 3),
        "b3x3_2b": _cb(384, 384, 3, 1),
        "b3x3dbl_1": _cb(cin, 448, 1, 1), "b3x3dbl_2": _cb(448, 384, 3, 3),
        "b3x3dbl_3a": _cb(384, 384, 1, 3), "b3x3dbl_3b": _cb(384, 384, 3, 1),
        "bpool": _cb(cin, 192, 1, 1),
    }


def param_spec(num_classes: int = NUM_CLASSES) -> Dict:
    return {
        "Conv2d_1a_3x3": _cb(3, 32, 3, 3),
        "Conv2d_2a_3x3": _cb(32, 32, 3, 3),
        "Conv2d_2b_3x3": _cb(32, 64, 3, 3),
        "Conv2d_3b_1x1": _cb(64, 80, 1, 1),
        "Conv2d_4a_3x3": _cb(80, 192, 3, 3),
        "Mixed_5b": _spec_a(192, 32),
        "Mixed_5c": _spec_a(256, 64),
        "Mixed_5d": _spec_a(288, 64),
        "Mixed_6a": _spec_b(288),
        "Mixed_6b": _spec_c(768, 128),
        "Mixed_6c": _spec_c(768, 160),
        "Mixed_6d": _spec_c(768, 160),
        "Mixed_6e": _spec_c(768, 192),
        "Mixed_7a": _spec_d(768),
        "Mixed_7b": _spec_e(1280),
        "Mixed_7c": _spec_e(2048),
        "fc": {"w": (2048, num_classes), "b": (num_classes,)},
    }


def init_params(rng: np.random.Generator, num_classes: int = NUM_CLASSES) -> Dict:
    """Random float32 numpy tree of the spec's shapes, drawn from ``rng`` in
    the JAX package's order (the spec's insertion order), so one seed gives
    both packages the same tree. BN statistics start at identity (mean 0,
    var 1); kernels are N(0, 1) / sqrt(fan_in)."""
    def build(spec):
        if all(isinstance(v, tuple) for v in spec.values()):
            out = {}
            for k, shape in spec.items():
                if k in ("mean", "bias", "b"):
                    out[k] = np.zeros(shape, np.float32)
                elif k in ("var", "scale"):
                    out[k] = np.ones(shape, np.float32)
                else:
                    fan_in = int(np.prod(shape[:-1]))
                    out[k] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
            return out
        return {k: build(v) for k, v in spec.items()}

    return build(param_spec(num_classes))


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested tree -> flat ``{"<scope>/<name>": array}`` (the npz wire format)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_tree(v, prefix=f"{key}/"))
        else:
            flat[key] = np.asarray(v)
    return flat


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class ConvBN(nn.Module):
    """conv (no bias) + inference BatchNorm + relu (BasicConv2d). ``same``:
    the JAX package's "SAME" padding at stride 1 (odd kernels: (k - 1) / 2
    on each side); otherwise "VALID"."""

    def __init__(self, shape, stride: int = 1, same: bool = True):
        super().__init__()
        kh, kw, cin, cout = shape
        # torch.empty: the weights always come from a tree, so nothing is
        # drawn from torch's global generator here
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw), requires_grad=False)
        for name in ("scale", "bias", "mean", "var"):
            self.register_buffer(name, torch.empty(cout))
        self.stride = stride
        self.padding = (kh // 2, kw // 2) if same else (0, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        inv = self.scale / torch.sqrt(self.var + BN_EPS)
        shift = self.bias - self.mean * inv
        return F.relu(x * inv[:, None, None] + shift[:, None, None])


class _Block(nn.ModuleDict):
    """An Inception block: its conv units by their tree names; those named
    in ``valid_s2`` are stride-2 VALID convs."""

    def __init__(self, spec: Dict, valid_s2=()):
        super().__init__({
            k: ConvBN(s["w"], stride=2 if k in valid_s2 else 1, same=k not in valid_s2)
            for k, s in spec.items()
        })


def _maxpool(x, size=3, stride=2, same=False):
    return F.max_pool2d(x, size, stride, padding=size // 2 if same else 0)


def _avgpool3(x, exclude_pad: bool = False):
    # torchvision's avg_pool2d(3, 1, 1) divides by 9 at the borders too;
    # the TF-2015 graph divides by the in-bounds count (variant tf2015)
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not exclude_pad)


class InceptionA(_Block):
    def __init__(self, cin, pool):
        super().__init__(_spec_a(cin, pool))

    def forward(self, x, exclude_pad=False):
        b1 = self["b1x1"](x)
        b5 = self["b5x5_2"](self["b5x5_1"](x))
        b3 = self["b3x3dbl_3"](self["b3x3dbl_2"](self["b3x3dbl_1"](x)))
        bp = self["bpool"](_avgpool3(x, exclude_pad))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    def __init__(self, cin):
        super().__init__(_spec_b(cin), valid_s2=("b3x3", "b3x3dbl_3"))

    def forward(self, x, exclude_pad=False):
        b3 = self["b3x3"](x)
        bd = self["b3x3dbl_3"](self["b3x3dbl_2"](self["b3x3dbl_1"](x)))
        return torch.cat([b3, bd, _maxpool(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin, c7):
        super().__init__(_spec_c(cin, c7))

    def forward(self, x, exclude_pad=False):
        b1 = self["b1x1"](x)
        b7 = self["b7x7_3"](self["b7x7_2"](self["b7x7_1"](x)))
        bd = x
        for k in ("b7x7dbl_1", "b7x7dbl_2", "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5"):
            bd = self[k](bd)
        bp = self["bpool"](_avgpool3(x, exclude_pad))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    def __init__(self, cin):
        super().__init__(_spec_d(cin), valid_s2=("b3x3_2", "b7x7x3_4"))

    def forward(self, x, exclude_pad=False):
        b3 = self["b3x3_2"](self["b3x3_1"](x))
        b7 = x
        for k in ("b7x7x3_1", "b7x7x3_2", "b7x7x3_3", "b7x7x3_4"):
            b7 = self[k](b7)
        return torch.cat([b3, b7, _maxpool(x)], dim=1)


class InceptionE(_Block):
    def __init__(self, cin, pool_max=False):
        super().__init__(_spec_e(cin))
        self.pool_max = pool_max  # TF-2015: Mixed_7c's pool branch is a max pool

    def forward(self, x, exclude_pad=False):
        b1 = self["b1x1"](x)
        b3 = self["b3x3_1"](x)
        b3 = torch.cat([self["b3x3_2a"](b3), self["b3x3_2b"](b3)], dim=1)
        bd = self["b3x3dbl_2"](self["b3x3dbl_1"](x))
        bd = torch.cat([self["b3x3dbl_3a"](bd), self["b3x3dbl_3b"](bd)], dim=1)
        pooled = _maxpool(x, 3, 1, same=True) if self.pool_max else _avgpool3(x, exclude_pad)
        return torch.cat([b1, b3, bd, self["bpool"](pooled)], dim=1)


class Linear(nn.Module):
    """The classifier head: ``weight`` (classes, 2048), as ``nn.Linear``'s."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout), requires_grad=False)

    def forward(self, f):
        return F.linear(f, self.weight, self.bias)


class InceptionV3(nn.Module):
    """The InceptionV3 trunk and classifier; ``forward`` gives logits,
    :meth:`pool_features` the 2048-d pool features (the FID trunk)."""

    def __init__(self, num_classes: int = NUM_CLASSES, variant: str = "torchvision"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        spec = param_spec(num_classes)
        self.Conv2d_1a_3x3 = ConvBN(spec["Conv2d_1a_3x3"]["w"], stride=2, same=False)
        self.Conv2d_2a_3x3 = ConvBN(spec["Conv2d_2a_3x3"]["w"], same=False)
        self.Conv2d_2b_3x3 = ConvBN(spec["Conv2d_2b_3x3"]["w"])
        self.Conv2d_3b_1x1 = ConvBN(spec["Conv2d_3b_1x1"]["w"], same=False)
        self.Conv2d_4a_3x3 = ConvBN(spec["Conv2d_4a_3x3"]["w"], same=False)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_max=variant == "tf2015")
        self.fc = Linear(2048, num_classes)

    @classmethod
    def from_params(cls, tree: Dict, variant: str = "torchvision", device=None) -> "InceptionV3":
        """The network holding the JAX-layout tree ``tree``, on ``device``."""
        net = cls(int(np.shape(tree["fc"]["b"])[0]), variant)
        net.load_tree(tree)
        return net.to(device) if device is not None else net

    @torch.no_grad()
    def load_flat(self, flat: Dict[str, np.ndarray]) -> None:
        """Copy a flat ``"<scope>/<name>"`` dict (HWIO kernels, ``fc/w``
        (2048, classes)) in; every key of the spec must be there with its
        shape, and nothing else but ``__``-prefixed markers."""
        spec = flatten_tree(param_spec(self.num_classes))
        tensors = {**dict(self.named_parameters()), **dict(self.named_buffers())}
        extra = sorted(k for k in flat if k not in spec and not k.startswith("__"))
        if extra:
            raise ValueError(f"weights have keys the network lacks: {extra[:5]}")
        for key, shape in spec.items():
            if key not in flat:
                raise ValueError(f"weights have no {key}")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"weight {key}: expected {tuple(shape)}, got {arr.shape}")
            t = torch.from_numpy(np.array(arr, np.float32))
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
            elif t.dim() == 2:
                t = t.T  # (2048, classes) -> (classes, 2048)
            *scope, leaf = key.split("/")
            dst = tensors[".".join([*scope, {"w": "weight", "b": "bias"}.get(leaf, leaf)])]
            dst.copy_(t.to(dst.dtype))

    def load_tree(self, tree: Dict) -> None:
        self.load_flat(flatten_tree(tree))

    def pool_features(self, x: torch.Tensor) -> torch.Tensor:
        """Images (N, 299, 299, 3) NHWC in [-1, 1] -> (N, 2048) features."""
        ep = self.variant == "tf2015"
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _maxpool(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _maxpool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x, ep)
        return x.mean(dim=(2, 3))  # global average pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images (N, 299, 299, 3) NHWC in [-1, 1] -> logits (N, classes)."""
        return self.fc(self.pool_features(x))
