"""The DCGAN of OT-GAN in plain PyTorch (openai/ot-gan ``models/dcgan.py``,
arXiv:1803.05573), as a function of a dict of parameters.

Critic: four 5x5 weight-normalised convs (3 -> 128, then stride 2 to 256,
512, 1024, each after a CReLU), a CReLU, an NHWC flatten and a row L2
normalisation: unit features of 4*4*2048 = 32768. Generator: ``u ~ U(-1,
1)^100`` -> dense to 2*4*4*1024 with a GLU gate -> three (nearest 2x
upsample, 5x5 conv, GLU) stages to 32x32 -> a 5x5 conv to 3 channels
(init scale 0.1) -> tanh. Weight norm ``W = g V / ||V||`` with the
data-dependent init of the reference (``utils/nn.py:108-162``): ``g = s /
std(pre)``, ``b = -mean(pre g)`` on a real batch; V drawn ``0.05 N(0, 1)``
on the CPU from the seed, critic layers first.

Precision is the configuration's: each conv and dense layer takes its
input and weight in ``compute`` (bf16 in both DCGAN configurations) and
accumulates in float32, its result returned in ``compute`` and upcast;
weight norm, GLU, tanh, the head and everything after run in float32.
The source script ran float32 throughout; bf16 is the configuration's
change (``compute_dtype`` in its ``reduced``). The casts sit where the
port puts them, each marked "cast (port)" below, because a float32
reference differs from the bf16 program by more than the control does
(``portbench/tests/test_portbench_reference.py`` bounds that difference
by bf16's rounding). Activations are NHWC; a
conv reads them as a channels-last NCHW view. Padding is SAME (an odd
total pads one more at the high end).

A model family of the plain reference (``reference/train.py`` names the
interface): the configuration's ``model`` is ``dcgan``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LATENT = 100

# (name, V shape, stride, pre-activation, upsample, init scale); the order
# of the draws
DISC = (
    ("conv2d_0", (128, 3, 5, 5), 1, None, False, 1.0),
    ("conv2d_1", (256, 256, 5, 5), 2, "crelu", False, 1.0),
    ("conv2d_2", (512, 512, 5, 5), 2, "crelu", False, 1.0),
    ("conv2d_3", (1024, 1024, 5, 5), 2, "crelu", False, 1.0),
)
GEN = (
    ("dense_0", (2 * 4 * 4 * 1024, LATENT), 1, None, False, 1.0),
    ("conv2d_0", (1024, 1024, 5, 5), 1, None, True, 1.0),
    ("conv2d_1", (512, 512, 5, 5), 1, None, True, 1.0),
    ("conv2d_2", (256, 256, 5, 5), 1, None, True, 1.0),
    ("conv2d_3", (3, 128, 5, 5), 1, None, False, 0.1),
)


def leaf_names(layers) -> List[str]:
    return [f"{name}.{p}" for name, *_ in layers for p in ("V", "g", "b")]


def draw(seed: int) -> Tuple[Params, Params, torch.Generator]:
    """V of the critic, then of the generator, from a CPU generator seeded
    ``seed``; g = 1, b = 0. The generator is returned for the init latents."""
    rng = torch.Generator().manual_seed(seed)
    nets = []
    for layers in (DISC, GEN):
        params = {}
        for name, shape, *_ in layers:
            params[f"{name}.V"] = 0.05 * torch.randn(shape, generator=rng)
            params[f"{name}.g"] = torch.ones(shape[0])
            params[f"{name}.b"] = torch.zeros(shape[0])
        nets.append(params)
    return nets[0], nets[1], rng


def init_latent(n: int, cpu_rng: torch.Generator) -> torch.Tensor:
    """The data-dependent init's ``U(-1, 1)^100`` latents, drawn on the CPU
    generator that :func:`draw` returns, after the parameters."""
    return torch.rand((n, LATENT), generator=cpu_rng) * 2.0 - 1.0


def latent(batch: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """One step's ``U(-1, 1)^100`` latents, drawn on ``generator``."""
    return torch.rand((batch, LATENT), generator=generator, device=device) * 2.0 - 1.0


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def upsample(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def glu(x: torch.Tensor, dim: int) -> torch.Tensor:
    h, gate = torch.chunk(x, 2, dim=dim)
    return h * torch.sigmoid(gate)


def _layer_input(x: torch.Tensor, pre, up: bool, compute: torch.dtype) -> torch.Tensor:
    # cast (port): the layer input, before the pre-activation and the
    # upsample (``nn/layers.py``, ``CAST_FIRST``); rounding commutes with
    # none, relu, crelu and the nearest upsample, so the place is immaterial
    x = x.to(compute)
    if up:
        x = upsample(x)
    if pre == "crelu":
        x = F.relu(torch.cat([x, -x], dim=-1))
    return x


def _apply(x: torch.Tensor, w: torch.Tensor, stride: int, compute: torch.dtype) -> torch.Tensor:
    # cast (port): input and weight-normed weight to ``compute``, the
    # product's result (``compute``) upcast to float32 (``nn/layers.py``'s
    # ``Dense`` and ``Conv2d``)
    if w.dim() == 2:
        return F.linear(x.to(compute), w.to(compute)).float()
    _, h, wd, _ = x.shape
    ph = same_padding(h, w.shape[2], stride)
    pw = same_padding(wd, w.shape[3], stride)
    x = x.to(compute)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(compute), stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1).float()


def _direction(v: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, v.dim()))
    return v / torch.sqrt(torch.sum(v.square(), dim=dims, keepdim=True))


def layer(params: Params, spec, x: torch.Tensor, compute: torch.dtype,
          init: bool = False) -> torch.Tensor:
    """One weight-normalised layer; ``init`` runs its data-dependent init
    on ``x`` (setting g and b in ``params``) and returns the init output."""
    name, shape, stride, pre, up, scale = spec
    xin = _layer_input(x, pre, up, compute)
    v, g, b = (params[f"{name}.{p}"] for p in ("V", "g", "b"))
    if init:
        with torch.no_grad():
            pre_act = _apply(xin, _direction(v), stride, compute)
            dims = tuple(range(pre_act.dim() - 1))
            g_new = scale / (torch.std(pre_act, dim=dims, correction=0) + 1e-10)
            out = pre_act * g_new
            b_new = -torch.mean(out, dim=dims)
            g.copy_(g_new)
            b.copy_(b_new)
            return out + b_new
    w = _direction(v) * g.reshape((-1,) + (1,) * (v.dim() - 1))
    return _apply(xin, w, stride, compute) + b


def critic(params: Params, x: torch.Tensor, compute: torch.dtype, init: bool = False):
    """NHWC images in [-1, 1] -> unit features (B, 32768)."""
    for spec in DISC:
        x = layer(params, spec, x, compute, init)
    x = F.relu(torch.cat([x, -x], dim=-1))
    x = x.reshape(x.shape[0], -1)
    return x / torch.sqrt(torch.sum(x.square(), dim=-1, keepdim=True))


def generator(params: Params, u: torch.Tensor, compute: torch.dtype, init: bool = False):
    """Latents (B, 100) -> NHWC images (B, 32, 32, 3) in [-1, 1]."""
    x = glu(layer(params, GEN[0], u, compute, init), 1).reshape(u.shape[0], 4, 4, 1024)
    for spec in GEN[1:4]:
        x = glu(layer(params, spec, x, compute, init), -1)
    return torch.tanh(layer(params, GEN[4], x, compute, init))


def images(x_uint8: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
    """uint8 NHWC [0, 255] -> ``x / 127.5 - 1`` in float32, rounded once to
    ``compute``. Cast (port): ``Engine.ingest``'s."""
    return (x_uint8.float() / 127.5 - 1.0).to(compute)
