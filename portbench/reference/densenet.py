"""The DenseNet of OT-GAN in plain PyTorch (openai/ot-gan ``models/densenet.py``
and ``utils/nn.py``, arXiv:1803.05573; ``train.py --model densenet``), as a
function of a dict of parameters.

Critic: a 3x3 conv to ``2F`` channels, then three dense blocks of ``L``
3x3 convs of ``F`` filters, each reading the concatenation of all earlier
outputs of its block after a CReLU, each block closed by a 3x3 stride-2
conv to half the block's channels (also after a CReLU); a CReLU, an NHWC
flatten and a row L2 normalisation: unit features of 4*4*2*228 = 7296 at
``L = F = 16``. Generator: four ``U(-1, 1)`` noises, (B, 100), (B, 8, 8, F),
(B, 16, 16, F) and (B, 32, 32, F); a dense layer maps the first to 8x8xF,
each other joins the feature list at its scale; dense blocks as the
critic's; between them the list concatenated, upsampled 2x (nearest) and
convolved to half its channels after a CReLU; a last conv to 3 channels
(init scale 0.1) after a CReLU; tanh. Weight norm ``W = g V / ||V||`` with
the data-dependent init of ``utils/nn.py:108-162``: ``g = s / std(pre)``,
``b = -mean(pre g)`` on a real batch; V drawn ``0.05 N(0, 1)`` on the CPU
from the seed, the critic's layers first, each net's in its order of
execution (``dense_0``, then ``conv2d_0``, ``conv2d_1``, ...). SAME
padding (an odd total pads one more at the high end).

A CReLU on a list is ``relu`` of the channels ``[x0, -x0, x1, -x1, ...]``,
one pair an element, in that order (the order of V's input channels).

Precision is the configuration's: each conv and dense layer takes its input
and weight in ``compute`` (bf16 in ``densenet_train_py``) and accumulates in
float32, its result returned in ``compute`` and upcast; weight norm, the
bias, tanh, the head and everything after run in float32. Each cast sits
where the port puts it ("cast (port)" below): a list element is rounded to
``compute`` before the concatenation, which gives the same input as
rounding after it, since rounding commutes with negation, relu and the
nearest upsample.

Departures from the source, none of which changes a value: the source ran
float32 (``compute_dtype`` is in the configuration's ``reduced``); a
forward without autograd runs in blocks of the port's microbatch rows
(1250), each row's result the same function of that row, so that each
conv runs at the shapes the port's runs and the card picks the same conv
kernels (at the whole batch of 5000 the card's kernels round some bf16
outputs otherwise, and the first step's distance read up to 4.5e-6 from
the program's, a third of what the TF32 control reads); under
autograd each conv's concatenated input is rebuilt in the backward pass
(``torch.utils.checkpoint``) rather than kept, so a block of 1250 rows fits
the card in float32 as in bf16 (the rebuilt input is the same, bit for bit:
casts, negations, a concatenation and relu); the relu of a concatenation
runs in place on it.

A model family of the plain reference (``reference/train.py`` names the
interface): the configuration's ``model`` is ``densenet``. The module's
functions are those of :class:`Family` at the source's widths, ``L = F =
16``; a test builds a smaller one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Latent = Tuple[torch.Tensor, ...]
LATENT = 100


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def upsample(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _direction(v: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, v.dim()))
    return v / torch.sqrt(torch.sum(v.square(), dim=dims, keepdim=True))


def _layer_input(xs: Sequence[torch.Tensor], crelu: bool, up: bool,
                 compute: torch.dtype) -> torch.Tensor:
    """A layer's input from the list ``xs``: concatenated (upsampled first
    where ``up``), under a CReLU where ``crelu``."""
    # cast (port): each element, before the concatenation
    xs = [x.to(compute) for x in xs]
    if up:
        xs = [upsample(xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1))]
    if not crelu:
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
    return torch.cat([s for x in xs for s in (x, -x)], dim=-1).relu_()


def _product(x: torch.Tensor, w: torch.Tensor, stride: int, compute: torch.dtype) -> torch.Tensor:
    # cast (port): input and weight-normed weight to ``compute``; the result
    # comes in ``compute`` and is upcast by the caller
    if w.dim() == 2:
        return F.linear(x.to(compute), w.to(compute))
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
    return out.permute(0, 2, 3, 1)


def layer(params: Params, name: str, xs: Sequence[torch.Tensor], compute: torch.dtype,
          init: bool = False, crelu: bool = True, stride: int = 1, up: bool = False,
          scale: float = 1.0) -> torch.Tensor:
    """One weight-normalised layer on the list ``xs``, its result in
    float32; ``init`` runs its data-dependent init on them (setting g and b
    in ``params``) and returns the init output."""
    v, g, b = (params[f"{name}.{p}"] for p in ("V", "g", "b"))
    if init:
        with torch.no_grad():
            pre = _product(_layer_input(xs, crelu, up, compute), _direction(v), stride,
                           compute).float()
            dims = tuple(range(pre.dim() - 1))
            g_new = scale / (torch.std(pre, dim=dims, correction=0) + 1e-10)
            out = pre * g_new
            b_new = -torch.mean(out, dim=dims)
            g.copy_(g_new)
            b.copy_(b_new)
            return out + b_new
    w = _direction(v) * g.reshape((-1,) + (1,) * (v.dim() - 1))

    def product(w, *xs):
        return _product(_layer_input(xs, crelu, up, compute), w, stride, compute)

    if torch.is_grad_enabled():
        out = checkpoint(product, w, *xs, use_reentrant=False, preserve_rng_state=False)
    else:
        out = product(w, *xs)
    return out.float() + b


class Family:
    """The critic and the generator at ``layers_per_block`` (L) and
    ``filters_per_layer`` (F), with the interface of ``reference/train.py``.
    ``rows``: a forward without autograd (not the init) runs in blocks of
    that many rows, as the port's microbatches run it, so that each conv
    meets the shapes the port's meets (None: the whole batch at once)."""

    def __init__(self, layers_per_block: int = 16, filters_per_layer: int = 16,
                 rows: Optional[int] = None):
        self.L, self.F, self.rows = layers_per_block, filters_per_layer, rows

    def _blocks(self, batch: int, init: bool) -> List[slice]:
        """The row blocks of a forward (one, the whole batch, under
        autograd or the init)."""
        if init or torch.is_grad_enabled() or not self.rows or batch <= self.rows:
            return [slice(0, batch)]
        return [slice(i, min(i + self.rows, batch)) for i in range(0, batch, self.rows)]

    @staticmethod
    def images(x_uint8: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
        """uint8 NHWC [0, 255] -> ``x / 127.5 - 1`` in float32, rounded once
        to ``compute``. Cast (port): ``Engine.ingest``'s."""
        return (x_uint8.float() / 127.5 - 1.0).to(compute)

    def disc_shapes(self) -> List[Tuple[int, ...]]:
        """V's shape of each critic layer, in order."""
        L, F_ = self.L, self.F
        shapes = [(2 * F_, 3, 3, 3)]
        ch = 2 * F_
        for _ in range(3):
            for _ in range(L):
                shapes.append((F_, 2 * ch, 3, 3))
                ch += F_
            shapes.append((ch // 2, 2 * ch, 3, 3))
            ch //= 2
        return shapes

    def gen_shapes(self) -> List[Tuple[int, ...]]:
        """V's shape of each generator layer, in order (``dense_0`` first)."""
        L, F_ = self.L, self.F
        shapes = [(8 * 8 * F_, LATENT)]
        ch = 2 * F_
        for k in range(3):
            for _ in range(L):
                shapes.append((F_, 2 * ch, 3, 3))
                ch += F_
            if k < 2:
                shapes.append((ch // 2, 2 * ch, 3, 3))
                ch = ch // 2 + F_
        shapes.append((3, 2 * ch, 3, 3))
        return shapes

    @staticmethod
    def _names(shapes, dense: bool) -> List[str]:
        names = ["dense_0"] if dense else []
        return names + [f"conv2d_{k}" for k in range(len(shapes) - len(names))]

    def draw(self, seed: int) -> Tuple[Params, Params, torch.Generator]:
        """V of the critic, then of the generator, from a CPU generator
        seeded ``seed``; g = 1, b = 0. The generator is returned for the
        init latents."""
        rng = torch.Generator().manual_seed(seed)
        nets = []
        for shapes, dense in ((self.disc_shapes(), False), (self.gen_shapes(), True)):
            params = {}
            for name, shape in zip(self._names(shapes, dense), shapes):
                params[f"{name}.V"] = 0.05 * torch.randn(shape, generator=rng)
                params[f"{name}.g"] = torch.ones(shape[0])
                params[f"{name}.b"] = torch.zeros(shape[0])
            nets.append(params)
        return nets[0], nets[1], rng

    def _shapes(self, batch: int) -> List[Tuple[int, ...]]:
        f = self.F
        return [(batch, LATENT), (batch, 8, 8, f), (batch, 16, 16, f), (batch, 32, 32, f)]

    def init_latent(self, n: int, cpu_rng: torch.Generator) -> Latent:
        """The data-dependent init's four noises, drawn on the CPU generator
        that :meth:`draw` returns, after the parameters."""
        return tuple(torch.rand(s, generator=cpu_rng) * 2.0 - 1.0 for s in self._shapes(n))

    def latent(self, batch: int, generator: torch.Generator, device: torch.device) -> Latent:
        """One step's four ``U(-1, 1)`` noises, drawn on ``generator`` in the
        port's order (``sample_latent``)."""
        return tuple(torch.rand(s, generator=generator, device=device) * 2.0 - 1.0
                     for s in self._shapes(batch))

    def critic(self, params: Params, x: torch.Tensor, compute: torch.dtype,
               init: bool = False) -> torch.Tensor:
        """NHWC images in [-1, 1] -> unit features (B, 16 * 2 * C), row by
        row."""
        blocks = self._blocks(x.shape[0], init)
        if len(blocks) > 1:
            return torch.cat([self.critic(params, x[b], compute) for b in blocks])
        k = 0

        def conv(xs, **kw):
            nonlocal k
            out = layer(params, f"conv2d_{k}", xs, compute, init, **kw)
            k += 1
            return out

        x = conv([x], crelu=False)
        for _ in range(3):
            xs = [x]
            for _ in range(self.L):
                xs.append(conv(xs))
            x = conv(xs, stride=2)
        x = F.relu(torch.cat([x, -x], dim=-1))
        x = x.reshape(x.shape[0], -1)
        return x / torch.sqrt(torch.sum(x.square(), dim=-1, keepdim=True))

    def generator(self, params: Params, z: Latent, compute: torch.dtype,
                  init: bool = False) -> torch.Tensor:
        """The four noises -> NHWC images (B, 32, 32, 3) in [-1, 1]."""
        blocks = self._blocks(z[0].shape[0], init)
        if len(blocks) > 1:
            return torch.cat([self.generator(params, tuple(t[b] for t in z), compute)
                              for b in blocks])
        u0, *noise = z
        k = 0

        def conv(xs, **kw):
            nonlocal k
            out = layer(params, f"conv2d_{k}", xs, compute, init, **kw)
            k += 1
            return out

        x = layer(params, "dense_0", [u0], compute, init, crelu=False)
        x = x.reshape(u0.shape[0], 8, 8, self.F)
        for i, u in enumerate(noise):
            xs = [x, u]
            for _ in range(self.L):
                xs.append(conv(xs))
            if i < 2:
                x = conv(xs, up=True)
        return torch.tanh(conv(xs, scale=0.1))


# the configuration's microbatches: 1250 rows (batch 5000, --grad_accum 4)
SOURCE = Family(rows=1250)
images = Family.images
draw = SOURCE.draw
init_latent = SOURCE.init_latent
latent = SOURCE.latent
critic = SOURCE.critic
generator = SOURCE.generator
