"""Weight-normalised layers with data-dependent init (counterpart of
``otgan_tpu/nn/layers.py``, after the reference's ``utils/nn.py:89-338``).

* Parameters are ``(V, g, b)`` with effective weight ``W = g * V / ||V||``,
  the norm taken over every axis except the output one. V is stored in
  PyTorch's layout: ``(out, in)`` for dense, OIHW for conv (the JAX package
  stores ``(in, out)`` and HWIO; ``convert.py`` carries weights across).
* A plain dense layer (``weight_norm=False``, the toy MLPs) has only
  ``(V, b)`` and uses V as it is; without data init V is drawn at He scale
  ``sqrt(2 / fan_in) N(0, 1)`` (the toy notebook's xavier_init).
* Data-dependent init really runs: on the first forward after
  :func:`data_init` marks a layer, ``g = init_scale / (std(pre) + 1e-10)``
  and ``b = -mean(pre * g)`` over a real batch (population std); a plain
  layer folds that scale into V instead (``utils/nn.py:150-151``).
* The pre-activation (none/relu/elu/crelu/celu) is applied to the input
  inside the layer; the 'c' variants concatenate ``[x, -x]`` on channels and
  double the fan-in. A conv takes a list of tensors (the DenseNet's dense
  connectivity): the 'c' variants interleave ``[x0, -x0, x1, -x1, ...]``
  per element before one concatenation, so V's input channels are in the
  JAX package's order. Each list a conv concatenates adds one to
  ``tracing.counts["dense_concat"]``.
* Activations are NHWC at every public function, as in the JAX package.
  Inside, the NHWC tensor is viewed as a channels-last NCHW tensor (no
  copy) for ``conv2d``.
* ``compute_dtype`` casts the input and the weight before the matmul or
  conv and upcasts the result to float32; weight-norm math stays float32.
  :meth:`~_WeightNormLayer.pre_bias` stops before the upcast and the bias,
  for a model whose next boundary adds them (``nn/layer_boundary.py``).
  Where the cast commutes with the pre-activation (none, relu, crelu) a
  conv casts each list element before the concatenation: the same conv
  input, bitwise, built at the compute dtype's width.
* Save points and remat (``otgan_tpu/nn/layers.py:353-429``): a model's
  forward is a list of stages, each tagged with the save-point names of the
  carry it returns; :func:`run_stages` runs them plainly or, with remat,
  as ``torch.utils.checkpoint`` segments that end at the save points a
  policy lists.
"""

from __future__ import annotations

from typing import Callable, Collection, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from otgan_tpu_torch.utils import tracing

PRE_ACTIVATIONS = (None, "relu", "elu", "crelu", "celu")
# pre-activations that commute with rounding to a narrower float: each is
# monotone, odd or clamping at 0, and keeps 0
CAST_FIRST = (None, "relu", "crelu")

TensorOrList = Union[torch.Tensor, Sequence[torch.Tensor]]


def apply_pre_activation(x: TensorOrList, pre_activation: Optional[str],
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Reference ``apply_pre_activation`` (``utils/nn.py:190-206``) on the
    last (channel) axis of a tensor or a list of tensors, concatenated; the
    'c' variants interleave ``[xi, -xi]`` per element. ``dtype``: cast each
    element to it first where that gives the same result (``CAST_FIRST``)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if pre_activation not in PRE_ACTIVATIONS:
        raise ValueError(f"unsupported pre-activation: {pre_activation!r}")
    if dtype is not None and pre_activation in CAST_FIRST:
        xs = [xi.to(dtype) for xi in xs]
    if pre_activation in ("crelu", "celu"):
        xs = [s for xi in xs for s in (xi, -xi)]
    cat = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
    if pre_activation in ("relu", "crelu"):
        return F.relu(cat)
    if pre_activation in ("elu", "celu"):
        return F.elu(cat)
    return cat


def fan_in_factor(pre_activation: Optional[str]) -> int:
    return 2 if pre_activation in ("crelu", "celu") else 1


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gated linear unit ``h * sigmoid(gate)`` over the two halves of ``dim``."""
    h, gate = torch.chunk(x, 2, dim=dim)
    return h * torch.sigmoid(gate)


def l2_normalize_rows(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Row L2 normalisation of the critic head (no epsilon by default)."""
    return x / torch.sqrt(torch.sum(x.square(), dim=-1, keepdim=True) + eps)


def nn_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


Stage = Tuple[Callable, Tuple[str, ...]]


def save_names(remat_policy: str) -> frozenset:
    """The save-point names a ``--remat_policy`` string lists."""
    return frozenset(n.strip() for n in remat_policy.split(",") if n.strip())


def segments(stages: Sequence[Stage], save: Collection[str]) -> List[List[Stage]]:
    """``stages`` cut after each stage whose tags meet ``save``. Unknown
    names are inert; with none listed the whole model is one segment."""
    out, cur = [], []
    for stage in stages:
        cur.append(stage)
        if any(tag in save for tag in stage[1]):
            out.append(cur)
            cur = []
    return out + [cur] if cur else out


def _run(segment: Sequence[Stage], carry):
    for fn, _ in segment:
        carry = fn(carry)
    return carry


def run_stages(stages: Sequence[Stage], carry, remat: bool = False,
               save: Collection[str] = frozenset()):
    """Run a model's forward, ``stages``: ``(fn, tags)`` pairs, ``fn`` maps
    the carry (a tensor or a list of tensors) to the next, and ``tags`` name
    the save points of the carry it returns (``save_point`` in the JAX
    package; a segment boundary keeps whole tensors, so ``save_point_half``
    has no counterpart).

    Without ``remat``, or with no gradient to record (the data-dependent
    init, sampling), the plain sequence. With ``remat``, each of
    :func:`segments` runs under ``torch.utils.checkpoint`` (non-reentrant):
    the carries at the listed save points are kept, the rest is recomputed
    in the backward pass, one segment at a time. Values and gradients are
    the plain run's. The stages draw no randomness (latents are inputs), so
    no RNG state is kept for the recompute."""
    if not remat or not torch.is_grad_enabled():
        return _run(stages, carry)
    for seg in segments(stages, save):
        is_list = isinstance(carry, (list, tuple))

        def fn(*ts, seg=seg, is_list=is_list):
            out = _run(seg, list(ts) if is_list else ts[0])
            return tuple(out) if isinstance(out, list) else out

        out = checkpoint(fn, *(carry if is_list else [carry]), use_reentrant=False,
                         preserve_rng_state=False)
        carry = list(out) if isinstance(out, tuple) else out
    return carry


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1):
    """XLA's SAME padding ``(low, high)`` for one spatial dim: the output is
    ``ceil(size / stride)`` and an odd total pads one more at the high end
    (5x5 stride 2 on 32 -> 16 pads (1, 2)); a dilated kernel spans
    ``(kernel - 1) * dilation + 1``."""
    out = -(-size // stride)
    span = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


class _WeightNormLayer(nn.Module):
    """Shared (V, g, b) handling. ``V`` has the output axis first. With
    ``weight_norm=False`` the layer has no g and V is the weight."""

    def __init__(self, v_shape: Sequence[int], init_scale: float,
                 pre_activation: Optional[str], compute_dtype: torch.dtype,
                 weight_norm: bool = True):
        super().__init__()
        if pre_activation not in PRE_ACTIVATIONS:
            raise ValueError(f"unsupported pre-activation: {pre_activation!r}")
        self.V = nn.Parameter(torch.empty(tuple(v_shape)))
        if weight_norm:
            self.g = nn.Parameter(torch.ones(v_shape[0]))
        self.b = nn.Parameter(torch.zeros(v_shape[0]))
        self.weight_norm = weight_norm
        self.init_scale = init_scale
        self.pre_activation = pre_activation
        self.compute_dtype = compute_dtype
        self.init_pending = False

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """``V ~ 0.05 N(0, 1)`` (reference initializer, ``utils/nn.py:124``),
        ``g = 1``, ``b = 0``; a plain layer draws V at He scale
        ``sqrt(2 / fan_in) N(0, 1)`` (``otgan_tpu/nn/layers.py:174-180``).
        Drawn on the CPU so every device gets the same numbers from one
        seed."""
        scale = 0.05 if self.weight_norm else (2.0 / self.V[0].numel()) ** 0.5
        self.V.copy_(scale * torch.randn(self.V.shape, generator=generator))
        if self.weight_norm:
            self.g.fill_(1.0)
        self.b.fill_(0.0)

    def _direction(self) -> torch.Tensor:
        if not self.weight_norm:
            return self.V
        dims = tuple(range(1, self.V.dim()))
        return self.V / torch.sqrt(torch.sum(self.V.square(), dim=dims, keepdim=True))

    def _apply_weight(self, xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The layer's product at the compute dtype, before the bias."""
        raise NotImplementedError

    def _weight(self) -> torch.Tensor:
        w = self._direction()
        if self.weight_norm:
            w = w * self.g.reshape((-1,) + (1,) * (self.V.dim() - 1))
        return w

    def forward(self, x: TensorOrList) -> torch.Tensor:
        xin = self._input(x)
        if self.init_pending:
            return self._data_dependent_init(xin)
        return self._apply_weight(xin, self._weight()).float() + self.b

    def pre_bias(self, xin: torch.Tensor) -> torch.Tensor:
        """The layer's output at the compute dtype before its bias, on an
        input that needs no pre-activation: a first layer's, or one that
        ``nn/layer_boundary.py`` built. The next boundary adds the bias."""
        return self._apply_weight(xin, self._weight())

    @torch.no_grad()
    def _data_dependent_init(self, xin: torch.Tensor) -> torch.Tensor:
        """``utils/nn.py:108-162`` with the init pass actually executed; a
        plain layer folds the scale into V (``utils/nn.py:150-151``)."""
        pre = self._apply_weight(xin, self._direction()).float()
        dims = tuple(range(pre.dim() - 1))
        std = torch.std(pre, dim=dims, correction=0)
        g = self.init_scale / (std + 1e-10)
        out = pre * g
        b = -torch.mean(out, dim=dims)
        if self.weight_norm:
            self.g.copy_(g)
        else:
            self.V.mul_(g.reshape((-1,) + (1,) * (self.V.dim() - 1)))
        self.b.copy_(b)
        self.init_pending = False
        return out + b

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        return apply_pre_activation(x, self.pre_activation)


class Dense(_WeightNormLayer):
    """Weight-normalised dense layer (reference ``dense``,
    ``utils/nn.py:314-325``); V is ``(num_units, fan_in)``. ``weight_norm=
    False`` is the JAX package's ``dense(weight_norm=False, use_g=False)``:
    V and b only."""

    def __init__(self, in_features: int, num_units: int,
                 pre_activation: Optional[str] = "celu", init_scale: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32, weight_norm: bool = True):
        fan_in = in_features * fan_in_factor(pre_activation)
        super().__init__((num_units, fan_in), init_scale, pre_activation, compute_dtype,
                         weight_norm)

    def _apply_weight(self, xin, w):
        cd = self.compute_dtype
        return F.linear(xin.to(cd), w.to(cd))


class Conv2d(_WeightNormLayer):
    """Weight-normalised conv layer (reference ``conv2d``,
    ``utils/nn.py:327-338``) on NHWC inputs; V is OIHW. The input is a
    tensor or a list of tensors whose channels sum to ``in_channels``.
    ``upsample`` concatenates a list, NN-upsamples it 2x, then applies the
    pre-activation (``otgan_tpu/nn/layers.py:287-296``). ``dilation`` is the
    reference's ``atrous_conv2d``. Padding is XLA's SAME."""

    def __init__(self, in_channels: int, num_filters: int,
                 filter_size: Sequence[int] = (3, 3), stride: Sequence[int] = (1, 1),
                 upsample: bool = False, pre_activation: Optional[str] = "celu",
                 init_scale: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32, dilation: int = 1):
        fan_in = in_channels * fan_in_factor(pre_activation)
        kh, kw = filter_size
        super().__init__((num_filters, fan_in, kh, kw), init_scale,
                         pre_activation, compute_dtype)
        self.stride = tuple(stride)
        self.upsample = upsample
        self.dilation = dilation

    def _input(self, x):
        cd = self.compute_dtype
        if isinstance(x, (list, tuple)):
            tracing.counts["dense_concat"] += 1
        if self.upsample:  # concatenate (cast first where that commutes), then upsample
            x = nn_upsample(apply_pre_activation(
                x, None, cd if self.pre_activation in CAST_FIRST else None))
        return apply_pre_activation(x, self.pre_activation, cd)

    def same_pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """XLA's SAME padding of an ``h`` x ``w`` input: (top, bottom,
        left, right)."""
        kh, kw = self.V.shape[2:]
        return (same_padding(h, kh, self.stride[0], self.dilation)
                + same_padding(w, kw, self.stride[1], self.dilation))

    def pre_bias(self, xin: torch.Tensor, padded: bool = False) -> torch.Tensor:
        """:meth:`_WeightNormLayer.pre_bias`; ``padded``: ``xin`` already
        holds the SAME padding (the CReLU boundary writes it), so the conv
        pads nothing."""
        return self._apply_weight(xin, self._weight(), padded)

    def _apply_weight(self, xin, w, padded: bool = False):
        cd = self.compute_dtype
        x = xin.to(cd)
        pt, pb, pl, pr = (0, 0, 0, 0) if padded else self.same_pads(*xin.shape[1:3])
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
            padding = (0, 0)
        # NHWC -> channels-last NCHW view, and back: no copies
        out = F.conv2d(x.permute(0, 3, 1, 2), w.to(cd), stride=self.stride,
                       padding=padding, dilation=self.dilation)
        return out.permute(0, 2, 3, 1)


def weight_norm_layers(module: nn.Module) -> Iterable[_WeightNormLayer]:
    return (m for m in module.modules() if isinstance(m, _WeightNormLayer))


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every layer's V in registration order from ``generator``."""
    for layer in weight_norm_layers(module):
        layer.reset_parameters(generator)


@torch.no_grad()
def data_init(module: nn.Module, *inputs) -> torch.Tensor:
    """Run the data-dependent init: mark every layer, run one forward on a
    real batch (each layer sets its g and b as the batch reaches it) and
    return that forward's output."""
    layers = list(weight_norm_layers(module))
    for layer in layers:
        layer.init_pending = True
    out = module(*inputs)
    missed = [layer for layer in layers if layer.init_pending]
    if missed:
        raise RuntimeError(f"{len(missed)} layers saw no data during init")
    return out
