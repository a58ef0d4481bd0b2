"""The DCGAN's conv layer boundaries as one operator each way.

Between two bf16 convs the plain chain is a run of separate kernels: the
conv's output upcast to float32, the float32 bias, then either the next
conv's CReLU (a cast back to bf16, a negation, a concatenation, a relu) and
the copy that pads it for XLA's (1, 2) stride-2 SAME padding, or the
generator's GLU in float32, the cast, and the copy of the 2x nearest-
neighbour upsample. Autograd runs the chain backwards, and keeps the relu's
result and the float32 pre-GLU tensor alive for it. The JAX package has no
counterpart: XLA fuses the chain.

:func:`crelu_pad` and :func:`glu_upsample` take the previous layer's raw
output (its compute-dtype result before the bias) and its float32 bias, and
return the next conv's input. On the card each is a ``torch.autograd.
Function`` whose forward and backward are the kernels of
``csrc/layer_boundary.cu`` (design and bound in its header): the forward
reads y once and writes the next input once; the backward reads that
input's gradient once, writes y's once, and sums the bias gradient from
per-block partials in a fixed order. The values are the plain chain's, bit
for bit: the roundings stay where they were (the CReLU rounds before the
relu, which commutes with it, ``layers.CAST_FIRST``; the GLU rounds after).
The bias gradient sums the same float32 terms in another order.

:func:`engages` is the dispatch a model asks first: a single CUDA tensor
and bf16 layers, none waiting for its data-dependent init; anything else
(every CPU tensor, the DenseNet's list inputs, float32 models, the init
pass) runs the layers as they are and never reaches this module. Called
directly, each operator launches the kernel on a CUDA tensor (or raises)
and takes its plain version, the chain as ``nn/layers.py`` runs it, on a
CPU tensor: the reference the tests hold the kernels to.

``launches`` counts the kernels' calls (``kernel``: one a forward, one a
backward) and the plain version's through the operator (``plain``: one a
forward; a model never makes one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from otgan_tpu_torch.nn.layers import apply_pre_activation, glu, nn_upsample

# threads a block and blocks a launch aims at: a fixed count, so the order
# of the bias partials depends on the shapes alone, never on the card
THREADS = 256
BLOCKS = 1024
VEC = 8  # channels a thread moves at once (16 bytes of bf16)

launches = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is where the kernels run."""
    return t.is_cuda


def engages(x, layers: Iterable) -> bool:
    """Whether a model's boundaries between ``layers`` run as this
    operator: ``x`` is one CUDA tensor, and every layer computes in bf16
    and has no data-dependent init pending."""
    return isinstance(x, torch.Tensor) and _on_card(x) and all(
        layer.compute_dtype == torch.bfloat16 and not layer.init_pending for layer in layers)


def tiling(rows: int, groups: int) -> Tuple[int, int, int, int, int]:
    """``(tg, lanes, tiles, chunks, rows_per_chunk)`` of a launch over
    ``rows`` rows of ``groups`` 8-channel groups: blocks of ``tg`` groups x
    ``lanes`` rows of threads, ``tiles`` x ``chunks`` of them, about
    ``BLOCKS``, each block ``rows_per_chunk`` consecutive rows."""
    tg = min(groups, THREADS)
    lanes = THREADS // tg
    tiles = -(-groups // tg)
    chunks = max(1, min(-(-rows // lanes), BLOCKS // tiles))
    rows_per_chunk = -(-rows // chunks)
    return tg, lanes, tiles, -(-rows // rows_per_chunk), rows_per_chunk


def _pads4(pads: Sequence[int]) -> Tuple[int, int, int, int]:
    pads = tuple(int(p) for p in pads)
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError(f"pads are (top, bottom, left, right) >= 0, got {pads}")
    return pads


# -- plain versions: the chain of nn/layers.py, op for op ---------------------

def crelu_pad_plain(y: torch.Tensor, bias: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """``relu([r, -r])``, ``r = (float(y) + bias)`` rounded to y's dtype,
    padded by ``pads`` = (top, bottom, left, right)."""
    pt, pb, pl, pr = _pads4(pads)
    x = apply_pre_activation(y.float() + bias, "crelu", y.dtype)
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def glu_upsample_plain(y: torch.Tensor, bias: torch.Tensor, factor: int,
                       hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``glu(float(y) + bias)`` rounded to y's dtype and upsampled
    ``factor`` x (1: none). ``hw``: y is a dense layer's ``(N, 2HWC)``,
    gated over its halves and viewed as ``(N, H, W, C)``."""
    if hw is None:
        x = glu(y.float() + bias)
    else:
        x = glu(y.float() + bias, dim=1).reshape(y.shape[0], *hw, -1)
    x = x.to(y.dtype)
    return nn_upsample(x, factor) if factor > 1 else x


# -- the kernels ---------------------------------------------------------------

@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("layer_boundary")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, n_ptrs, n_ints in (("otgan_crelu_pad_forward", 3, 13),
                                 ("otgan_crelu_pad_backward", 5, 13),
                                 ("otgan_glu_upsample_forward", 3, 11),
                                 ("otgan_glu_upsample_backward", 6, 11)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptrs + [i] * n_ints + [ptr]
        fn.restype = ctypes.c_int
    lib.otgan_layer_boundary_error_string.argtypes = [i]
    lib.otgan_layer_boundary_error_string.restype = ctypes.c_char_p
    return lib


def _check(what: str, t: torch.Tensor, dtype: torch.dtype, shape=None, device=None) -> None:
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous() and t.data_ptr() % 16 == 0
            and (shape is None or tuple(t.shape) == tuple(shape))
            and (device is None or t.device == device)):
        raise ValueError(
            f"{what} must be a contiguous, 16-byte aligned {dtype} CUDA tensor"
            + (f" of shape {tuple(shape)}" if shape is not None else "")
            + (f" on {device}" if device is not None else "")
            + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(name: str, shape, *args) -> None:
    lib = _bind()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed at {tuple(shape)}: "
                           f"{lib.otgan_layer_boundary_error_string(err).decode()} ({err})")
    launches["kernel"] += 1


def _limits(what: str, *sizes: int) -> None:
    if max(sizes) >= 2 ** 31:
        raise ValueError(f"{what}: {max(sizes)} rows or groups do not fit the kernel's int")


def _crelu_geometry(y_shape, pads):
    n, h, w, c = y_shape
    if c % VEC or min(n, h, w, c) < 1:
        raise ValueError(f"crelu_pad needs (N, H, W, C) with C a multiple of {VEC}, got "
                         f"{tuple(y_shape)}")
    pt, pb, pl, pr = _pads4(pads)
    hp, wp = h + pt + pb, w + pl + pr
    _limits("crelu_pad", n * hp * wp, n * hp * wp * 2 * c // VEC)
    return n, h, w, c, pt, pl, hp, wp


def crelu_pad_cuda(y: torch.Tensor, bias: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """The forward kernel: ``y`` (N, H, W, C) bf16, ``bias`` (C,) float32,
    both contiguous on one card; returns (N, H + pt + pb, W + pl + pr, 2C)
    bf16."""
    _check("crelu_pad: y", y, torch.bfloat16)
    if y.dim() != 4:
        raise ValueError(f"crelu_pad: y must be (N, H, W, C), got {tuple(y.shape)}")
    n, h, w, c, pt, pl, hp, wp = _crelu_geometry(y.shape, pads)
    _check("crelu_pad: bias", bias, torch.float32, (c,), y.device)
    with torch.cuda.device(y.device):
        x = torch.empty((n, hp, wp, 2 * c), device=y.device, dtype=y.dtype)
        _launch("otgan_crelu_pad_forward", y.shape, y.data_ptr(), bias.data_ptr(), x.data_ptr(),
                n, h, w, c, pt, pl, hp, wp, *tiling(n * hp * wp, c // VEC),
                torch.cuda.current_stream().cuda_stream)
    return x


def crelu_pad_backward_cuda(gx: torch.Tensor, x: torch.Tensor, y_shape, pads: Sequence[int],
                            grad_y: bool = True, grad_bias: bool = True):
    """The backward kernel: ``gx``, the gradient of the padded input ``x``
    that :func:`crelu_pad_cuda` wrote for y of ``y_shape``; returns (the
    bf16 gradient of y, the float32 gradient of the bias), each None where
    not asked for."""
    n, h, w, c, pt, pl, hp, wp = _crelu_geometry(tuple(y_shape), pads)
    _check("crelu_pad backward: x", x, torch.bfloat16, (n, hp, wp, 2 * c))
    _check("crelu_pad backward: gx", gx, torch.bfloat16, x.shape, x.device)
    tile = tiling(n * h * w, c // VEC)
    with torch.cuda.device(x.device):
        gy = torch.empty((n, h, w, c), device=x.device, dtype=x.dtype) if grad_y else None
        gb = part = None
        if grad_bias:
            gb = torch.empty((c,), device=x.device, dtype=torch.float32)
            part = torch.empty((tile[3], c), device=x.device, dtype=torch.float32)
        _launch("otgan_crelu_pad_backward", y_shape, gx.data_ptr(), x.data_ptr(), _ptr(gy),
                _ptr(part), _ptr(gb), n, h, w, c, pt, pl, hp, wp, *tile,
                torch.cuda.current_stream().cuda_stream)
    return gy, gb


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _glu_geometry(y_shape, factor: int, hw):
    """(n, h, w, c, dense, rows, groups) of a GLU boundary on y of
    ``y_shape``; c is the gated channel count, the output's."""
    if factor not in (1, 2):
        raise ValueError(f"glu_upsample: factor must be 1 or 2, got {factor}")
    if hw is None:
        if len(y_shape) != 4:
            raise ValueError(f"glu_upsample: y must be (N, H, W, 2C), got {tuple(y_shape)}")
        n, h, w, c2 = y_shape
    else:
        if len(y_shape) != 2 or len(hw) != 2:
            raise ValueError(f"glu_upsample: a dense y must be (N, 2HWC) with hw (H, W), got "
                             f"{tuple(y_shape)} and {hw}")
        (n, c2), (h, w) = y_shape, hw
        if min(h, w) < 1 or c2 % (2 * h * w):
            raise ValueError(f"glu_upsample: {c2} features are not 2 x {h} x {w} x C")
        c2 //= h * w
    c = c2 // 2
    if c2 % 2 or c % VEC or min(n, h, w, c) < 1:
        raise ValueError(f"glu_upsample: the gated channels must be a positive multiple of "
                         f"{VEC}, got y {tuple(y_shape)} (hw {hw})")
    dense = hw is not None
    rows, groups = (n, h * w * c // VEC) if dense else (n * h * w, c // VEC)
    _limits("glu_upsample", rows, groups, n * h * w * factor * factor * c // VEC)
    return n, h, w, c, dense, rows, groups


def glu_upsample_cuda(y: torch.Tensor, bias: torch.Tensor, factor: int,
                      hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The forward kernel: ``y`` (N, H, W, 2C) bf16, or a dense layer's
    (N, 2HWC) with ``hw``; ``bias`` its float32 bias; returns
    (N, factor H, factor W, C) bf16."""
    _check("glu_upsample: y", y, torch.bfloat16)
    n, h, w, c, dense, rows, groups = _glu_geometry(tuple(y.shape), factor, hw)
    _check("glu_upsample: bias", bias, torch.float32, (y.shape[-1],), y.device)
    with torch.cuda.device(y.device):
        x = torch.empty((n, factor * h, factor * w, c), device=y.device, dtype=y.dtype)
        _launch("otgan_glu_upsample_forward", y.shape, y.data_ptr(), bias.data_ptr(),
                x.data_ptr(), n, h, w, c, factor, int(dense), *tiling(rows, groups),
                torch.cuda.current_stream().cuda_stream)
    return x


def glu_upsample_backward_cuda(gx: torch.Tensor, y: torch.Tensor, bias: torch.Tensor,
                               factor: int, hw: Optional[Tuple[int, int]] = None,
                               grad_y: bool = True, grad_bias: bool = True):
    """The backward kernel: ``gx`` the gradient of :func:`glu_upsample_cuda`'s
    output; returns (the bf16 gradient of y, the float32 gradient of the
    bias), each None where not asked for."""
    _check("glu_upsample backward: y", y, torch.bfloat16)
    n, h, w, c, dense, rows, groups = _glu_geometry(tuple(y.shape), factor, hw)
    _check("glu_upsample backward: bias", bias, torch.float32, (y.shape[-1],), y.device)
    _check("glu_upsample backward: gx", gx, torch.bfloat16, (n, factor * h, factor * w, c),
           y.device)
    tile = tiling(rows, groups)
    with torch.cuda.device(y.device):
        gy = torch.empty_like(y) if grad_y else None
        gb = part = None
        if grad_bias:
            gb = torch.empty_like(bias)
            part = torch.empty((tile[3], y.shape[-1]), device=y.device, dtype=torch.float32)
        _launch("otgan_glu_upsample_backward", y.shape, gx.data_ptr(), y.data_ptr(),
                bias.data_ptr(), _ptr(gy), _ptr(part), _ptr(gb), n, h, w, c, factor, int(dense),
                *tile, torch.cuda.current_stream().cuda_stream)
    return gy, gb


class _CReLUPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, pads):
        x = crelu_pad_cuda(y, bias, pads)
        # the next conv keeps x for its weight gradient: the sign of r is read
        # back from it, so nothing else is kept
        ctx.save_for_backward(x)
        ctx.y_shape, ctx.pads = tuple(y.shape), pads
        return x

    @staticmethod
    def backward(ctx, gx):
        (x,) = ctx.saved_tensors
        gy, gb = crelu_pad_backward_cuda(gx.contiguous(), x, ctx.y_shape, ctx.pads,
                                         *ctx.needs_input_grad[:2])
        return gy, gb, None


class _GLUUpsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, factor, hw):
        ctx.save_for_backward(y, bias)
        ctx.factor, ctx.hw = factor, hw
        return glu_upsample_cuda(y, bias, factor, hw)

    @staticmethod
    def backward(ctx, gx):
        y, bias = ctx.saved_tensors
        gy, gb = glu_upsample_backward_cuda(gx.contiguous(), y, bias, ctx.factor, ctx.hw,
                                            *ctx.needs_input_grad[:2])
        return gy, gb, None, None


def _plain(y: torch.Tensor, what: str) -> bool:
    if _on_card(y):
        return False
    if y.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {y.device}")
    launches["plain"] += 1
    return True


def crelu_pad(y: torch.Tensor, bias: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """The next conv's input across a CReLU boundary: ``y`` the previous
    conv's raw output (N, H, W, C), ``bias`` its float32 bias, ``pads`` the
    next conv's SAME padding (top, bottom, left, right); returns
    ``relu([r, -r])`` padded, r = bf16(float(y) + bias). The kernel on the
    card, the plain version on the CPU."""
    if _plain(y, "crelu_pad"):
        return crelu_pad_plain(y, bias, pads)
    return _CReLUPad.apply(y.contiguous(), bias.contiguous(), _pads4(pads))


def glu_upsample(y: torch.Tensor, bias: torch.Tensor, factor: int,
                 hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The next conv's input across a GLU boundary: ``y`` the previous
    layer's raw output, (N, H, W, 2C) or a dense layer's (N, 2HWC) with
    ``hw``, ``bias`` its float32 bias; returns bf16(h * sigmoid(gate))
    upsampled ``factor`` x, (N, factor H, factor W, C). The kernel on the
    card, the plain version on the CPU."""
    if _plain(y, "glu_upsample"):
        return glu_upsample_plain(y, bias, factor, hw)
    return _GLUUpsample.apply(y.contiguous(), bias.contiguous(), int(factor),
                              None if hw is None else tuple(hw))
