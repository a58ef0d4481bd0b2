"""The DenseNet's list-conv inputs from one bf16 slab a dense block.

A dense block's conv j takes the list of every earlier output. The plain
chain (``nn/layers.py``) rebuilds its input anew for each conv: each
element cast to bf16 and negated, one concatenation, a relu; autograd runs
that chain backwards per element and conv and keeps every conv's relu
output, O(L^2) bytes a block. The JAX package has no counterpart: XLA fuses
the chain into the conv.

Here each element is rounded once into a slab per block and forward call
(:class:`Block`, (N, H, W, C) bf16), and three operators of
``csrc/dense_boundary.cu`` (design and bound in its header) do the rest:

* :func:`write` rounds an element into the slab: a conv's or the dense
  layer's raw bf16 output (``pre_bias``) plus its float32 bias, or a noise.
* :func:`list_conv` gathers conv j's input from the slab's first elements,
  the tensor the chain passes to ``F.conv2d``: the same shape, strides,
  dtype and padding argument, so cuDNN runs the same algorithm; the
  stride-2 convs' asymmetric SAME border is written, the up convs' 2x
  nearest-neighbour repeat too. The conv keeps no input for its weight
  gradient: a saved-tensor hook gathers it again from the slab in the
  backward (or, where the weight needs no gradient, hands cuDNN an unread
  tensor of the same layout, :func:`_unread`).
* the gather's backward scatters conv j's input gradient into a float32
  gradient per element, stored by the element's first consumer in the
  backward and added to by each later one: the order in which autograd
  sums the chain's per-conv gradients, so every sum rounds as it did.
  An element's last consumer done, :func:`write`'s backward hands its
  producer ``acc.to(bf16)`` and the bias the same ``sum_to_size`` autograd
  runs on the chain. Values and every gradient are the chain's, bit for
  bit.

A :class:`Block` belongs to its forward call: autograd keeps it through
its Functions' contexts and frees it with the graph, so two forwards alive
at once, a no-grad forward between a forward and its backward, and
``--remat``'s recompute (whose own blocks are dropped with its graph) each
use their own slabs and accumulators.

:func:`engages` is the dispatch a model asks first: CUDA input tensors, bf16
layers with no data-dependent init pending and CReLU list convs; anything
else (every CPU tensor, float32 models, elu/celu/relu, the init pass) runs
the layers' chain and never reaches this module. A gather or scatter takes
any number of elements: it launches once for each run of ``MAX_ELEMS``
(:func:`runs`). Called directly, each operator launches its kernel on a
CUDA tensor and takes its plain version, the kernels' arithmetic in
PyTorch, on a CPU tensor: the reference the tests hold the kernels to.

``launches`` counts the kernels' calls (``kernel``: each slab write, gather
and scatter launched on the card) and the plain versions' (``plain``). No
program run moves ``plain``, since :func:`engages` refuses CPU tensors; it
counts the operators' own Functions driven on the CPU with the plain
versions in place of the kernels, as the CPU tests drive them, and reads
0 on the card, where a nonzero count would mean a kernel was skipped.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.graph import saved_tensors_hooks

from otgan_tpu_torch.nn.layers import nn_upsample
from otgan_tpu_torch.utils import tracing

MAX_ELEMS = 64  # elements a gather or scatter launch takes (csrc/dense_boundary.cu)

launches = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is where the kernels run."""
    return t.is_cuda


def engages(inputs: Sequence, layers: Sequence, list_convs: Sequence) -> bool:
    """Whether a model's list convs run on slabs: every input a CUDA tensor,
    every layer bf16 with no data-dependent init pending, and every list
    conv's pre-activation CReLU."""
    return (all(isinstance(t, torch.Tensor) and _on_card(t) for t in inputs)
            and all(layer.compute_dtype == torch.bfloat16 and not layer.init_pending
                    for layer in layers)
            and all(conv.pre_activation == "crelu" for conv in list_convs))


class Block:
    """One forward call's dense block: the slab (N, H, W, C) bf16 holding
    its elements at channels ``offsets[e]:offsets[e + 1]``, and in the
    backward each element's float32 gradient (N, H, W, f_e), one tensor an
    element. ``vec``: the kernels' channels a thread,
    the largest of 8, 4, 2, 1 that divides every width."""

    def __init__(self, like: torch.Tensor, n: int, h: int, w: int, widths: Sequence[int]):
        self.n, self.h, self.w = n, h, w
        self.widths = [int(f) for f in widths]
        self.offsets = [0]
        for f in self.widths:
            self.offsets.append(self.offsets[-1] + f)
        self.vec = next(v for v in (8, 4, 2, 1) if all(f % v == 0 for f in self.widths))
        self.slab = torch.empty((n, h, w, self.offsets[-1]), dtype=torch.bfloat16,
                                device=like.device)
        self.acc: List[Optional[torch.Tensor]] = [None] * len(self.widths)


class Geometry(NamedTuple):
    """Conv j's input from the slab's first ``k`` elements: ``factor`` 2 for
    the up convs (their channels as [relu(s), relu(-s)] over the prefix,
    ``halves``), else the list order per element; the border ``pads`` (top,
    bottom, left, right) written where the conv's SAME padding is uneven
    (``padded``: the conv then pads nothing)."""
    k: int
    factor: int
    halves: bool
    pads: tuple
    padded: bool


def geometry(block: Block, k: int, conv) -> Geometry:
    factor = 2 if conv.upsample else 1
    pads = conv.same_pads(factor * block.h, factor * block.w)
    if pads[0] == pads[1] and pads[2] == pads[3]:  # the conv's padding argument
        return Geometry(k, factor, conv.upsample, (0, 0, 0, 0), False)
    return Geometry(k, factor, conv.upsample, tuple(pads), True)


def _input_shape(block: Block, geo: Geometry):
    pt, pb, pl, pr = geo.pads
    return (block.n, geo.factor * block.h + pt + pb, geo.factor * block.w + pl + pr,
            2 * block.offsets[geo.k])


# -- plain versions: the kernels' arithmetic in PyTorch, on CPU tensors --------

def write_plain(block: Block, e: int, y: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Element ``e`` into the slab: bf16(float(y) + bias), or bf16(y)."""
    v = y if bias is None else y.float() + bias
    o, f = block.offsets[e], block.widths[e]
    block.slab[..., o:o + f] = v.reshape(block.n, block.h, block.w, f).to(torch.bfloat16)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """The card's relu on either device: a NaN passes, and a zero of either
    sign gives +0 (on the CPU ``torch.relu`` keeps -0)."""
    return torch.where(x <= 0, 0.0, x)


def gather_plain(block: Block, geo: Geometry) -> torch.Tensor:
    """Conv j's input: relu([s_e, -s_e]) per element (or over the prefix,
    upsampled, for the up convs), and the border."""
    s = block.slab[..., :block.offsets[geo.k]]
    if geo.halves:
        s = nn_upsample(s, geo.factor) if geo.factor > 1 else s
        x = _relu(torch.cat([s, -s], dim=-1))
    else:
        parts = [s[..., block.offsets[e]:block.offsets[e + 1]] for e in range(geo.k)]
        x = _relu(torch.cat([t for p in parts for t in (p, -p)], dim=-1))
        x = nn_upsample(x, geo.factor) if geo.factor > 1 else x
    pt, pb, pl, pr = geo.pads
    return F.pad(x, (0, 0, pl, pr, pt, pb)) if geo.padded else x


def _halves(block: Block, geo: Geometry, g: torch.Tensor):
    """The gradient's relu(s) and relu(-s) channels, each in slab order."""
    kc = block.offsets[geo.k]
    if geo.halves:
        return g[..., :kc], g[..., kc:]
    pos, neg = [], []
    for e in range(geo.k):
        o, f = 2 * block.offsets[e], block.widths[e]
        pos.append(g[..., o:o + f])
        neg.append(g[..., o + f:o + 2 * f])
    return torch.cat(pos, dim=-1), torch.cat(neg, dim=-1)


def scatter_plain(block: Block, geo: Geometry, g: torch.Tensor, accs: Sequence,
                  store: Sequence[bool]) -> None:
    """d = bf16((s <= 0 ? 0 : g_pos) - (s >= 0 ? 0 : g_neg)), at factor 2
    the four of a pixel summed in float32 as ((0 + d00) + (0 + d01)) + (0 +
    d10)) + (0 + d11) and rounded; stored into or added to each element's
    float32 gradient (``accs[e]``, None: skipped)."""
    pt, _, pl, _ = geo.pads
    n, h, w, fh, fw = block.n, block.h, block.w, geo.factor * block.h, geo.factor * block.w
    gp, gn = _halves(block, geo, g[:, pt:pt + fh, pl:pl + fw].float())
    s = block.slab[..., :block.offsets[geo.k]].float()
    s = nn_upsample(s, geo.factor) if geo.factor > 1 else s
    d = (torch.where(s <= 0, 0.0, gp) - torch.where(s >= 0, 0.0, gn)).to(torch.bfloat16).float()
    if geo.factor > 1:
        d = d.reshape(n, h, 2, w, 2, -1)
        d = ((((0.0 + d[:, :, 0, :, 0]) + (0.0 + d[:, :, 0, :, 1])) + (0.0 + d[:, :, 1, :, 0]))
             + (0.0 + d[:, :, 1, :, 1])).to(torch.bfloat16).float()
    for e, acc in enumerate(accs):
        if acc is not None:
            part = d[..., block.offsets[e]:block.offsets[e + 1]]
            acc.copy_(part) if store[e] else acc.add_(part)


# -- the kernels ---------------------------------------------------------------

class _Geometry(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "h", "w", "slab_groups", "k_groups", "factor", "pt", "pl", "ho", "wo", "halves")]


class _Elements(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("off", ctypes.c_int * (MAX_ELEMS + 1))]


class _Accs(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p * MAX_ELEMS), ("store", ctypes.c_ulonglong)]


@functools.cache
def _bind():
    from otgan_tpu_torch.kernels.build import load

    lib = load("dense_boundary")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.otgan_dense_write.argtypes = [ptr, i, ptr, i, ptr, i, i, i, i, i, ptr]
    lib.otgan_dense_gather.argtypes = [ptr, ptr, ctypes.POINTER(_Geometry),
                                       ctypes.POINTER(_Elements), i, ptr]
    lib.otgan_dense_scatter.argtypes = [ptr, ptr, ctypes.POINTER(_Geometry),
                                        ctypes.POINTER(_Elements), ctypes.POINTER(_Accs), i, ptr]
    for fn in (lib.otgan_dense_write, lib.otgan_dense_gather, lib.otgan_dense_scatter):
        fn.restype = ctypes.c_int
    lib.otgan_dense_boundary_error_string.argtypes = [i]
    lib.otgan_dense_boundary_error_string.restype = ctypes.c_char_p
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


def _launch(name: str, *args) -> None:
    lib = _bind()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.otgan_dense_boundary_error_string(err).decode()}"
                           f" ({err})")
    launches["kernel"] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def runs(k: int) -> List[range]:
    """The launches of a gather or scatter over ``k`` elements: consecutive
    runs of at most ``MAX_ELEMS``."""
    return [range(e, min(e + MAX_ELEMS, k)) for e in range(0, k, MAX_ELEMS)]


def _structs(block: Block, geo: Geometry):
    """The geometry, and the elements of each launch (:func:`runs`)."""
    v = block.vec
    if not 1 <= geo.k <= len(block.widths):
        raise ValueError(f"the kernels take 1 to {len(block.widths)} elements, got {geo.k} of "
                         f"{block.widths}")
    _, ho, wo, c2 = _input_shape(block, geo)
    if block.n * ho * wo * c2 // v >= 2 ** 31:
        raise ValueError(f"a conv input of {block.n} x {ho} x {wo} x {c2} does not fit the "
                         "kernels' int")
    pt, _, pl, _ = geo.pads
    gs = _Geometry(block.n, block.h, block.w, block.offsets[-1] // v, block.offsets[geo.k] // v,
                   geo.factor, pt, pl, ho, wo, int(geo.halves))
    els = []
    for run in runs(geo.k):
        el = _Elements(len(run))
        for i in range(len(run) + 1):
            el.off[i] = block.offsets[run.start + i] // v
        els.append((run, el))
    return gs, els


def write_cuda(block: Block, e: int, y: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """The slab-write kernel: ``y`` a contiguous bf16 raw output with its
    float32 ``bias`` (over the channels, or a dense layer's whole row), or
    a float32 tensor alone; N x H x W x f_e values."""
    f = block.widths[e]
    if y.dtype not in (torch.bfloat16, torch.float32) or (y.dtype == torch.float32) != (
            bias is None):
        raise ValueError(f"write: y is bf16 with a float32 bias or float32 alone, got {y.dtype}"
                         f" and {'no bias' if bias is None else bias.dtype}")
    _check("write: y", y, y.dtype, device=block.slab.device)
    if y.numel() != block.n * block.h * block.w * f or y.shape[0] != block.n:
        raise ValueError(f"write: y {tuple(y.shape)} is not {block.n} x {block.h} x {block.w} x "
                         f"{f} values")
    bias_rows = 0
    if bias is not None:  # a dense layer's (N, H * W * f_e) has one a value of its row
        _check("write: bias", bias, torch.float32, (y.shape[1] if y.dim() == 2 else f,),
               y.device)
        bias_rows = bias.numel() // f
    with torch.cuda.device(y.device):
        _launch("otgan_dense_write", y.data_ptr(), int(y.dtype == torch.float32),
                None if bias is None else bias.data_ptr(), bias_rows, block.slab.data_ptr(),
                block.n * block.h * block.w, f, block.offsets[-1], block.offsets[e], block.vec,
                _stream(y.device))


def gather_cuda(block: Block, geo: Geometry) -> torch.Tensor:
    """The gather kernel: conv j's input, (N, Ho, Wo, 2K) bf16."""
    gs, els = _structs(block, geo)
    _check("gather: slab", block.slab, torch.bfloat16)
    dev = block.slab.device
    with torch.cuda.device(dev):
        x = torch.empty(_input_shape(block, geo), dtype=torch.bfloat16, device=dev)
        for _, el in els:
            _launch("otgan_dense_gather", block.slab.data_ptr(), x.data_ptr(), ctypes.byref(gs),
                    ctypes.byref(el), block.vec, _stream(dev))
    return x


def scatter_cuda(block: Block, geo: Geometry, g: torch.Tensor, accs: Sequence,
                 store: Sequence[bool]) -> None:
    """The scatter kernel: ``g`` conv j's input gradient, (N, Ho, Wo, 2K)
    bf16; ``accs[e]`` element e's float32 gradient (N, H, W, f_e), or None."""
    gs, els = _structs(block, geo)
    dev = block.slab.device
    _check("scatter: gradient", g, torch.bfloat16, _input_shape(block, geo), dev)
    if len(accs) != geo.k or len(store) != geo.k:
        raise ValueError(f"scatter: {len(accs)} gradients and {len(store)} flags for {geo.k} "
                         "elements")
    for e, acc in enumerate(accs):
        if acc is not None:
            _check(f"scatter: element {e}'s gradient", acc, torch.float32,
                   (block.n, block.h, block.w, block.widths[e]), dev)
    with torch.cuda.device(dev):
        for run, el in els:
            a = _Accs()
            for i, e in enumerate(run):
                if accs[e] is not None:
                    a.ptr[i] = accs[e].data_ptr()
                    a.store |= int(bool(store[e])) << i
            if any(accs[e] is not None for e in run):
                _launch("otgan_dense_scatter", g.data_ptr(), block.slab.data_ptr(),
                        ctypes.byref(gs), ctypes.byref(el), ctypes.byref(a), block.vec,
                        _stream(dev))


def _plain(t: torch.Tensor, what: str) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    launches["plain"] += 1
    return True


def _write(block, e, y, bias):
    (write_plain if _plain(block.slab, "write") else write_cuda)(block, e, y, bias)


def _gather(block, geo):
    return (gather_plain if _plain(block.slab, "gather") else gather_cuda)(block, geo)


def _scatter(block: Block, geo: Geometry, g: torch.Tensor, need: Sequence[bool]) -> None:
    """Conv j's input gradient into each element's that needs one: a store
    for its first consumer in the backward, an add for the later ones."""
    accs, store = [], []
    for e in range(geo.k):
        if not need[e]:
            accs.append(None)
            store.append(False)
            continue
        first = block.acc[e] is None
        if first:
            block.acc[e] = torch.empty((block.n, block.h, block.w, block.widths[e]),
                                       dtype=torch.float32, device=block.slab.device)
        accs.append(block.acc[e])
        store.append(first)
    if any(a is not None for a in accs):
        (scatter_plain if _plain(block.slab, "scatter") else scatter_cuda)(
            block, geo, g, accs, store)


class _Write(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, e, y, bias):
        _write(block, e, y.contiguous(), None if bias is None else bias.contiguous())
        ctx.block, ctx.e, ctx.y_shape, ctx.y_dtype = block, e, tuple(y.shape), y.dtype
        ctx.bias_shape = None if bias is None else tuple(bias.shape)
        # the element's place in the graph: its consumers' gathers take it
        return y.new_empty((0,))

    @staticmethod
    def backward(ctx, _):
        acc = ctx.block.acc[ctx.e]
        ctx.block.acc[ctx.e] = None
        if acc is None:  # no consumer asked for a gradient
            return None, None, None, None
        # the chain's own reductions on a tensor of the chain's layout
        a = acc.view(ctx.y_shape)
        gy = a.to(ctx.y_dtype) if ctx.needs_input_grad[2] else None
        gb = a.sum_to_size(ctx.bias_shape) if ctx.needs_input_grad[3] else None
        return None, None, gy, gb


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, geo, *tokens):
        ctx.block, ctx.geo = block, geo
        return _gather(block, geo)

    @staticmethod
    def backward(ctx, g):
        _scatter(ctx.block, ctx.geo, g.contiguous(), ctx.needs_input_grad[2:])
        return (None, None) + (None,) * ctx.geo.k


class _Regather:
    """What a conv keeps of its input: the gather, run again on unpack."""

    def __init__(self, block: Block, geo: Geometry, shape, stride, weight_grad: bool):
        self.block, self.geo, self.shape, self.stride = block, geo, shape, stride
        self.weight_grad = weight_grad

    def unpack(self) -> torch.Tensor:
        if not self.weight_grad:
            return _unread(self.shape, self.stride, self.block.slab.device)
        return _gather(self.block, self.geo).permute(0, 3, 1, 2)


def _unread(shape, stride, device) -> torch.Tensor:
    """The input a conv's backward gets where its weight needs no gradient:
    the data gradient reads the input's sizes and layout only, so its values
    are left unset (a card test fills them with NaN and finds every gradient
    unchanged)."""
    return torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=device)


def write(block: Block, e: int, y: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element ``e`` of ``block``: ``y`` a raw bf16 output (N, H, W, f_e) or a
    dense layer's (N, H * W * f_e) with its float32 ``bias``, or a float32
    tensor alone. Returns the element's token, which its consumers'
    gathers take: the edge autograd orders their backwards by. The block
    holds no token, so no reference cycle keeps a graph alive."""
    return _Write.apply(block, e, y, bias)


def list_conv(block: Block, tokens: Sequence, conv) -> torch.Tensor:
    """``conv`` (CReLU, bf16) on the block's first ``len(tokens)`` elements:
    its raw output before the bias, as ``conv.pre_bias`` gives it."""
    tracing.counts["dense_concat"] += 1
    k = len(tokens)
    geo = geometry(block, k, conv)
    if conv.V.shape[1] != 2 * block.offsets[k]:
        raise ValueError(f"a conv of {conv.V.shape[1]} input channels on {k} elements of "
                         f"{block.offsets[k]}")
    xin = _Gather.apply(block, geo, *tokens)
    if not xin.requires_grad:
        return conv.pre_bias(xin, padded=geo.padded)
    nchw = xin.permute(0, 3, 1, 2)
    weight_grad = any(p.requires_grad for p in conv.parameters())

    def pack(t):
        if (t.dtype == torch.bfloat16 and t.data_ptr() == xin.data_ptr()
                and t.shape == nchw.shape and t.stride() == nchw.stride()):
            return _Regather(block, geo, tuple(t.shape), t.stride(), weight_grad)
        return t

    def unpack(r):
        return r.unpack() if isinstance(r, _Regather) else r

    with saved_tensors_hooks(pack, unpack):
        return conv.pre_bias(xin, padded=geo.padded)


def dense_block(convs: Sequence, inputs: Sequence, transition, hw) -> torch.Tensor:
    """A dense block on slabs: ``inputs`` its first elements as ``(y,
    bias)`` pairs (see :func:`write`), ``convs`` its list convs, each on
    every element before it, and ``transition`` the conv on all of them;
    ``hw`` the block's pixels. Returns ``transition``'s raw output."""
    h, w = hw
    first = inputs[0][0]
    widths = [t.numel() // (t.shape[0] * h * w) for t, _ in inputs]
    block = Block(first, first.shape[0], h, w, widths + [c.V.shape[0] for c in convs])
    tokens = [write(block, e, y, bias) for e, (y, bias) in enumerate(inputs)]
    for conv in convs:
        tokens.append(write(block, len(tokens), list_conv(block, tokens, conv), conv.b))
    return list_conv(block, tokens, transition)
