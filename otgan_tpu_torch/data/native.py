"""ctypes bindings of the host batch assembler (counterpart of
``otgan_tpu/data/native.py``).

``csrc/otgan_host.cpp`` is built with ``g++`` at first use
(``kernels/build.py::build_host``, into ``_build/``) and loaded once per
process. A host without ``g++``, or where the build fails, takes the numpy
path, which computes the same bytes, and says so in one printed line;
:func:`native_available` says which path this process took.

:func:`assemble_batch_u8` fuses gather, horizontal flip and the uint8 ->
``[-1, 1]`` conversion over an NHWC uint8 dataset: ``out_dtype`` float32
(a numpy array), uint8 (gather and flip only; a numpy array) or bfloat16,
which comes out as the C function's uint16 bit patterns viewed as a CPU
``torch.bfloat16`` tensor (numpy has no bfloat16). The C call releases the
interpreter lock, so a prefetch thread assembling here runs beside the
thread that launches the steps. :func:`nchw_to_nhwc_u8` is the dataset's
one-pass transpose. :func:`assemble_batch_numpy` is the numpy path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Union

import numpy as np
import torch

from otgan_tpu_torch.kernels import build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False

_ASSEMBLE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]


def _bind(lib: ctypes.CDLL) -> None:
    """Type every entry point; ``AttributeError`` when the library lacks
    one (a stale or foreign file at the library's path)."""
    for name in ("otgan_assemble_batch_u8", "otgan_assemble_batch_u8_bf16",
                 "otgan_assemble_batch_u8_raw"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _ASSEMBLE_ARGS, None
    lib.otgan_nchw_to_nhwc_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.otgan_nchw_to_nhwc_u8.restype = None


def _open_fresh(path: str) -> ctypes.CDLL:
    """Load a just-rebuilt library through a unique alias: ``dlopen`` hands
    back the mapping it already has for a path name, stale or not."""
    alias = f"{path}.reload{os.getpid()}"
    shutil.copy2(path, alias)
    try:
        lib = ctypes.CDLL(alias)
    finally:
        os.remove(alias)  # the mapping outlives the name
    _bind(lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = build.build_host()
            lib = ctypes.CDLL(path)
            try:
                _bind(lib)
            except AttributeError:
                # a library at the hashed path that lacks a symbol (copied
                # over, truncated): build it once more rather than give up
                lib = _open_fresh(build.build_host(force=True))
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:  # no g++, or it failed
            print(f"otgan_host native build unavailable ({e}); using numpy", flush=True)
            _build_failed = True
    return _lib


def native_available() -> bool:
    """Whether this process assembles batches in the native library (False:
    the numpy path)."""
    return _load() is not None


def _as_bf16(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> a CPU bfloat16 tensor (no copy)."""
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _check(data_u8: np.ndarray, indices: np.ndarray, flip_mask: Optional[np.ndarray],
           out_dtype: str):
    if data_u8.dtype != np.uint8 or data_u8.ndim != 4:
        raise ValueError(f"expected uint8 NHWC images, got {data_u8.dtype} {data_u8.shape}")
    if out_dtype not in ("float32", "bfloat16", "uint8"):
        raise ValueError(f"out_dtype must be float32, bfloat16 or uint8, got {out_dtype!r}")
    n = data_u8.shape[0]
    indices = np.ascontiguousarray(indices, np.int64)
    if indices.ndim != 1 or (indices.size and (indices.min() < 0 or indices.max() >= n)):
        raise ValueError(f"indices must be a 1-D array in [0, {n})")
    if flip_mask is not None:
        flip_mask = np.ascontiguousarray(flip_mask, np.uint8)
        if flip_mask.shape != indices.shape:
            raise ValueError(f"flip_mask must have shape {indices.shape}, got {flip_mask.shape}")
    return indices, flip_mask


def assemble_batch_numpy(data_u8: np.ndarray, indices: np.ndarray,
                         flip_mask: Optional[np.ndarray],
                         out_dtype: str = "float32") -> Union[np.ndarray, torch.Tensor]:
    """:func:`assemble_batch_u8` in numpy: the same bytes, on one thread
    and holding the interpreter lock."""
    indices, flip_mask = _check(data_u8, indices, flip_mask, out_dtype)
    x = data_u8[indices]
    if out_dtype != "uint8":
        x = x.astype(np.float32) / 127.5 - 1.0
    if flip_mask is not None:
        m = flip_mask.astype(bool)
        x[m] = x[m, :, ::-1, :]
    if out_dtype == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16)  # round to nearest even
    return x


def assemble_batch_u8(data_u8: np.ndarray, indices: np.ndarray,
                      flip_mask: Optional[np.ndarray], n_threads: int = 0,
                      out_dtype: str = "float32") -> Union[np.ndarray, torch.Tensor]:
    """``data_u8[indices]`` (NHWC uint8), the images with a nonzero
    ``flip_mask`` flipped along W, as ``out_dtype``: ``"float32"`` (``x /
    127.5 - 1``), ``"bfloat16"`` (the float32 values rounded to nearest
    even; a torch tensor) or ``"uint8"`` (no conversion). ``n_threads <= 0``
    uses every core. Without the library: :func:`assemble_batch_numpy`."""
    lib = _load()
    if lib is None:
        return assemble_batch_numpy(data_u8, indices, flip_mask, out_dtype)
    indices, flip_mask = _check(data_u8, indices, flip_mask, out_dtype)
    batch, (_, h, w, c) = indices.shape[0], data_u8.shape
    data_u8 = np.ascontiguousarray(data_u8)
    out = np.empty((batch, h, w, c), {"float32": np.float32, "bfloat16": np.uint16,
                                      "uint8": np.uint8}[out_dtype])
    fn = {"float32": lib.otgan_assemble_batch_u8, "bfloat16": lib.otgan_assemble_batch_u8_bf16,
          "uint8": lib.otgan_assemble_batch_u8_raw}[out_dtype]
    fn(data_u8.ctypes.data, indices.ctypes.data,
       flip_mask.ctypes.data if flip_mask is not None else None,
       batch, h, w, c, out.ctypes.data, n_threads)
    return _as_bf16(out) if out_dtype == "bfloat16" else out


def nchw_to_nhwc_u8(src: np.ndarray) -> np.ndarray:
    """``(n, c, h, w)`` uint8 -> ``(n, h, w, c)`` uint8, contiguous."""
    if src.dtype != np.uint8 or src.ndim != 4:
        raise ValueError(f"expected uint8 NCHW images, got {src.dtype} {src.shape}")
    n, c, h, w = src.shape
    lib = _load()
    if lib is not None:
        src = np.ascontiguousarray(src)
        out = np.empty((n, h, w, c), np.uint8)
        lib.otgan_nchw_to_nhwc_u8(src.ctypes.data, n, c, h, w, out.ctypes.data)
        return out
    return np.ascontiguousarray(np.transpose(src, (0, 2, 3, 1)))
