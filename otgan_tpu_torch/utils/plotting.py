"""Sample grids (counterpart of ``otgan_tpu/utils/plotting.py``, after the
reference's ``utils/plotting.py``): ``img_tile`` assembles a grid with
border and aspect control (``:29-74``), and ``save_tile_img`` writes [-1, 1]
floats as a PNG (``:9-13``).

The JAX package writes the PNG with PIL; the machines with the card have no
PIL, so the port encodes it itself with ``zlib`` and ``struct`` from the
standard library: 8-bit grey or RGB, one IDAT chunk, filter 0 on every row.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def img_stretch(img: np.ndarray) -> np.ndarray:
    """Min-max stretch to [0, 1] (``utils/plotting.py:23-27``)."""
    img = np.asarray(img, np.float64)
    img = img - img.min()
    return img / (img.max() + 1e-12)


def img_tile(
    imgs: np.ndarray,
    aspect_ratio: float = 1.0,
    tile_shape: Optional[Tuple[int, int]] = None,
    border: int = 1,
    border_color: float = 0.0,
    stretch: bool = False,
) -> np.ndarray:
    """Tile ``(N, H, W[, C])`` images into one grid image: a near-square grid
    from ``aspect_ratio``, ``border`` pixels of ``border_color`` between
    cells, trailing cells left as border colour."""
    if stretch:
        imgs = img_stretch(imgs)
    imgs = np.asarray(imgs)
    if imgs.ndim not in (3, 4):
        raise ValueError("imgs must be (N,H,W) or (N,H,W,C)")
    n, h, w = imgs.shape[:3]

    if tile_shape is None:
        img_aspect = w / float(h)
        ar = aspect_ratio * img_aspect
        th = int(math.ceil(math.sqrt(n * ar)))
        tw = int(math.ceil(math.sqrt(n / ar)))
    else:
        th, tw = tile_shape

    cells = th * tw
    chan = imgs.shape[3:]  # () or (C,)
    padded = np.full((cells, h + border, w + border) + chan, border_color, imgs.dtype)
    take = min(n, cells)
    padded[:take, :h, :w] = imgs[:take]
    grid = (
        padded.reshape((th, tw, h + border, w + border) + chan)
        .swapaxes(1, 2)
        .reshape((th * (h + border), tw * (w + border)) + chan)
    )
    # drop the trailing border row/col (reference grid is (H+b)*th - b)
    return grid[: th * (h + border) - border, : tw * (w + border) - border]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 ``(H, W)`` grey or ``(H, W, 3)`` RGB -> the bytes of a PNG."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError(f"expected uint8 (H, W) or (H, W, 3), got {pixels.dtype} "
                         f"{pixels.shape}")
    h, w = pixels.shape[:2]
    color_type = 0 if pixels.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, -1)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_tile_img(imgs: np.ndarray, path: str) -> None:
    """[-1, 1] float grid -> uint8 PNG (``utils/plotting.py:9-13``)."""
    arr = ((np.asarray(imgs) + 1.0) * 127.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
