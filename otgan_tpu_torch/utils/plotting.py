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


def plot_img(img: np.ndarray, title: Optional[str] = None):
    """Single-image matplotlib display (``utils/plotting.py:15-21``);
    matplotlib is imported here only, so nothing else needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_img needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.figure()
    plt.imshow(img, interpolation="nearest")
    if title is not None:
        plt.title(title)
    plt.axis("off")
    plt.tight_layout()
    return plt.gcf()


def conv_filter_tile(filters: np.ndarray) -> np.ndarray:
    """Tile conv filters (N, C, H, W): RGB filters as colour tiles, otherwise
    one row per filter and one column per channel (``utils/plotting.py:76-89``)."""
    n_filters, n_channels, height, width = filters.shape
    tile_shape = None
    if n_channels == 3:
        filters = np.transpose(filters, (0, 2, 3, 1))
    else:
        tile_shape = (n_channels, n_filters)
        filters = np.transpose(filters, (1, 0, 2, 3)).reshape(
            n_filters * n_channels, height, width
        )
    return img_tile(img_stretch(filters), tile_shape=tile_shape)


def scale_to_unit_interval(ndar: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Min-max scale to [0, 1] (``utils/plotting.py:91-96``)."""
    ndar = np.asarray(ndar, np.float64).copy()
    ndar -= ndar.min()
    return ndar / (ndar.max() + eps)


def tile_raster_images(
    X,
    img_shape: Tuple[int, int],
    tile_shape: Tuple[int, int],
    tile_spacing: Tuple[int, int] = (0, 0),
    scale_rows_to_unit_interval: bool = True,
    output_pixel_vals: bool = True,
) -> np.ndarray:
    """Tile flattened rows as a raster grid (reference
    ``utils/plotting.py:99-201``): single-channel arrays, or 4-tuples of
    channels (``None`` for a default channel), rows optionally min-max
    scaled."""
    if isinstance(X, tuple):
        if len(X) != 4:
            raise ValueError(f"a tuple of channels must have 4 entries, got {len(X)}")
        h = (img_shape[0] + tile_spacing[0]) * tile_shape[0] - tile_spacing[0]
        w = (img_shape[1] + tile_spacing[1]) * tile_shape[1] - tile_spacing[1]
        out = np.zeros((h, w, 4), dtype="uint8" if output_pixel_vals else np.float64)
        defaults = [0, 0, 0, 255] if output_pixel_vals else [0.0, 0.0, 0.0, 1.0]
        for i in range(4):
            if X[i] is None:
                out[:, :, i] = defaults[i]
            else:
                out[:, :, i] = tile_raster_images(
                    X[i], img_shape, tile_shape, tile_spacing,
                    scale_rows_to_unit_interval, output_pixel_vals,
                )
        return out

    H, W = img_shape
    Hs, Ws = tile_spacing
    h = (H + Hs) * tile_shape[0] - Hs
    w = (W + Ws) * tile_shape[1] - Ws
    out = np.zeros((h, w), dtype="uint8" if output_pixel_vals else X.dtype)
    for r in range(tile_shape[0]):
        for c in range(tile_shape[1]):
            k = r * tile_shape[1] + c
            if k >= X.shape[0]:
                continue
            img = X[k].reshape(img_shape)
            if scale_rows_to_unit_interval:
                img = scale_to_unit_interval(img)
            out[r * (H + Hs): r * (H + Hs) + H, c * (W + Ws): c * (W + Ws) + W] = (
                img * (255 if output_pixel_vals else 1)
            )
    return out


# matplotlib's 'Oranges' colormap at its two ends: white-ish to dark orange
_ORANGES = (np.array([255.0, 245.0, 235.0]), np.array([127.0, 39.0, 4.0]))
KDE_GRID = 120  # grid points a side of each panel (the JAX package's)


def kde_density(samples: np.ndarray, xmax: float = 4.0, grid: int = KDE_GRID) -> np.ndarray:
    """A Gaussian KDE (scipy) of 2-D ``samples`` on a ``grid`` x ``grid``
    lattice of ``[-xmax, xmax]^2``, rows along y as ``np.meshgrid`` lays
    them out; all zeros for fully collapsed (singular) samples."""
    from scipy.stats import gaussian_kde

    axis = np.linspace(-xmax, xmax, grid)
    gx, gy = np.meshgrid(axis, axis)
    pts = np.stack([gx.ravel(), gy.ravel()])
    try:
        return gaussian_kde(np.asarray(samples, np.float64).T)(pts).reshape(gx.shape)
    except np.linalg.LinAlgError:  # fully collapsed samples
        return np.zeros_like(gx)


def kde_evolution_plot(snapshots, path: str, xmax: float = 4.0, levels: int = 20) -> None:
    """KDE evolution strip of 2-D toy samples, the notebooks' final artifact
    (``toy_example/med_gan_toy_example2.ipynb`` cell 2; the JAX package's
    ``kde_evolution_plot``): one panel per ``(step, samples)`` snapshot, the
    density of :func:`kde_density` filled in ``levels`` bands of the
    'Oranges' ramp, y up, 1-pixel white borders between panels. Written by
    :func:`encode_png`, so neither matplotlib nor PIL is needed; the step
    titles are not drawn."""
    snapshots = list(snapshots)
    panels = []
    for _, samples in snapshots:
        dens = kde_density(samples, xmax)
        top = dens.max()
        band = np.floor(dens / top * levels).clip(0, levels - 1) / (levels - 1) if top > 0 \
            else np.zeros_like(dens)
        rgb = _ORANGES[0] + band[..., None] * (_ORANGES[1] - _ORANGES[0])
        panels.append(np.flipud(rgb))  # row 0 at the top is y = xmax
    if not panels:
        panels = [np.full((KDE_GRID, KDE_GRID, 3), 255.0)]
    border = np.full((KDE_GRID, 1, 3), 255.0)
    strip = np.concatenate(sum(([p, border] for p in panels), [])[:-1], axis=1)
    with open(path, "wb") as f:
        f.write(encode_png(np.rint(strip).astype(np.uint8)))
