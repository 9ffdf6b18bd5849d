"""Slice-grid PNGs of `predict --get_attention`: the input volume, its
saliency over it in the jet colormap, and the ground-truth mask over it.

Counterpart of `mst_tpu/utils/functions.py` (`minmax_norm`, the slice grid,
`tensor2image`, `overlay_mask`, `overlay_cam`), without matplotlib, which
the card's machine lacks: the colormaps are matplotlib's `gray` and `jet`
lookup tables built from their segment data by matplotlib's arithmetic
(`_segment_lut`, `_apply_cmap`), the 8-bit conversion is `plt.imsave`'s
(RGBA; a 2-D array normalised to its own min and max through `gray`, an
RGB array truncated from x * 255), and the PNG is written with numpy,
`zlib` and `struct` (`write_png`; `read_png` reads such a file back). The
decoded pixels equal those of the JAX writers' files.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

LUT_SIZE = 256  # matplotlib's default colormap size

# matplotlib's segment data (`matplotlib/_cm.py`): x, y below x, y above x
_GRAY = {c: ((0.0, 0, 0), (1.0, 1, 1)) for c in ("red", "green", "blue")}
_JET = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}


def _segment_lut(segments: dict, n: int = LUT_SIZE) -> np.ndarray:
    """[n, 4] f64 RGBA table of a linear-segmented colormap, as
    matplotlib's `_create_lookup_table` computes each channel (gamma 1)."""
    lut = np.ones((n, 4))
    for ch, name in enumerate(("red", "green", "blue")):
        a = np.array(segments[name], dtype=float)
        x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut[:, ch] = np.clip(np.concatenate(
            [[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
             [y0[-1]]]), 0.0, 1.0)
    return lut


GRAY_LUT = _segment_lut(_GRAY)
JET_LUT = _segment_lut(_JET)


def _apply_cmap(x: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Colormap `lut` at the floats `x` in [0, 1] -> x.shape + (4,), as a
    matplotlib `Colormap.__call__` indexes it (x * N truncated, x == 1 the
    last entry)."""
    xa = np.array(x, copy=True)
    n = len(lut)
    xa *= n
    xa[xa == n] = n - 1
    return lut.take(np.clip(xa.astype(int), 0, n - 1), axis=0)


def jet(x: np.ndarray) -> np.ndarray:
    """matplotlib's `cm.jet(x)` for floats x in [0, 1]: RGBA in f64."""
    return _apply_cmap(x, JET_LUT)


def minmax_norm(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Normalise each (batch, channel) slab to [0, 1]."""
    x = np.asarray(x, dtype=np.float32)
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    mn = flat.min(-1).reshape(*x.shape[:2], *([1] * (x.ndim - 2)))
    mx = flat.max(-1).reshape(*x.shape[:2], *([1] * (x.ndim - 2)))
    return (x - mn) / np.maximum(mx - mn, eps)


def _slice_grid(volume: np.ndarray, max_cols: int = 8) -> np.ndarray:
    """[D, H, W] -> the slices tiled row by row, `max_cols` a row."""
    d, h, w = volume.shape
    cols = min(max_cols, d)
    rows = (d + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w), volume.dtype)
    for i in range(d):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = volume[i]
    return grid


def tensor2image(volume: np.ndarray, path, max_cols: int = 8) -> None:
    """Save [B, C, D, H, W] (its first volume and channel) as a gray
    slice-grid PNG."""
    vol = minmax_norm(np.asarray(volume, np.float32))[0, 0]
    _save_gray(_slice_grid(vol, max_cols), path)


def overlay_mask(volume: np.ndarray, mask: np.ndarray, path,
                 color=(0.0, 1.0, 0.0), alpha: float = 0.4,
                 max_cols: int = 8) -> None:
    """Save the volume with a binary mask blended over it in `color`
    ([B, C, D, H, W] + [B, 1, D, H, W])."""
    vol = minmax_norm(np.asarray(volume, np.float32))[0, 0]
    m = np.asarray(mask).astype(bool)[0, 0]
    g = _slice_grid(vol, max_cols)
    gm = _slice_grid(m.astype(np.float32), max_cols) > 0.5
    rgb = np.stack([g, g, g], -1)
    for c in range(3):
        rgb[..., c] = np.where(
            gm, (1 - alpha) * rgb[..., c] + alpha * color[c], rgb[..., c])
    _save_rgb(rgb, path)


def overlay_cam(volume: np.ndarray, cam: np.ndarray, path,
                alpha: float = 0.5,
                clip_quantiles: Optional[tuple] = (0.995, 0.999),
                max_cols: int = 8) -> None:
    """Save the volume with the saliency `cam` blended over it in the jet
    colormap, the map first clipped to its [0.995, 0.999] quantiles
    (reference `main_predict.py:296`)."""
    vol = minmax_norm(np.asarray(volume, np.float32))[0, 0]
    c = np.asarray(cam, np.float32)
    c = c[0, 0] if c.ndim == 5 else (c[0] if c.ndim == 4 else c)
    if clip_quantiles is not None:
        lo, hi = (np.quantile(c, clip_quantiles[0]),
                  np.quantile(c, clip_quantiles[1]))
        c = np.clip(c, lo, hi)
    c = (c - c.min()) / max(c.max() - c.min(), 1e-8)
    g = _slice_grid(vol, max_cols)
    heat = jet(_slice_grid(c, max_cols))[..., :3]
    _save_rgb((1 - alpha) * np.stack([g, g, g], -1) + alpha * heat, path)


def _gray_rgba(img: np.ndarray) -> np.ndarray:
    """`plt.imsave(img, cmap="gray")`'s bytes: the image normalised to its
    own min and max (f64 limits, the image's dtype kept, as matplotlib's
    `Normalize`), through the gray table in 8 bits."""
    x = np.array(img, copy=True)
    vmin, vmax = np.float64(x.min()), np.float64(x.max())
    if vmin == vmax:
        x.fill(0)
    else:
        x -= vmin
        x /= (vmax - vmin)
    return _apply_cmap(x, (GRAY_LUT * 255).astype(np.uint8))


def _rgb_rgba(img: np.ndarray) -> np.ndarray:
    """`plt.imsave` of a float RGB array in [0, 1]: each channel x * 255
    truncated, alpha 255."""
    rgba = np.empty((*img.shape[:2], 4), img.dtype)
    rgba[..., :3] = img
    rgba[..., 3] = 1
    return (rgba * 255).astype(np.uint8)


def _save_gray(img: np.ndarray, path) -> None:
    write_png(path, _gray_rgba(np.clip(img, 0, 1)))


def _save_rgb(img: np.ndarray, path) -> None:
    write_png(path, _rgb_rgba(np.clip(img, 0, 1)))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, rgba: np.ndarray) -> None:
    """Write [H, W, 4] uint8 RGBA as an 8-bit RGBA PNG (no row filter; zlib
    level 1, the fastest: a slice grid of a [32, 224, 224] volume is 6.4 MB
    raw)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, _ = rgba.shape
    raw = np.zeros((h, 1 + 4 * w), np.uint8)  # filter byte 0 a row
    raw[:, 1:] = rgba.reshape(h, 4 * w)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
        + _chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Read back a PNG that `write_png` wrote -> [H, W, 4] uint8; checks
    the signature, every chunk's CRC and the rows' filter bytes."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    if (depth, color) != (8, 6):
        raise ValueError(f"{path}: not 8-bit RGBA")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return raw[:, 1:].reshape(h, w, 4).copy()
