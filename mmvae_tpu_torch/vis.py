"""Sample grids (mmvae_tpu/vis.py:16-66; reference vis.py:194-204).

The PNG writer uses zlib and struct from the standard library: 8-bit gray
for one channel, 8-bit RGB for three, the grid clamped to [0, 1] and cast
as (grid * 255).astype(uint8), as the JAX package's PIL path does.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Sequence

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """torchvision.utils.make_grid on NCHW float arrays: `nrow` images per
    row, `padding` zero pixels around each."""
    images = np.asarray(images)
    n, c, h, w = images.shape
    ncol = nrow
    nr = math.ceil(n / ncol)
    grid = np.zeros((c, nr * (h + padding) + padding, ncol * (w + padding) + padding),
                    dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[:, y: y + h, x: x + w] = images[i]
    return grid


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(arr: np.ndarray, path: str) -> None:
    """An (H, W) gray or (H, W, 3) RGB uint8 array as a PNG file."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2  # gray, RGB
    # each scanline starts with filter type 0 (none)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def save_image(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """Clamp to [0, 1], tile, write a PNG (torchvision save_image semantics)."""
    grid = make_grid(np.clip(np.asarray(images, np.float32), 0, 1), nrow)
    arr = (grid * 255).astype(np.uint8)
    if arr.shape[0] == 1:
        write_png(arr[0], path)
    elif arr.shape[0] == 3:
        write_png(np.transpose(arr, (1, 2, 0)), path)
    else:
        raise ValueError(f"a PNG grid takes 1 or 3 channels, not {arr.shape[0]}")


def adjust_shape(a: np.ndarray, b: np.ndarray):
    """Pad channels and spatial dims so that two modality batches stack in
    one grid (utils.py:324-360)."""
    a, b = np.asarray(a), np.asarray(b)
    c = max(a.shape[1], b.shape[1])
    h = max(a.shape[2], b.shape[2])
    w = max(a.shape[3], b.shape[3])

    def fix(x):
        if x.shape[1] < c:
            x = np.concatenate([x] + [np.zeros_like(x[:, :1])] * (c - x.shape[1]), 1)
        ph, pw = h - x.shape[2], w - x.shape[3]
        return np.pad(x, ((0, 0), (0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)))

    return fix(a), fix(b)


def save_samples(data: Sequence[np.ndarray], path: str, nrow: int = 8) -> None:
    """Two-modality sample grid (vis.py:194-204)."""
    a, b = adjust_shape(np.asarray(data[0]), np.asarray(data[1]))
    save_image(np.concatenate([a, b]), path, nrow=nrow)
