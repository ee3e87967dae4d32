"""A PNG reader of the port's own, on zlib, struct and numpy alone, so that
the port reads CelebA's 64x64 crops without PIL.

It reads what an image dataset holds: 8-bit gray, gray with alpha, RGB and
RGBA, not interlaced, each scanline under any of the five filters (none,
Sub, Up, Average, Paeth; PNG spec section 9). Anything else (other bit
depths, a palette, Adam7 interlacing) raises with what it met.

`read_pngs` decodes the files of one shape and mode together: the
sequential Average and Paeth filters step once per pixel of one image,
each step across all the images, so a dataset of equal crops decodes at
about PIL's rate (PERF.md §5); `read_png` is one file of it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, at bit depth 8
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _pixels(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(m, stride) -> (stride / bpp, m, bpp), contiguous: pixel-major, so
    that each step of a left-to-right pass reads one block of memory."""
    m, stride = rows.shape
    return np.ascontiguousarray(rows.reshape(m, stride // bpp, bpp).transpose(1, 0, 2))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The scanlines of n images of one shape with each filter undone:
    raw (n, h, 1 + stride) uint8, each row's filter type first ->
    (n, h, stride) uint8. Rows are undone top to bottom, each across all n
    images at once; Average and Paeth, which read the bytes just made,
    pixel by pixel across the images and channels."""
    n, h, stride = raw.shape[0], raw.shape[1], raw.shape[2] - 1
    out = np.empty((n, h, stride), dtype=np.uint8)
    prior = np.zeros((n, stride), dtype=np.int16)
    for y in range(h):
        kind = raw[:, y, 0]
        if (kind > 4).any():
            raise ValueError(f"PNG scanline {y} has filter type {kind.max()}, not 0-4")
        row = raw[:, y, 1:].astype(np.int16)
        # Sub: a running sum per channel, mod 256; Up: the row above added
        sub, up = kind == 1, kind == 2
        row[sub] = np.cumsum(row[sub].reshape(-1, stride // bpp, bpp), axis=1).reshape(
            -1, stride) % 256
        row[up] += prior[up]
        # Average and Paeth: a the byte to the left (just made), b above,
        # c above-left
        av, pt = np.flatnonzero(kind == 3), np.flatnonzero(kind == 4)
        if len(av) or len(pt):
            fa, ba = _pixels(row[av], bpp), _pixels(prior[av], bpp)
            fp, bp = _pixels(row[pt], bpp), _pixels(prior[pt], bpp)
            a_av = np.zeros((len(av), bpp), dtype=np.int16)
            a = c = np.zeros((len(pt), bpp), dtype=np.int16)
            for i in range(stride // bpp):
                a_av = fa[i] = (fa[i] + ((a_av + ba[i]) >> 1)) & 0xFF
                b = bp[i]
                pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
                pred = np.where(pb <= pc, b, c)
                np.copyto(pred, a, where=(pa <= pb) & (pa <= pc))
                a = fp[i] = (fp[i] + pred) & 0xFF
                c = b
            row[av] = fa.transpose(1, 0, 2).reshape(len(av), stride)
            row[pt] = fp.transpose(1, 0, 2).reshape(len(pt), stride)
        row &= 0xFF
        out[:, y] = prior = row
    return out


def _scanlines(path: str):
    """(h, w, channels, the scanlines' bytes) of the PNG file `path`."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: {_COLOR_NAMES.get(color, f'color type {color}')} PNG; "
                         "this reader takes 8-bit gray, gray+alpha, RGB and RGBA")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit {_COLOR_NAMES[color]} PNG; this reader takes "
                         "8 bits a channel")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG; this reader takes non-interlaced files")
    if compression or filter_method:
        raise ValueError(f"{path}: compression method {compression}, filter method "
                         f"{filter_method}; PNG defines only 0")
    c = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * c + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of scanlines for {h} rows of {w * c + 1}")
    return h, w, c, raw


def read_pngs(paths) -> list:
    """The images of the PNG files `paths`, in order, each as `read_png`
    gives it. Files of one shape and mode are decoded together, so a
    dataset of equal crops costs a Python loop over one image's pixels."""
    groups, out = {}, [None] * len(paths)
    for j, path in enumerate(paths):
        h, w, c, raw = _scanlines(path)
        groups.setdefault((h, w, c), []).append((j, raw))
    for (h, w, c), items in groups.items():
        raw = np.frombuffer(b"".join(r for _, r in items), dtype=np.uint8)
        imgs = _unfilter(raw.reshape(len(items), h, w * c + 1), c)
        for (j, _), img in zip(items, imgs):
            out[j] = img.reshape(h, w) if c == 1 else img.reshape(h, w, c)
    return out


def read_png(path: str) -> np.ndarray:
    """The image of the PNG file `path` as uint8: (H, W) gray, (H, W, 2)
    gray with alpha, (H, W, 3) RGB or (H, W, 4) RGBA."""
    return read_pngs([path])[0]
