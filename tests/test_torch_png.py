"""The port's PNG reader (mmvae_tpu_torch/data/png.py), which reads CelebA
without PIL, against PIL: PIL-written files of each mode it takes (gray,
gray+alpha, RGB, RGBA), files whose scanlines carry each of the five
filters, files of several shapes and filter sequences decoded together
(`read_pngs`), the port's own writer's files, and the refusals (16-bit,
palette, interlaced, a broken CRC)."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from mmvae_tpu_torch.data.png import read_png, read_pngs
from mmvae_tpu_torch.vis import write_png

MODES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}
COLOR_TYPES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}


def _image(mode, h=29, w=33, seed=0):
    """A ramp with noise, so that PIL's adaptive filtering picks several
    filters across the rows."""
    rng = np.random.default_rng(seed)
    shape = (h, w) + MODES[mode]
    ramp = np.add.outer(np.arange(h), np.arange(w)) * 3
    ramp = ramp.reshape(ramp.shape + (1,) * len(MODES[mode]))
    return ((ramp + rng.integers(0, 40, size=shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pil_written_files(mode, tmp_path):
    img = _image(mode)
    path = tmp_path / f"{mode}.png"
    Image.fromarray(img, mode).save(path)
    got = read_png(str(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == np.uint8


def _filtered(img, kinds, bpp):
    """The scanlines of `img` (h, stride) under the given filter per row
    (PNG spec section 9.2), each row's type byte first."""
    h, stride = img.shape
    rows, prior = [], np.zeros(stride, np.int64)
    for y in range(h):
        cur = img[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        kind = kinds[y % len(kinds)]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(rows)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png(w, h, depth, color, raw, interlace=0):
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_each_filter(mode, kinds, tmp_path):
    img = _image(mode, seed=1)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    path = tmp_path / "f.png"
    path.write_bytes(_png(w, h, 8, COLOR_TYPES[mode], _filtered(img.reshape(h, -1), kinds, bpp)))
    np.testing.assert_array_equal(read_png(str(path)), img)
    with Image.open(path) as im:  # the hand-made file is a valid PNG
        np.testing.assert_array_equal(np.asarray(im), img)


def test_files_decoded_together(tmp_path):
    """Files of one shape and mode decode in one pass (`read_pngs`), each row
    under its own filter: PIL-written RGB crops with adaptive filtering,
    hand-made files whose rows rotate through the five filters from
    different offsets, and files of other shapes and modes between them, in
    the order given."""
    paths, want = [], []
    for j in range(12):
        if j % 3 == 0:
            img = _image("RGB", h=64, w=64, seed=10 + j)
            path = tmp_path / f"pil{j}.png"
            Image.fromarray(img, "RGB").save(path)
        else:
            mode = "RGB" if j % 3 == 1 else ("L", "LA", "RGBA")[j % 9 // 3]
            img = _image(mode, h=64 if mode == "RGB" else 29, w=64 if mode == "RGB" else 33,
                         seed=10 + j)
            h, w = img.shape[:2]
            bpp = 1 if img.ndim == 2 else img.shape[2]
            kinds = tuple((k + j) % 5 for k in range(5))
            path = tmp_path / f"hand{j}.png"
            path.write_bytes(_png(w, h, 8, COLOR_TYPES[mode],
                                  _filtered(img.reshape(h, -1), kinds, bpp)))
        paths.append(str(path))
        want.append(img)
    got = read_pngs(paths)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        np.testing.assert_array_equal(g, w)
        with Image.open(path) as im:
            np.testing.assert_array_equal(g, np.asarray(im))


@pytest.mark.parametrize("shape", [(64, 64), (64, 64, 3)])
def test_the_ports_own_writer(shape, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    write_png(img, str(path))
    np.testing.assert_array_equal(read_png(str(path)), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


def test_refusals_name_what_they_met(tmp_path):
    img = _image("L", h=4, w=4)
    cases = {
        "16-bit": _png(4, 4, 16, 0, b"".join(b"\x00" + bytes(8) for _ in range(4))),
        "palette": _png(4, 4, 8, 3, b"".join(b"\x00" + bytes(4) for _ in range(4))),
        "interlaced": _png(4, 4, 8, 0, _filtered(img, (0,), 1), interlace=1),
    }
    for what, data in cases.items():
        path = tmp_path / f"{what}.png"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=what.replace("-", ".").split()[0]):
            read_png(str(path))
    good = _png(4, 4, 8, 0, _filtered(img, (0,), 1))
    broken = good[:40] + bytes([good[40] ^ 1]) + good[41:]
    (tmp_path / "crc.png").write_bytes(broken)
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(tmp_path / "crc.png"))
    bad_filter = _png(4, 4, 8, 0, b"".join(b"\x05" + bytes(4) for _ in range(4)))
    (tmp_path / "filter.png").write_bytes(bad_filter)
    with pytest.raises(ValueError, match="filter type 5"):
        read_png(str(tmp_path / "filter.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "not.png"))
