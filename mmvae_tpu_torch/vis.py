"""Sample grids (mmvae_tpu/vis.py:16-66; reference vis.py:194-204), line
plots, histograms, scatter panels and the circles' radius estimate.

The PNG writer uses zlib and struct from the standard library: 8-bit gray
for one channel, 8-bit RGB for three, the grid clamped to [0, 1] and cast
as (grid * 255).astype(uint8), as the JAX package's PIL path does.

The line plots, histograms and scatter panels stand in for the JAX
package's matplotlib figures (PRD curves, plot_results, the circles' radius
histograms and product-of-posteriors figure, the UMAP embeddings of the
latents and of the DCCA features): the same series on the same axes, drawn
without text or font. The series, bins, labels, limits and
legend order go beside each PNG as <out>.json.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Sequence

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# line plots (the JAX package draws these with matplotlib)
# ---------------------------------------------------------------------------

# matplotlib's default color cycle ("tab10")
PALETTE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
           (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))


def _data_range(values, pad: float = 0.05):
    v = np.asarray([x for x in values if np.isfinite(x)], dtype=np.float64)
    if v.size == 0:
        return 0.0, 1.0
    lo, hi = float(v.min()), float(v.max())
    span = hi - lo if hi > lo else max(abs(lo), 1.0)
    return lo - pad * span, hi + pad * span


class _Canvas:
    """An RGB raster with a plot box: data coordinates map linearly into the
    box, y upwards."""

    def __init__(self, width, height, xlim, ylim, margin=24):
        self.img = np.full((height, width, 3), 255, np.uint8)
        self.x0, self.y0 = margin, margin
        self.w, self.h = width - 2 * margin, height - 2 * margin
        self.xlim, self.ylim = xlim, ylim

    def to_px(self, x, y):
        (a, b), (c, d) = self.xlim, self.ylim
        px = self.x0 + (np.asarray(x, np.float64) - a) / (b - a) * self.w
        py = self.y0 + (1.0 - (np.asarray(y, np.float64) - c) / (d - c)) * self.h
        return px, py

    def dots(self, px, py, color, radius=1):
        """Set every pixel within `radius` (a square) of each point."""
        px, py = np.rint(px).astype(np.int64), np.rint(py).astype(np.int64)
        hgt, wid = self.img.shape[:2]
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                x, y = px + dx, py + dy
                ok = (x >= 0) & (x < wid) & (y >= 0) & (y < hgt)
                self.img[y[ok], x[ok]] = color

    def segments(self, p, q, color, dash=0, radius=1):
        """Lines from points p to points q (pixel coordinates, (n, 2) each);
        with `dash`, on for `dash` pixels of length, then off as long."""
        p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
        ok = np.isfinite(p).all(1) & np.isfinite(q).all(1)
        p, q = p[ok], q[ok]
        if not len(p):
            return
        length = np.hypot(*(q - p).T)
        n = np.ceil(2 * length).astype(np.int64) + 1
        seg = np.repeat(np.arange(len(p)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(np.maximum(n - 1, 1), n)
        pts = p[seg] + t[:, None] * (q - p)[seg]
        if dash:
            along = np.concatenate([[0.0], np.cumsum(length)])[seg] + t * length[seg]
            keep = (along // dash) % 2 == 0
            pts = pts[keep]
        self.dots(pts[:, 0], pts[:, 1], color, radius)

    def frame(self):
        """The plot box in black, with 5 ticks on each axis."""
        x0, y0, x1, y1 = self.x0, self.y0, self.x0 + self.w, self.y0 + self.h
        corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)
        self.segments(corners, np.roll(corners, -1, 0), (0, 0, 0), radius=0)
        ticks = np.linspace(0, 1, 5)
        xs, ys = x0 + ticks * self.w, y0 + ticks * self.h
        self.segments(np.c_[xs, np.full(5, y1)], np.c_[xs, np.full(5, y1 + 4)], (0, 0, 0), radius=0)
        self.segments(np.c_[np.full(5, x0 - 4), ys], np.c_[np.full(5, x0), ys], (0, 0, 0), radius=0)


def line_plot(series, out_path: str, xlim=None, ylim=None, xlabel: str = "", ylabel: str = "",
              xticklabels=None):
    """A 480x360 line figure as a PNG, without text: axes box with ticks, one
    polyline per series in matplotlib's color cycle, optional error bars and
    markers. Each series is a dict with "label", "x", "y" and optionally
    "yerr", "dashed" and "marker". `xlim`/`ylim` default to the data's range
    padded by 5 %. What text would say goes beside the PNG as
    <out_path>.json (so that plot.png never replaces a run's plot.json):
    the limits, the axis labels (and `xticklabels`, the names of the points
    at x = 0, 1, ...), every series with its color, and the legend order.
    Returns that dict."""
    import json
    import os

    series = list(series)
    xs = [v for s in series for v in np.asarray(s["x"], np.float64).ravel()]
    ys = []
    for s in series:
        y = np.asarray(s["y"], np.float64).ravel()
        err = np.asarray(s.get("yerr", np.zeros_like(y)), np.float64).ravel()
        ys += list(y - err) + list(y + err)
    xlim = tuple(xlim) if xlim is not None else _data_range(xs)
    ylim = tuple(ylim) if ylim is not None else _data_range(ys)
    canvas = _Canvas(480, 360, xlim, ylim)
    canvas.frame()
    spec = {"png": os.path.basename(out_path), "xlim": list(xlim), "ylim": list(ylim),
            "xlabel": xlabel, "ylabel": ylabel, "xticklabels": xticklabels, "series": [],
            "legend": [s["label"] for s in series]}
    for i, s in enumerate(series):
        color = PALETTE[i % len(PALETTE)]
        x = np.asarray(s["x"], np.float64).ravel()
        y = np.asarray(s["y"], np.float64).ravel()
        px, py = canvas.to_px(x, y)
        pts = np.c_[px, py]
        canvas.segments(pts[:-1], pts[1:], color, dash=8 if s.get("dashed") else 0)
        if s.get("marker"):
            canvas.dots(px, py, color, radius=3)
        entry = {"label": s["label"], "color": "#%02x%02x%02x" % color, "x": x.tolist(),
                 "y": y.tolist(), "dashed": bool(s.get("dashed", False))}
        if "yerr" in s:
            err = np.asarray(s["yerr"], np.float64).ravel()
            _, lo = canvas.to_px(x, y - err)
            _, hi = canvas.to_px(x, y + err)
            canvas.segments(np.c_[px, lo], np.c_[px, hi], color, radius=0)
            for end in (lo, hi):  # caps
                canvas.segments(np.c_[px - 4, end], np.c_[px + 4, end], color, radius=0)
            entry["yerr"] = err.tolist()
        spec["series"].append(entry)
    write_png(canvas.img, out_path)
    with open(out_path + ".json", "w") as f:
        json.dump(spec, f)
    return spec


def plot_hist(values, path: str, bins: int = 30):
    """A histogram of `values` as a text-free 480x360 PNG (the JAX package's
    matplotlib `ax.hist(values, bins=30)`, vis.py:137-147): `bins` equal
    bins over the values' range, bars in the first palette color. Beside it,
    <path>.json holds the bin edges, the counts and the limits. Returns
    that dict."""
    import json
    import os

    values = np.asarray(values, np.float64).ravel()
    counts, edges = np.histogram(values, bins=bins)
    xlim = (float(edges[0]), float(edges[-1])) if edges[-1] > edges[0] else (edges[0] - 0.5,
                                                                            edges[0] + 0.5)
    ylim = (0.0, 1.05 * max(int(counts.max()), 1))
    canvas = _Canvas(480, 360, xlim, ylim)
    for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
        (x0, x1), (y0, y1) = canvas.to_px([lo, hi], [0.0, c])
        ys, ye = int(np.rint(min(y0, y1))), int(np.rint(max(y0, y1)))
        xs, xe = int(np.rint(x0)), max(int(np.rint(x1)) - 1, int(np.rint(x0)))
        canvas.img[ys: ye + 1, xs: xe + 1] = PALETTE[0]
    canvas.frame()
    spec = {"png": os.path.basename(path), "bins": edges.tolist(), "counts": counts.tolist(),
            "xlim": list(map(float, xlim)), "ylim": list(ylim), "n": int(values.size),
            "min": float(values.min()), "max": float(values.max())}
    write_png(canvas.img, path)
    with open(path + ".json", "w") as f:
        json.dump(spec, f)
    return spec


def scatter_panels(panels, path: str, panel_size: int = 240):
    """Rows of 2-D scatter panels with shared axes as one text-free PNG (the
    JAX package's matplotlib `subplots(..., sharex=True, sharey=True)` of
    `scatter`s). `panels[r][c]` is a list of series, each a dict with
    "label" and "points" ((n, 2)); a series' color is its index in its panel
    (matplotlib's color cycle). Beside it, <path>.json holds the limits, the
    legend of each panel and its points. Returns that dict."""
    import json
    import os

    pts = np.concatenate([np.asarray(s["points"], np.float64).reshape(-1, 2)
                          for row in panels for panel in row for s in panel])
    xlim, ylim = _data_range(pts[:, 0]), _data_range(pts[:, 1])
    n_rows, n_cols = len(panels), max(len(row) for row in panels)
    img = np.full((n_rows * panel_size, n_cols * panel_size, 3), 255, np.uint8)
    spec = {"png": os.path.basename(path), "xlim": list(xlim), "ylim": list(ylim), "panels": []}
    for r, row in enumerate(panels):
        spec_row = []
        for c, panel in enumerate(row):
            canvas = _Canvas(panel_size, panel_size, xlim, ylim, margin=12)
            canvas.frame()
            entries = []
            for i, s in enumerate(panel):
                p = np.asarray(s["points"], np.float64).reshape(-1, 2)
                color = PALETTE[i % len(PALETTE)]
                canvas.dots(*canvas.to_px(p[:, 0], p[:, 1]), color, radius=1)
                entries.append({"label": s["label"], "color": "#%02x%02x%02x" % color,
                                "points": p.tolist()})
            img[r * panel_size:(r + 1) * panel_size, c * panel_size:(c + 1) * panel_size] = \
                canvas.img
            spec_row.append({"legend": [s["label"] for s in panel], "series": entries})
        spec["panels"].append(spec_row)
    write_png(img, path)
    with open(path + ".json", "w") as f:
        json.dump(spec, f)
    return spec


def _class_series(z, classes):
    """The points of `z` (n, 2) as one series per class value, in sorted
    order (the color of class i is the i-th of the color cycle, tab10's for
    the labels 0-9), or one series where there are no classes."""
    z = np.asarray(z, np.float64).reshape(len(z), -1)
    if classes is None:
        return [{"label": "points", "points": z}]
    classes = np.asarray(classes).reshape(len(z))
    return [{"label": c.item(), "points": z[classes == c]} for c in np.unique(classes)]


def reduce_latents(z, dim: int = 2, method: str = "umap", device="cuda") -> np.ndarray:
    """A `dim`-D embedding for latent scatter plots (mmvae_tpu/vis.py:69;
    the reference reduces with umap.UMAP, multi_vaes.py:143-146): the
    in-repo UMAP (embed.py, its layout on `device`), or method "pca", the
    principal components in float64 with scikit-learn's signs (each
    component's largest entry positive, PCA's svd_flip). Latents of `dim`
    or fewer dimensions pass through unchanged."""
    z = np.asarray(z)
    if z.shape[1] <= dim:
        return z
    if method == "pca":
        x = torch.as_tensor(z, dtype=torch.float64, device=device)
        xc = x - x.mean(0)
        _, _, vt = torch.linalg.svd(xc, full_matrices=False)
        vt = vt[:dim]
        signs = torch.sign(vt.gather(1, vt.abs().argmax(1, keepdim=True)))
        return (xc @ (vt * signs).T).cpu().numpy()
    from .embed import UMAP

    return UMAP(n_components=dim, device=device).fit_transform(z)


def visualize_umap(z, classes, save_file=None, device="cuda"):
    """The DCCA-embedding scatter (mmvae_tpu/vis.py:85; the reference's
    dcca/utils.py:113-122): latents of more than 2 dimensions reduced by the
    in-repo UMAP, colored by class, as one text-free PNG with <save_file>.json
    beside it (`scatter_panels`). The JAX package takes scikit-learn's TSNE
    where it is importable and this UMAP where it is not; the port, whose
    card has no scikit-learn, always takes the UMAP. Returns the 2-D points."""
    z = np.asarray(z).reshape(len(z), -1)
    z_embed = z
    if z.shape[1] > 2:
        from .embed import UMAP

        z_embed = UMAP(device=device).fit_transform(z)
        print("visualize_umap: reduced with umap")
    if save_file is not None:
        scatter_panels([[_class_series(z_embed, classes)]], save_file)
    return z_embed


def plot_embeddings_colorbars(zxy, zx, classes0, classes1, path: str):
    """The joint and the unimodal embeddings side by side, each colored by
    its classes (mmvae_tpu/vis.py:120; the reference's vis.py:38-101), as
    one text-free PNG of two panels with <path>.json beside it; the
    colorbars' classes are the legend of each panel there."""
    return scatter_panels([[_class_series(zxy, classes0), _class_series(zx, classes1)]], path)


def extract_rayon(images) -> np.ndarray:
    """The radius of a rasterized circle or ring: the largest distance from
    the centre, on the [-1, 1] grid, of a pixel above 0.5 in the first
    channel, 0 where none is (mmvae_tpu/vis.py:150-164, bit for bit). Any
    leading axes before (C, H, W) are kept."""
    images = np.asarray(images)
    lead = images.shape[:-3]
    images = images.reshape(-1, *images.shape[-3:])
    n, c, h, w = images.shape
    xs = np.linspace(-1, 1, w)
    X, Y = np.meshgrid(xs, xs)
    r = np.sqrt(X ** 2 + Y ** 2).astype(np.float32)
    mask = images[:, 0] > 0.5
    out = np.where(mask.any(axis=(1, 2)), (mask * r[None]).max(axis=(1, 2)),
                   0.0).astype(np.float32)
    return out.reshape(lead) if lead else out
