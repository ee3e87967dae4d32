"""Data transforms (own copy of mmvae_tpu/data/transforms.py, numpy and
scipy.ndimage; reference data_utils/transforms.py): the Canny contour,
random grey intensity and binarization."""

from __future__ import annotations

import numpy as np


def _canny_single(img: np.ndarray, sigma: float, low: float, high: float) -> np.ndarray:
    """Canny on one (H, W) image: gaussian blur, sobel gradients,
    non-maximum suppression over 4 quantized directions, then hysteresis
    (weak pixels connected to a strong one survive)."""
    from scipy import ndimage as ndi

    sm = ndi.gaussian_filter(img.astype(np.float64), sigma)
    gx = ndi.sobel(sm, axis=1)
    gy = ndi.sobel(sm, axis=0)
    mag = np.hypot(gx, gy)
    if mag.max() > 0:
        mag = mag / mag.max()
    ang = (np.rad2deg(np.arctan2(gy, gx)) + 180.0) % 180.0

    nms = np.zeros_like(mag)
    padded = np.pad(mag, 1)
    offs = np.where((ang < 22.5) | (ang >= 157.5), 0,
                    np.where(ang < 67.5, 1, np.where(ang < 112.5, 2, 3)))
    deltas = {0: ((0, 1), (0, -1)), 1: ((-1, 1), (1, -1)),
              2: ((-1, 0), (1, 0)), 3: ((-1, -1), (1, 1))}
    h, w = mag.shape
    ys, xs = np.mgrid[0:h, 0:w]
    for d, ((dy1, dx1), (dy2, dx2)) in deltas.items():
        sel = offs == d
        n1 = padded[ys + 1 + dy1, xs + 1 + dx1]
        n2 = padded[ys + 1 + dy2, xs + 1 + dx2]
        nms[sel] = np.where((mag[sel] >= n1[sel]) & (mag[sel] >= n2[sel]), mag[sel], 0.0)

    strong = nms >= high
    weak = nms >= low
    lab, n = ndi.label(weak, structure=np.ones((3, 3)))
    keep = np.zeros(n + 1, bool)
    keep[np.unique(lab[strong])] = True
    keep[0] = False
    return keep[lab].astype(np.float32)


def canny_contour(images: np.ndarray, sigma: float = 1.0,
                  low: float = 0.1, high: float = 0.2) -> np.ndarray:
    """Canny edge contour of each (N, 1, H, W) image in [0, 1]
    (transforms.py:6-21), as 0/1 float32."""
    out = np.empty_like(images, dtype=np.float32)
    for i in range(images.shape[0]):
        out[i, 0] = _canny_single(images[i, 0], sigma, low, high)
    return out


def random_grey(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random intensity scaling in [0.3, 1), one draw per image
    (transforms.py:23-29)."""
    scale = rng.uniform(0.3, 1.0, size=(images.shape[0], 1, 1, 1)).astype(np.float32)
    return images * scale


def binarize(images: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """(image > 0.5) as float32 (transforms.py:32-37)."""
    return (images > threshold).astype(np.float32)
