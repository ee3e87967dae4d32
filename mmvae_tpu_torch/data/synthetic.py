"""Synthetic datasets (own copy of mmvae_tpu/data/synthetic.py, numpy
only): the circles-squares dataset and the class-structured stand-ins for
MNIST/SVHN-shaped data. The output is bit-identical to the JAX package's
for the same arguments."""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_circles_squares(
    dataset_size: int = 10000,
    size_image: int = 32,
    min_rayon: float = 0.3,
    max_rayon: float = 0.9,
    circle_thickness: float = 0.25,
    n_repeat: int = 10,
    test_size: float = 0.3,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Paired squares and circles rasterized from random radii
    (bin/make-circles-squares.py): label 1 pairs a full square with a disc,
    label 0 a square outline with a ring. Returns squares_{train,test},
    circles_{train,test}, labels_*, r_squares_* and r_circles_*.

    The (radius, image, label) tuples come in two contiguous blocks, the
    full shapes first, where the reference alternates them per index: the
    same samples, which the split below shuffles anyway. Rasterized in
    chunks to bound the boolean temporaries, into np.zeros arrays (fresh
    pages, not np.empty's reused arena, whose first touch is slow on some
    hosts)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, size_image)
    X, Y = np.meshgrid(xs, xs)
    rr2 = X ** 2 + Y ** 2
    rl1 = np.abs(X) + np.abs(Y)

    n = dataset_size * n_repeat
    r_circles = rng.uniform(min_rayon, max_rayon, size=n)
    r_squares = rng.uniform(min_rayon, max_rayon, size=n)
    squares = np.zeros((n, 1, size_image, size_image), dtype=np.float32)
    circles = np.zeros((n, 1, size_image, size_image), dtype=np.float32)
    half = circle_thickness / 2
    rc_e, rc_o = r_circles[0::2], r_circles[1::2]
    rs_e, rs_o = r_squares[0::2], r_squares[1::2]
    n_even = len(rc_e)
    r_circles = np.concatenate([rc_e, rc_o])
    r_squares = np.concatenate([rs_e, rs_o])
    labels = np.concatenate([np.ones(n_even, np.int64), np.zeros(n - n_even, np.int64)])

    def _r3(r):  # (k,) radii -> (k, 1, 1), against the grid
        return r[:, None, None]

    step = 20000
    for s in range(0, n_even, step):
        e = min(s + step, n_even)
        circles[s:e, 0] = rr2[None] <= _r3(rc_e[s:e]) ** 2
        squares[s:e, 0] = rl1[None] <= _r3(rs_e[s:e])
    for s in range(0, n - n_even, step):
        e = min(s + step, n - n_even)
        circles[n_even + s: n_even + e, 0] = (
            rr2[None] <= _r3(rc_o[s:e] + half) ** 2) & (rr2[None] >= _r3(rc_o[s:e] - half) ** 2)
        squares[n_even + s: n_even + e, 0] = (
            rl1[None] <= _r3(rs_o[s:e] + half)) & (rl1[None] >= _r3(rs_o[s:e] - half))

    perm = rng.permutation(n)
    n_test = int(round(n * test_size))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    out = {}
    for name, arr in [("squares", squares), ("circles", circles), ("labels", labels),
                      ("r_squares", r_squares.astype(np.float32)),
                      ("r_circles", r_circles.astype(np.float32))]:
        out[f"{name}_train"] = arr[train_idx]
        out[f"{name}_test"] = arr[test_idx]
    return out


def synthetic_labeled_images(
    n: int, shape, n_classes: int = 10, seed: int = 0,
    proto_seed: int = None, difficulty: float = 0.0,
    proto_scale: float = None, noise_std: float = None,
    intra_class_k: int = None, confound_max: float = None,
    fold: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Each class has a smooth random prototype; samples are noisy
    prototypes squashed to [0,1].

    proto_seed pins the class prototypes independently of the sample noise:
    all splits of one synthetic modality share it. The difficulty knobs
    (proto_scale, noise_std, intra_class_k, confound_max, fold; difficulty
    maps onto the first four) are documented in the JAX package's copy.
    """
    if proto_scale is None:
        proto_scale = 1.0 - 0.65 * difficulty
    if noise_std is None:
        noise_std = 0.5 + 0.9 * difficulty
    if intra_class_k is None:
        intra_class_k = 1 if difficulty == 0.0 else 3
    if confound_max is None:
        confound_max = 0.9 * difficulty
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(seed if proto_seed is None else proto_seed)
    protos = proto_rng.normal(0, 1, size=(n_classes,) + tuple(shape)).astype(np.float32)
    protos *= np.float32(proto_scale)
    labels = rng.integers(0, n_classes, size=n)
    imgs = protos[labels]
    if intra_class_k > 1:
        subs = proto_rng.normal(
            0, 1, size=(n_classes, intra_class_k) + tuple(shape)
        ).astype(np.float32) * np.float32(0.5 * proto_scale)
        style = rng.integers(0, intra_class_k, size=n)
        imgs = imgs + subs[labels, style]
    if confound_max > 0.0 and n_classes >= 2:
        c_rng = np.random.default_rng([seed, 7777])
        alt = (labels + c_rng.integers(1, n_classes, size=n)) % n_classes
        w = c_rng.uniform(0.0, confound_max, size=n).astype(np.float32)
        w = w.reshape((n,) + (1,) * len(tuple(shape)))
        imgs = (1.0 - w) * imgs + w * protos[alt]
    if fold > 0.0:
        np.multiply(imgs, np.float32(fold), out=imgs)
        np.sin(imgs, out=imgs)
        np.multiply(imgs, np.float32(1.5), out=imgs)
    imgs += np.float32(noise_std) * rng.standard_normal(
        size=(n,) + tuple(shape), dtype=np.float32)
    np.negative(imgs, out=imgs)
    np.exp(imgs, out=imgs)
    imgs += 1.0
    np.reciprocal(imgs, out=imgs)
    return {"images": imgs, "labels": labels.astype(np.int64)}
