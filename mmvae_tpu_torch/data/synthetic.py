"""Class-structured synthetic stand-ins for MNIST/SVHN-shaped data (own copy
of mmvae_tpu/data/synthetic.py:synthetic_labeled_images, numpy only). The
output is bit-identical to the JAX package's for the same arguments."""

from __future__ import annotations

from typing import Dict

import numpy as np


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
