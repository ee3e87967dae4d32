"""Raw dataset readers (own copy of mmvae_tpu/data/sources.py, numpy only):
MNIST and FashionMNIST IDX files and SVHN .mat files, with the
class-structured synthetic fallback when they are absent."""

from __future__ import annotations

import gzip
import os

import numpy as np

from .synthetic import synthetic_labeled_images


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx(path: str) -> np.ndarray:
    """MNIST IDX format reader."""
    with _open_maybe_gz(path) as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _mnist_dir(data_path: str, fashion: bool) -> str:
    sub = "FashionMNIST" if fashion else "MNIST"
    for cand in [os.path.join(data_path, sub, "raw"), os.path.join(data_path, sub)]:
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(f"no {sub} under {data_path}")


def load_mnist(data_path: str, train: bool, fashion: bool = False):
    """-> (images float32 (N,1,28,28) in [0,1], labels int64); with
    `fashion`, FashionMNIST's files."""
    d = _mnist_dir(data_path, fashion)
    split = "train" if train else "t10k"
    imgs = read_idx(os.path.join(d, f"{split}-images-idx3-ubyte"))
    labs = read_idx(os.path.join(d, f"{split}-labels-idx1-ubyte"))
    return (imgs[:, None].astype(np.float32) / 255.0, labs.astype(np.int64))


def load_svhn(data_path: str, train: bool):
    """-> (images float32 (N,3,32,32) in [0,1], labels int64 in [0,9])."""
    import scipy.io as sio

    split = "train" if train else "test"
    mat = sio.loadmat(os.path.join(data_path, f"{split}_32x32.mat"))
    x = mat["X"]  # (32,32,3,N)
    y = mat["y"].squeeze().astype(np.int64) % 10
    x = np.transpose(x, (3, 2, 0, 1)).astype(np.float32) / 255.0
    return x, y


def require_real() -> bool:
    """MMVAE_TPU_REQUIRE_REAL=1 forbids synthetic fallbacks (the JAX
    package's switch, read the same way)."""
    return os.environ.get("MMVAE_TPU_REQUIRE_REAL", "") not in ("", "0")


def load_or_synthesize(loader_fn, fallback_shape, n_fallback: int, seed: int,
                       proto_seed: int = None, difficulty: float = 0.0,
                       confound_max: float = None, fold: float = 0.0):
    """Try a raw loader; on FileNotFoundError return synthetic stand-ins.
    Returns (images, labels, is_real)."""
    try:
        return loader_fn() + (True,)
    except (FileNotFoundError, OSError):
        if require_real():
            raise
        d = synthetic_labeled_images(n_fallback, fallback_shape, seed=seed,
                                     proto_seed=proto_seed, difficulty=difficulty,
                                     confound_max=confound_max, fold=fold)
        return d["images"], d["labels"], False
