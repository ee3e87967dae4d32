"""Raw dataset readers (own copy of mmvae_tpu/data/sources.py, numpy and
scipy only; CelebA's PNGs through the port's own reader, data/png.py, so
that the port needs no PIL to read them): MNIST and
FashionMNIST IDX files, SVHN .mat files, the MedMNIST .npz archives and
CelebA's torchvision layout, with the class-structured synthetic fallback
when they are absent. `data/make_real_layout.py` writes every layout."""

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


# CelebA's crops decoded together, this many at a time (data/png.py)
_PNG_CHUNK = 4096


def load_celeba(data_path: str, split: str):
    """CelebA in the reference's torchvision layout under
    ``data_path/celeba/`` (datasets.py:269-428): ``list_eval_partition.txt``
    (``<filename> <0|1|2>``), ``list_attr_celeba.txt`` (a count line, the 40
    attribute names, then ``<filename> <40 x +-1>`` rows, mapped to {0, 1}
    by (a + 1) // 2), and the 64x64 crops
    ``img_align_celeba/celeba_64x64/train/<stem>.png``: the reference reads
    every split from the ``train`` directory, with the extension swapped to
    .png, as here. A gray PNG is taken as RGB of equal channels and an
    alpha channel is dropped, as PIL's convert("RGB") does.

    -> (images float32 (N, 3, 64, 64) in [0, 1], attributes float32 (N, 40)
    in {0, 1})."""
    root = os.path.join(data_path, "celeba")
    want = {"train": 0, "val": 1, "valid": 1, "test": 2}[split]
    part_path = os.path.join(root, "list_eval_partition.txt")
    if not os.path.exists(part_path):
        raise FileNotFoundError(part_path)
    from .png import read_pngs

    with open(part_path) as f:
        fnames = [p[0] for p in (line.split() for line in f)
                  if len(p) == 2 and int(p[1]) == want]
    with open(os.path.join(root, "list_attr_celeba.txt")) as f:
        lines = f.read().splitlines()
    n_attrs = len(lines[1].split())
    attrs_by_name = {}
    for line in lines[2:]:
        parts = line.split()
        if len(parts) == n_attrs + 1:
            attrs_by_name[parts[0]] = (np.array([int(v) for v in parts[1:]], np.int64) + 1) // 2
    imgs = []
    img_dir = os.path.join(root, "img_align_celeba", "celeba_64x64", "train")
    paths = [os.path.join(img_dir, os.path.splitext(name)[0] + ".png") for name in fnames]
    for s in range(0, len(paths), _PNG_CHUNK):
        for img in read_pngs(paths[s:s + _PNG_CHUNK]):
            if img.ndim == 2:
                img = img[..., None]
            rgb = img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3, axis=-1)
            imgs.append(np.transpose(rgb, (2, 0, 1)))
    attrs = [attrs_by_name[name] for name in fnames]
    return np.stack(imgs).astype(np.float32) / 255.0, np.stack(attrs).astype(np.float32)


def load_medmnist(data_path: str, flag: str, split: str):
    """A MedMNIST .npz archive (e.g. flag='pneumoniamnist'): -> (images
    float32 (N, C, 28, 28) in [0, 1], labels int64)."""
    with np.load(os.path.join(data_path, f"{flag}.npz")) as npz:
        x = npz[f"{split}_images"]
        y = npz[f"{split}_labels"].squeeze().astype(np.int64)
    x = x[:, None] if x.ndim == 3 else np.transpose(x, (0, 3, 1, 2))
    return x.astype(np.float32) / 255.0, y


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
