"""Write a miniature data directory in the real on-disk formats
(mmvae_tpu/data/make_real_layout.py:38-150).

The synthetic content of `data/synthetic.py`, in the exact layouts that the
reference's data contract assumes (torchvision's raw layouts,
dataloaders.py:239-290, bin/make-mnist-svhn-idx.py:26-47, datasets.py:348-393,
MedMNIST's npz), so that the readers of `data/sources.py` run on real
bytes, and a run with MMVAE_TPU_REQUIRE_REAL=1 (no synthetic fallback on
any path) reads them. Real datasets use these same layouts.

- MNIST / FashionMNIST: IDX ubyte (magic 0x803 images, 0x801 labels,
  big-endian dims) under ``<out>/{MNIST,FashionMNIST}/raw/``;
- SVHN: ``{train,test}_32x32.mat``, X (32, 32, 3, N) uint8 and y (N, 1) in
  1..10 (10 is the digit 0, remapped by the reader as torchvision does);
- MedMNIST: ``{flag}.npz`` with {train,val,test}_{images,labels}, gray
  (N, 28, 28) or RGB (N, 28, 28, 3) uint8, labels (N, 1);
- CelebA: ``celeba/list_eval_partition.txt``, ``celeba/list_attr_celeba.txt``
  (+-1 values) and 64x64 PNGs under
  ``celeba/img_align_celeba/celeba_64x64/train/``, written by the port's
  own PNG writer (`vis.write_png`), not PIL.

The same seeds as the JAX package: its IDX and text files come out byte for
byte; the .mat and .npz files hold the same keys, dtypes and arrays (a MAT
header and a zip entry carry the time of writing); the PNGs decode to the
same pixels as JAX's PIL-written ones.

    python -m mmvae_tpu_torch.data.make_real_layout --out DIR [--n 512]
"""

from __future__ import annotations

import os

import numpy as np

from ..vis import write_png
from .synthetic import synthetic_labeled_images


def write_idx(path: str, arr: np.ndarray) -> None:
    """An IDX ubyte file: magic 0x00000800 | ndim, big-endian uint32 dims,
    the raw bytes."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write((0x00000800 | arr.ndim).to_bytes(4, "big"))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(arr.tobytes())


def _u8(images01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(images01 * 255.0), 0, 255).astype(np.uint8)


def write_mnist(out: str, n_train: int, n_test: int, fashion: bool = False,
                seed: int = 1) -> None:
    d = os.path.join(out, "FashionMNIST" if fashion else "MNIST", "raw")
    os.makedirs(d, exist_ok=True)
    proto = 5 if fashion else 1  # the synthetic modalities' identities
    for split, n, s in [("train", n_train, seed), ("t10k", n_test, seed + 1)]:
        data = synthetic_labeled_images(n, (1, 28, 28), seed=s + (100 if fashion else 0),
                                        proto_seed=proto)
        write_idx(os.path.join(d, f"{split}-images-idx3-ubyte"), _u8(data["images"][:, 0]))
        write_idx(os.path.join(d, f"{split}-labels-idx1-ubyte"),
                  data["labels"].astype(np.uint8))


def write_svhn(out: str, n_train: int, n_test: int, seed: int = 3) -> None:
    import scipy.io as sio

    os.makedirs(out, exist_ok=True)
    for split, n, s in [("train", n_train, seed), ("test", n_test, seed + 1)]:
        data = synthetic_labeled_images(n, (3, 32, 32), seed=200 + s, proto_seed=3)
        x = np.transpose(_u8(data["images"]), (2, 3, 1, 0))  # -> (32, 32, 3, N)
        y = data["labels"].astype(np.uint8)
        y = np.where(y == 0, 10, y).reshape(-1, 1)  # the digit 0 stored as 10
        sio.savemat(os.path.join(out, f"{split}_32x32.mat"), {"X": x, "y": y})


def write_medmnist(out: str, flag: str, n: int, rgb: bool, n_classes: int, seed: int) -> None:
    os.makedirs(out, exist_ok=True)
    shape = (3, 28, 28) if rgb else (1, 28, 28)
    arrays = {}
    for i, (split, ns) in enumerate([("train", n), ("val", n // 4), ("test", n // 4)]):
        data = synthetic_labeled_images(ns, shape, n_classes=n_classes, seed=seed + i,
                                        proto_seed=seed)
        imgs = _u8(data["images"])
        imgs = np.transpose(imgs, (0, 2, 3, 1)) if rgb else imgs[:, 0]
        arrays[f"{split}_images"] = imgs
        arrays[f"{split}_labels"] = data["labels"].reshape(-1, 1).astype(np.uint8)
    np.savez(os.path.join(out, f"{flag}.npz"), **arrays)


def write_celeba(out: str, n: int, seed: int = 30) -> None:
    root = os.path.join(out, "celeba")
    img_dir = os.path.join(root, "img_align_celeba", "celeba_64x64", "train")
    os.makedirs(img_dir, exist_ok=True)
    data = synthetic_labeled_images(n, (3, 64, 64), n_classes=2, seed=seed, proto_seed=30)
    rng = np.random.default_rng(seed + 1)
    attrs = (rng.uniform(size=(n, 40)) < 0.3).astype(np.int64)
    attrs[:, 20] = data["labels"]  # the Male column carries the label
    names = [f"{i + 1:06d}.jpg" for i in range(n)]
    # the torchvision split codes 0/1/2, about 70/15/15
    part = np.zeros(n, dtype=np.int64)
    part[int(n * 0.7): int(n * 0.85)] = 1
    part[int(n * 0.85):] = 2
    with open(os.path.join(root, "list_eval_partition.txt"), "w") as f:
        for name, p in zip(names, part):
            f.write(f"{name} {p}\n")
    attr_names = [f"Attr_{i:02d}" for i in range(40)]
    attr_names[20] = "Male"
    with open(os.path.join(root, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{n}\n")
        f.write(" ".join(attr_names) + "\n")
        for name, row in zip(names, attrs):
            f.write(name + " " + " ".join(str(2 * v - 1) for v in row) + "\n")
    for name, img in zip(names, _u8(data["images"])):
        write_png(np.transpose(img, (1, 2, 0)),
                  os.path.join(img_dir, os.path.splitext(name)[0] + ".png"))


def build_layout(out: str, n: int = 512) -> str:
    """Every format's layout under `out`, n train examples per base dataset;
    returns out."""
    write_mnist(out, n, n // 4)
    write_mnist(out, n, n // 4, fashion=True)
    write_svhn(out, n, n // 4)
    write_medmnist(out, "pneumoniamnist", n // 2, rgb=False, n_classes=2, seed=10)
    write_medmnist(out, "bloodmnist", n // 2, rgb=True, n_classes=8, seed=20)
    write_celeba(out, max(64, n // 4))
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Write synthetic data in the real on-disk formats")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=512, help="train examples per base dataset")
    a = p.parse_args(argv)
    build_layout(a.out, a.n)
    print("real-format layout written to", a.out)


if __name__ == "__main__":
    main()
