"""Paired-dataset containers, batch iterators and the dataset constructors
of MNIST-SVHN, circles-squares, MNIST-Fashion, MNIST-Contour, MedMNIST,
chest-X-ray-SVHN and CelebA (own copy
of mmvae_tpu/data/loaders.py, numpy only apart from torch's randperm for
the reference's seeded val splits). Same pairing, splits and batch order as
the JAX package, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import pairing, sources, synthetic


class LazyGather:
    """View of ``base[idx]`` that gathers rows on access: the pairing maps a
    deduplicated base array onto many more paired rows, and the device
    pipeline ships (base, idx) instead of the duplicated rows. `base_labels`,
    where given, are the labels of `base`'s rows, so that the eval
    classifiers can train on the deduplicated rows."""

    __slots__ = ("base", "idx", "base_labels")

    def __init__(self, base: np.ndarray, idx: np.ndarray,
                 base_labels: Optional[np.ndarray] = None):
        self.base = base
        self.idx = np.ascontiguousarray(idx)
        self.base_labels = base_labels

    def __len__(self):
        return len(self.idx)

    @property
    def shape(self):
        return (len(self.idx),) + self.base.shape[1:]

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def ndim(self):
        return self.base.ndim

    def __getitem__(self, s):
        """Materializes the selected rows (int, slice, or index array)."""
        return self.base[self.idx[s]]

    def __array__(self, dtype=None, copy=None):
        out = self[:]
        return out if dtype is None else out.astype(dtype, copy=False)

    def lazy_subset(self, s) -> "LazyGather":
        return LazyGather(self.base, self.idx[s], self.base_labels)


@dataclasses.dataclass
class PairedDataset:
    """Aligned multimodal rows: modalities[m][i] pairs with modalities[m'][i].
    `extras` are per-row arrays beside them (circles-squares' true radii
    r_squares and r_circles), which `subset` takes along."""

    modalities: List
    labels: List[np.ndarray]
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def __len__(self):
        return len(self.modalities[0])

    def subset(self, idx: np.ndarray) -> "PairedDataset":
        return PairedDataset(
            [m.lazy_subset(idx) if isinstance(m, LazyGather) else m[idx]
             for m in self.modalities],
            [l[idx] for l in self.labels],
            {k: v[idx] for k, v in self.extras.items()},
        )


def torch_split_indices(n: int, lengths: Sequence[int], seed: int = 42):
    """torch.utils.data.random_split index semantics (randperm under a
    manually-seeded Generator): the reference's val splits, bit-exactly
    (dataloaders.py:279-282)."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).numpy()
    out, off = [], 0
    for ln in lengths:
        out.append(perm[off: off + ln])
        off += ln
    return out


class ArrayLoader:
    """Epoch iterator over a PairedDataset. Yields (xs, labels), lists of
    (B, ...) numpy arrays. Train iterations drop the remainder batch; eval
    iterations keep it."""

    def __init__(self, dataset: PairedDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, drop_last: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_examples(self):
        return len(self.dataset)

    def __iter__(self):
        n = len(self.dataset)
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = n - n % self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            b = idx[s: s + self.batch_size]
            yield (
                [m[b] for m in self.dataset.modalities],
                [l[b] for l in self.dataset.labels],
            )


def _loaders(train: PairedDataset, test: PairedDataset, val: PairedDataset,
             batch_size: int, shuffle: bool, seed: int = 0):
    return (
        ArrayLoader(train, batch_size, shuffle, seed=seed),
        ArrayLoader(test, batch_size, False),
        ArrayLoader(val, batch_size, False),
    )


def circles_squares(data_path: str = "", batch_size: int = 64, shuffle: bool = True,
                    dataset_size: int = 1000, n_repeat: int = 10, seed: int = 0):
    """CIRCLES_SQUARES_DL (dataloaders.py:169-192): modalities (squares,
    circles), labels 1 = full, 0 = empty, the true radii as extras; val and
    test are the seed-42 split of the test set into [half, rest]. The data
    are always synthetic: `data_path` is not read."""
    d = synthetic.make_circles_squares(dataset_size=dataset_size, n_repeat=n_repeat, seed=seed)

    def split(name):
        return PairedDataset(
            [d[f"squares_{name}"], d[f"circles_{name}"]],
            [d[f"labels_{name}"], d[f"labels_{name}"]],
            {"r_squares": d[f"r_squares_{name}"], "r_circles": d[f"r_circles_{name}"]})

    test_full = split("test")
    n = len(test_full)
    val_idx, test_idx = torch_split_indices(n, [n // 2, n - n // 2])
    return _loaders(split("train"), test_full.subset(test_idx), test_full.subset(val_idx),
                    batch_size, shuffle)


def _train_val_test(train_full: PairedDataset, test: PairedDataset, batch_size, shuffle):
    """The reference's seeded val split of the train set (dataloaders.py:279-282)."""
    len_val = min(10000, len(train_full) // 10)
    tr_idx, val_idx = torch_split_indices(len(train_full), [len(train_full) - len_val, len_val])
    return _loaders(train_full.subset(tr_idx), test, train_full.subset(val_idx),
                    batch_size, shuffle)


def _paired_from_sources(mods_train, mods_test, max_d, dm, len_train, batch_size,
                         shuffle, seed_pair=0):
    """Shared pairing/split logic of the MNIST-SVHN loaders
    (dataloaders.py:244-290)."""
    idx_tr = pairing.rand_match_on_idx([l for _, l in mods_train], max_d=max_d, dm=dm, seed=seed_pair)
    idx_te = pairing.rand_match_on_idx([l for _, l in mods_test], max_d=max_d, dm=dm, seed=seed_pair + 1)
    # test pairing is shuffled once at build time (make-mnist-svhn-idx.py:44)
    sh = np.random.default_rng(seed_pair + 2).permutation(len(idx_te[0]))
    idx_te = tuple(i[sh] for i in idx_te)

    # seeded permutation enabling len_train truncation (dataloaders.py:263-266)
    rd_idx = np.random.RandomState(seed=42).permutation(len(idx_tr[0]))
    idx_tr = tuple(i[rd_idx] for i in idx_tr)
    if len_train is not None:
        idx_tr = tuple(i[:len_train] for i in idx_tr)

    train_full = PairedDataset(
        [LazyGather(x, i, base_labels=l) for (x, l), i in zip(mods_train, idx_tr)],
        [l[i] for (_, l), i in zip(mods_train, idx_tr)],
    )
    test = PairedDataset(
        [LazyGather(x, i, base_labels=l) for (x, l), i in zip(mods_test, idx_te)],
        [l[i] for (_, l), i in zip(mods_test, idx_te)],
    )
    return _train_val_test(train_full, test, batch_size, shuffle)


def mnist_svhn(data_path: str = "../data", batch_size: int = 128, shuffle: bool = True,
               len_train: Optional[int] = None, synthetic_n: int = 4096,
               difficulty: float = 0.0, confound_max: Optional[float] = None,
               fold: float = 0.0):
    """MNIST_SVHN_DL (dataloaders.py:239-290). Uses raw files when present,
    synthetic class-structured stand-ins otherwise."""
    knobs = dict(difficulty=difficulty, confound_max=confound_max, fold=fold)
    m_tr = sources.load_or_synthesize(
        lambda: sources.load_mnist(data_path, True), (1, 28, 28), synthetic_n, 1,
        proto_seed=1, **knobs)
    m_te = sources.load_or_synthesize(
        lambda: sources.load_mnist(data_path, False), (1, 28, 28), synthetic_n // 4, 2,
        proto_seed=1, **knobs)
    s_tr = sources.load_or_synthesize(
        lambda: sources.load_svhn(data_path, True), (3, 32, 32), synthetic_n, 3,
        proto_seed=3, **knobs)
    s_te = sources.load_or_synthesize(
        lambda: sources.load_svhn(data_path, False), (3, 32, 32), synthetic_n // 4, 4,
        proto_seed=3, **knobs)
    return _paired_from_sources(
        [m_tr[:2], s_tr[:2]], [m_te[:2], s_te[:2]],
        max_d=10000, dm=5, len_train=len_train,
        batch_size=batch_size, shuffle=shuffle,
    )


def mnist_fashion(data_path: str = "../data", batch_size: int = 128, shuffle: bool = True,
                  synthetic_n: int = 4096, difficulty: float = 0.0):
    """MNIST_FASHION_DL with the unbalanced correspondence pairing
    (bin/make-mnist-fashion.py:10-11): MNIST digits 0-2, each paired with
    one of three Fashion classes, 30 times over."""
    def load(train, fashion, seed, proto_seed):
        return sources.load_or_synthesize(
            lambda: sources.load_mnist(data_path, train, fashion=fashion), (1, 28, 28),
            synthetic_n if train else synthetic_n // 4, seed, proto_seed=proto_seed,
            difficulty=difficulty)

    def build(m, f, seed):
        i1, i2 = pairing.rand_match_on_correspondence(
            m[1], f[1], pairing.MNIST_FASHION_CORRESPONDENCE, max_d=5000, dm=30, seed=seed)
        return PairedDataset([m[0][i1], f[0][i2]], [m[1][i1], f[1][i2]])

    train_full = build(load(True, False, 1, 1), load(True, True, 5, 5), 0)
    test = build(load(False, False, 2, 1), load(False, True, 6, 5), 1)
    return _train_val_test(train_full, test, batch_size, shuffle)


def mnist_contour(data_path: str = "../data", batch_size: int = 128, shuffle: bool = True,
                  synthetic_n: int = 2048, difficulty: float = 0.0):
    """MNIST_CONTOUR_DL (dataloaders.py:445-479): each MNIST image paired
    with its Canny contour (data_utils/transforms.py:6-21)."""
    from .transforms import canny_contour

    def build(train, seed):
        img, lab, _ = sources.load_or_synthesize(
            lambda: sources.load_mnist(data_path, train), (1, 28, 28),
            synthetic_n if train else synthetic_n // 4, seed, proto_seed=1,
            difficulty=difficulty)
        return PairedDataset([img, canny_contour(img)], [lab, lab])

    return _train_val_test(build(True, 1), build(False, 2), batch_size, shuffle)


def medmnist_pairs(data_path: str = "../data", batch_size: int = 128, shuffle: bool = True,
                   synthetic_n: int = 2048, difficulty: float = 0.0):
    """PneumoniaMNIST <-> BloodMNIST pairs (MEDMNIST_DL, dataloaders.py:
    573-637), each split paired on its own: blood classes 1 and 6 remapped
    to 0 and 1 and the others dropped (bin/make-medmnist-pairs.py:37-43);
    on the synthetic stand-in both labels are taken mod 2."""
    out = []
    for split, seed in [("train", 0), ("test", 1), ("val", 2)]:
        p_img, p_lab, _ = sources.load_or_synthesize(
            lambda s=split: sources.load_medmnist(data_path, "pneumoniamnist", s),
            (1, 28, 28), synthetic_n, 10 + seed, proto_seed=10, difficulty=difficulty)
        b_img, b_lab, real = sources.load_or_synthesize(
            lambda s=split: sources.load_medmnist(data_path, "bloodmnist", s),
            (3, 28, 28), synthetic_n, 20 + seed, proto_seed=20, difficulty=difficulty)
        if real:
            keep, b_lab = pairing.remap_medmnist_blood_labels(b_lab)
            b_img = b_img[keep]
        else:
            b_lab = b_lab % 2
        p_lab = p_lab % 2
        i1, i2 = pairing.rand_match_on_idx([p_lab, b_lab], max_d=10000, dm=3, seed=seed)
        sh = np.random.default_rng(seed + 40).permutation(len(i1))
        i1, i2 = i1[sh], i2[sh]
        out.append(PairedDataset([p_img[i1], b_img[i2]], [p_lab[i1], b_lab[i2]]))
    return _loaders(*out, batch_size, shuffle)


def celeba(data_path: str = "../data", batch_size: int = 128, shuffle: bool = True,
           synthetic_n: int = 2048, difficulty: float = 0.0):
    """CelebA image <-> 40-attribute pairs (datasets.py:269-428); the
    attribute vector is a modality of its own, a 1x1x40 tensor, and
    attribute 20 (Male) is each pair's label. Reads
    data_path/celeba/celeba64_<split>.npz, else the torchvision layout
    (sources.load_celeba), else a synthetic stand-in: two-class images with
    40 attributes drawn uniform < 0.3 from one default_rng(7) over the
    splits in the order train, test, valid, attribute 20 set to the class."""
    rng = np.random.default_rng(7)

    def load_split(split, seed):
        try:
            with np.load(f"{data_path}/celeba/celeba64_{split}.npz") as npz:
                imgs = npz["images"].astype(np.float32) / 255.0
                attrs = npz["attrs"].astype(np.float32)
        except (FileNotFoundError, OSError):
            try:
                imgs, attrs = sources.load_celeba(data_path, split)
            except (FileNotFoundError, OSError, KeyError):
                if sources.require_real():
                    raise
                d = synthetic.synthetic_labeled_images(
                    synthetic_n if split == "train" else synthetic_n // 4, (3, 64, 64),
                    n_classes=2, seed=seed, proto_seed=30, difficulty=difficulty)
                imgs = d["images"]
                attrs = (rng.uniform(size=(len(imgs), 40)) < 0.3).astype(np.float32)
                attrs[:, 20] = d["labels"]
        labels = attrs[:, 20].astype(np.int64)
        return PairedDataset([imgs, attrs.reshape(-1, 1, 1, 40)], [labels, labels])

    return _loaders(load_split("train", 30), load_split("test", 31), load_split("valid", 32),
                    batch_size, shuffle)


def chest_svhn(data_path: str = "../data", batch_size: int = 128, shuffle: bool = True,
               synthetic_n: int = 2048, difficulty: float = 0.0):
    """CHEST_SVHN_DL (dataloaders.py:293-347): PneumoniaMNIST x-rays paired
    with SVHN digits on the x-rays' classes {0, 1}, so SVHN is restricted to
    digits 0 and 1 with their true labels kept (make-chest-svhn.py:11-19),
    not binarised. The synthetic stand-ins share their prototypes with
    MedMNIST's pneumonia (seed 10) and MNIST-SVHN's SVHN (seed 3)."""
    out = []
    for split, train, seed in [("train", True, 0), ("test", False, 1), ("val", False, 2)]:
        c_img, c_lab, _ = sources.load_or_synthesize(
            lambda s=split: sources.load_medmnist(data_path, "pneumoniamnist", s),
            (1, 28, 28), synthetic_n, 10 + seed, proto_seed=10, difficulty=difficulty)
        s_img, s_lab, _ = sources.load_or_synthesize(
            lambda t=train: sources.load_svhn(data_path, t),
            (3, 32, 32), synthetic_n, 3 + 2 * seed, proto_seed=3, difficulty=difficulty)
        c_lab, s_lab = c_lab % 2, s_lab.astype(np.int64) % 10
        i1, i2 = pairing.rand_match_on_idx([c_lab, s_lab], max_d=10000, dm=3, seed=seed)
        sh = np.random.default_rng(seed + 70).permutation(len(i1))
        i1, i2 = i1[sh], i2[sh]
        out.append(PairedDataset([c_img[i1], s_img[i2]], [c_lab[i1], s_lab[i2]]))
    return _loaders(*out, batch_size, shuffle)


DATASETS = {
    "mnist_svhn": mnist_svhn,
    "circles_squares": circles_squares,
    "mnist_fashion": mnist_fashion,
    "mnist_contour": mnist_contour,
    "medmnist": medmnist_pairs,
    "celeba": celeba,
    "chest_svhn": chest_svhn,
}


def get_dataloaders(name: str, **kw) -> Tuple[ArrayLoader, ArrayLoader, ArrayLoader]:
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name!r} not yet ported")
    return DATASETS[name](**kw)
