"""Paired-dataset containers and batch iterators for the MNIST-SVHN path
(own copy of mmvae_tpu/data/loaders.py, numpy only apart from torch's
randperm for the reference's seeded val split). Same pairing, splits and
batch order as the JAX package, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import pairing, sources


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
    """Aligned multimodal rows: modalities[m][i] pairs with modalities[m'][i]."""

    modalities: List
    labels: List[np.ndarray]

    def __len__(self):
        return len(self.modalities[0])

    def subset(self, idx: np.ndarray) -> "PairedDataset":
        return PairedDataset(
            [m.lazy_subset(idx) if isinstance(m, LazyGather) else m[idx]
             for m in self.modalities],
            [l[idx] for l in self.labels],
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
    # deterministic val split (dataloaders.py:279-282)
    len_val = min(10000, len(train_full) // 10)
    tr_idx, val_idx = torch_split_indices(len(train_full), [len(train_full) - len_val, len_val])
    return _loaders(train_full.subset(tr_idx), test, train_full.subset(val_idx),
                    batch_size, shuffle)


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


DATASETS = {
    "mnist_svhn": mnist_svhn,
}


def get_dataloaders(name: str, **kw) -> Tuple[ArrayLoader, ArrayLoader, ArrayLoader]:
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name!r} not yet ported")
    return DATASETS[name](**kw)
