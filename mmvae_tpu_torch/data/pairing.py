"""Index pairing (own copy of mmvae_tpu/data/pairing.py, numpy only).

The reference's pairing artifacts are index arrays into the base datasets
(dataloaders.py:268-275); here pairing is a pure function labels -> index
arrays and the gather happens in the input pipeline.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rand_match_on_idx(
    labels: Sequence[np.ndarray],
    max_d: int = 10000,
    dm: int = 5,
    seed: int = 0,
) -> Tuple[np.ndarray, ...]:
    """Class-matched random index pairing for N modalities
    (bin/make-mnist-svhn-idx.py:4-18).

    labels: per-modality integer label arrays. For each class, takes the
    first min(count_m, max_d) examples per modality and emits dm random
    permutations of matched rows.
    """
    rng = np.random.default_rng(seed)
    n_mod = len(labels)
    sorted_idx = [np.argsort(l, kind="stable") for l in labels]
    sorted_lab = [l[si] for l, si in zip(labels, sorted_idx)]
    out: List[List[np.ndarray]] = [[] for _ in range(n_mod)]
    for c in np.unique(sorted_lab[0]):
        per_mod = [si[sl == c] for si, sl in zip(sorted_idx, sorted_lab)]
        n = min(min(len(p) for p in per_mod), max_d)
        per_mod = [p[:n] for p in per_mod]
        for _ in range(dm):
            for m in range(n_mod):
                out[m].append(per_mod[m][rng.permutation(n)])
    return tuple(np.concatenate(o) for o in out)


def rand_match_on_correspondence(
    l1: np.ndarray,
    l2: np.ndarray,
    correspondence: Sequence[Sequence[int]],
    max_d: int = 5000,
    dm: int = 30,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unbalanced label-correspondence pairing (bin/make-mnist-fashion.py:
    10-37): class l of the first modality pairs with any class of the
    second in correspondence[l]."""
    rng = np.random.default_rng(seed)
    i1_out, i2_out = [], []
    for l, fset in enumerate(correspondence):
        l_idx1 = np.where(l1 == l)[0]
        l_idx2 = np.where(np.isin(l2, np.asarray(fset)))[0]
        n = min(len(l_idx1), len(l_idx2), max_d)
        l_idx1 = l_idx1[rng.permutation(len(l_idx1))][:n]
        l_idx2 = l_idx2[rng.permutation(len(l_idx2))][:n]
        for _ in range(dm):
            i1_out.append(l_idx1[rng.permutation(n)])
            i2_out.append(l_idx2[rng.permutation(n)])
    return np.concatenate(i1_out), np.concatenate(i2_out)


# MNIST classes 0, 1, 2 pair with Fashion classes {1, 2, 3}, {4, 5, 6}, {7, 8, 9}
MNIST_FASHION_CORRESPONDENCE = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
