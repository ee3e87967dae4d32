"""Closed-form linear CCA on deep features (mmvae_tpu/dcca/linear_cca.py;
reference dcca/linear_cca.py:4-60). numpy only; the port keeps its own
copy, as it does of every numpy module it needs."""

from __future__ import annotations

import numpy as np


class LinearCCA:
    def __init__(self):
        self.w = [None, None]
        self.m = [None, None]
        self.D = None

    def fit(self, H1: np.ndarray, H2: np.ndarray, outdim_size: int,
            r1: float = 1e-4, r2: float = 1e-4):
        m = H1.shape[0]
        o1, o2 = H1.shape[1], H2.shape[1]
        self.m[0] = np.mean(H1, axis=0)
        self.m[1] = np.mean(H2, axis=0)
        H1bar = H1 - self.m[0]
        H2bar = H2 - self.m[1]
        S12 = (1.0 / (m - 1)) * (H1bar.T @ H2bar)
        S11 = (1.0 / (m - 1)) * (H1bar.T @ H1bar) + r1 * np.identity(o1)
        S22 = (1.0 / (m - 1)) * (H2bar.T @ H2bar) + r2 * np.identity(o2)

        def root_inv(S):
            d, v = np.linalg.eigh(S)
            return (v * (d ** -0.5)) @ v.T

        s11ri, s22ri = root_inv(S11), root_inv(S22)
        Tval = s11ri @ S12 @ s22ri
        U, Dsv, Vt = np.linalg.svd(Tval)
        V = Vt.T
        self.w[0] = s11ri @ U[:, :outdim_size]
        self.w[1] = s22ri @ V[:, :outdim_size]
        self.D = Dsv[:100]

    def transform(self, x: np.ndarray, idx: int) -> np.ndarray:
        return (x - self.m[idx][None, :]) @ self.w[idx]

    def test(self, H1, H2):
        return self.transform(H1, 0), self.transform(H2, 1)
