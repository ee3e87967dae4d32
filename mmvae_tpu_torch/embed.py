"""Dependency-free UMAP for latent-space figures (mmvae_tpu/embed.py; the
reference reduces with umap.UMAP, multi_vaes.py:17,143-146, and plots the
DCCA embeddings with visualize_umap, dcca/utils.py:113-122).

The UMAP algorithm (McInnes et al. 2018), as the JAX package writes it:

- exact kNN, the smooth-kNN calibration and the fuzzy simplicial set union
  in numpy on the host, the JAX package's own code, so that the neighbour
  indices and the edge weights are the same (the graph is plot-sized);
- the layout's stochastic epochs as a torch loop on the caller's device:
  every edge fires with probability w / w_max per epoch and moves both
  ends, each fired edge draws `negative_sample_rate` uniform negatives
  that repel its head, gradients clipped at +-4, the learning rate decaying
  linearly. The draws come from a torch.Generator (JAX's come from its
  threefry keys, so the two layouts agree only where the draws are handed
  in, `_optimize_layout(draws=...)`).

Deviations from umap-learn, the JAX package's too: all edges of an epoch
update at once (batch SGD), and the layout starts from the PCA projection
scaled to +-10 rather than a spectral embedding.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["UMAP"]

# a, b of the default membership curve (min_dist 0.1, spread 1.0)
_DEFAULT_AB = (1.5769434603113077, 0.8950608779109733)


def _knn(x: np.ndarray, k: int):
    """Exact k nearest neighbours (self excluded) by chunked L2."""
    n = x.shape[0]
    sq = (x * x).sum(1)
    idx = np.empty((n, k), np.int64)
    dst = np.empty((n, k), np.float32)
    chunk = max(1, min(n, 4096 * 4096 // max(n, 1)))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        d2 = sq[s:e, None] - 2.0 * (x[s:e] @ x.T) + sq[None, :]
        np.maximum(d2, 0.0, out=d2)
        d2[np.arange(s, e) - s, np.arange(s, e)] = np.inf  # drop self
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1)
        idx[s:e] = np.take_along_axis(part, order, axis=1)
        dst[s:e] = np.sqrt(np.take_along_axis(pd, order, axis=1))
    return idx, dst


def _smooth_knn(dists: np.ndarray, k: int, n_iter: int = 64):
    """Per point (rho, sigma): rho the nearest neighbour's distance, sigma
    solving sum_j exp(-max(0, d_ij - rho) / sigma) = log2(k) by bisection
    (umap-learn's smooth_knn_dist)."""
    rho = dists[:, 0].copy()
    target = np.log2(k)
    lo = np.zeros(len(dists), np.float64)
    hi = np.full(len(dists), np.inf)
    mid = np.ones(len(dists), np.float64)
    d = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        val = np.exp(-d / mid[:, None]).sum(1)
        too_big = val > target
        hi = np.where(too_big, mid, hi)
        lo = np.where(too_big, lo, mid)
        mid = np.where(too_big, (lo + hi) / 2.0,
                       np.where(np.isinf(hi), lo * 2.0, (lo + hi) / 2.0))
    # umap-learn keeps sigma away from 0, relative to the mean distance
    mean_d = float(dists.mean()) or 1.0
    sigma = np.maximum(mid, 1e-3 * mean_d)
    return rho.astype(np.float32), sigma.astype(np.float32)


def _fuzzy_graph(idx: np.ndarray, dists: np.ndarray, k: int):
    """Directed memberships to the fuzzy union's edge list (heads, tails,
    weights): W = A + A^T - A * A^T over the kNN support, each pair once."""
    n = idx.shape[0]
    rho, sigma = _smooth_knn(dists, k)
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), k)
    cols = idx.ravel()
    vals = w.ravel().astype(np.float64)
    fwd = {}
    for r, c, v in zip(rows, cols, vals):
        fwd[(int(r), int(c))] = v
    heads, tails, weights = [], [], []
    seen = set()
    for (r, c), v in fwd.items():
        key = (min(r, c), max(r, c))
        if key in seen:
            continue
        seen.add(key)
        vt = fwd.get((c, r), 0.0)
        union = v + vt - v * vt
        if union > 0.0:
            heads.append(r)
            tails.append(c)
            weights.append(union)
    return (np.asarray(heads, np.int32), np.asarray(tails, np.int32),
            np.asarray(weights, np.float32))


def _fit_ab(min_dist: float, spread: float):
    """Least-squares fit of 1 / (1 + a d^{2b}) to the target membership
    curve (umap-learn's find_ab_params); the defaults' values without a fit."""
    if abs(min_dist - 0.1) < 1e-12 and abs(spread - 1.0) < 1e-12:
        return _DEFAULT_AB
    from scipy.optimize import curve_fit

    xs = np.linspace(0, spread * 3, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)),
                          xs, ys, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


def _optimize_layout(emb0, heads, tails, weights, *, a, b, n_epochs, neg_rate, lr, seed,
                     device="cuda", draws=None):
    """The UMAP cross-entropy SGD, epoch by epoch on `device`, float32, as
    the JAX package's jitted loop. `draws`: (u, negs), u (n_epochs, edges)
    uniform in [0, 1) (an edge fires where u < w / w_max) and negs
    (n_epochs, edges, neg_rate) point indices, to hand in the random draws;
    by default they come from a torch.Generator seeded with `seed`."""
    device = torch.device(device)
    emb = torch.as_tensor(np.asarray(emb0, np.float32), device=device)
    heads = torch.as_tensor(np.asarray(heads), dtype=torch.long, device=device)
    tails = torch.as_tensor(np.asarray(tails), dtype=torch.long, device=device)
    p_edge = torch.as_tensor(weights / max(float(weights.max()), 1e-12), device=device)
    n = emb.shape[0]
    n_edges = heads.shape[0]
    gen = None
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    else:
        draws = [torch.as_tensor(np.asarray(d), device=device) for d in draws]
    for i in range(n_epochs):
        alpha = lr * (1.0 - i / n_epochs)
        if gen is None:
            u, negs = draws[0][i].to(torch.float32), draws[1][i].to(torch.long)
        else:
            u = torch.rand(n_edges, generator=gen, device=device)
            negs = torch.randint(0, n, (n_edges, neg_rate), generator=gen, device=device)
        keep = (u < p_edge).to(torch.float32)

        yh, yt = emb[heads], emb[tails]
        diff = yh - yt
        d2 = (diff * diff).sum(-1).clamp_min(1e-12)
        grad_coef = -2.0 * a * b * d2.pow(b - 1.0) / (1.0 + a * d2.pow(b))
        g = torch.clamp(grad_coef[:, None] * diff, -4.0, 4.0) * keep[:, None]
        upd = torch.zeros_like(emb)
        upd.index_add_(0, heads, g)
        upd.index_add_(0, tails, -g)

        diff_n = yh[:, None, :] - emb[negs]  # (edges, neg_rate, dim)
        d2n = (diff_n * diff_n).sum(-1)
        rep_coef = 2.0 * b / ((0.001 + d2n) * (1.0 + a * d2n.clamp_min(1e-12).pow(b)))
        gn = torch.clamp(rep_coef[..., None] * diff_n, -4.0, 4.0)
        # umap-learn layouts.py: a negative on its head's spot (not the head
        # itself) repels by a fixed +4 per dimension; a sampled self-pair not
        coincident = (d2n <= 0.0) & (negs != heads[:, None])
        gn = torch.where(coincident[..., None], torch.full_like(gn, 4.0), gn)
        upd.index_add_(0, heads, (gn * keep[:, None, None]).sum(1))
        emb = emb + alpha * upd
    return emb.cpu().numpy()


class UMAP:
    """umap.UMAP on the arguments the reference uses; the layout runs on
    `device`."""

    def __init__(self, n_neighbors: int = 15, n_components: int = 2, min_dist: float = 0.1,
                 spread: float = 1.0, n_epochs: int = 200, negative_sample_rate: int = 5,
                 learning_rate: float = 1.0, random_state: int = 0, device="cuda"):
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.negative_sample_rate = negative_sample_rate
        self.learning_rate = learning_rate
        self.random_state = random_state
        self.device = device

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32).reshape(len(x), -1)
        n = x.shape[0]
        if n <= self.n_components:
            return x[:, : self.n_components]
        k = min(self.n_neighbors, n - 1)
        idx, dists = _knn(x, k)
        heads, tails, weights = _fuzzy_graph(idx, dists, k)
        a, b = _fit_ab(self.min_dist, self.spread)
        return _optimize_layout(
            pca_init(x, self.n_components, self.random_state), heads, tails, weights, a=a, b=b,
            n_epochs=self.n_epochs, neg_rate=self.negative_sample_rate, lr=self.learning_rate,
            seed=self.random_state, device=self.device)


def pca_init(x: np.ndarray, n_components: int, random_state: int) -> np.ndarray:
    """The layout's start: the PCA projection scaled to the +-10 box that
    umap-learn uses, jittered by normal(0, 1e-4) from `random_state`."""
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    emb0 = xc @ vt[:n_components].T
    scale = np.abs(emb0).max() or 1.0
    emb0 = emb0 / scale * 10.0
    emb0 += np.random.default_rng(random_state).normal(0, 1e-4, emb0.shape)
    return emb0
