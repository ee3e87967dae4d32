"""k-means and a full-covariance Gaussian mixture fitted by EM, as plain
tensor code in float64 on the caller's device: the port's own copies of the
two scikit-learn estimators the JAX package calls
(`sklearn.cluster.MiniBatchKMeans` in mmvae_tpu/eval/prd.py:28 and
`sklearn.mixture.GaussianMixture` in mmvae_tpu/eval/gmm.py:21).

k-means: greedy k-means++ seeding from a `torch.Generator` (2 + ln k local
trials per center, scikit-learn's rule), Lloyd iterations until the labels
stop changing or the squared center shift falls to 1e-4 times the mean
feature variance, and `n_init` restarts that keep the least inertia. The
data are centered first, as scikit-learn centers them. Full-batch Lloyd
takes the place of MiniBatchKMeans: it reaches an inertia at least as low.

EM: scikit-learn's GaussianMixture(covariance_type="full") with its defaults
(reg_covar 1e-6, tol 1e-3, max_iter 100, one init): responsibilities
initialised from a k-means labelling, then E and M steps until the change
in the mean log-likelihood (the lower bound, taken in the E step before each
M step) falls below 1e-3. Precisions are kept as the upper-triangular
factors U of each precision matrix (U U^T = Sigma^-1), computed through
`torch.linalg.cholesky` of each covariance, as scikit-learn computes them.
Initial weights, means and precisions can be given instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# scikit-learn's defaults, which every caller of the JAX package uses
KMEANS_MAX_ITER, KMEANS_TOL = 300, 1e-4
EM_REG_COVAR, EM_TOL, EM_MAX_ITER = 1e-6, 1e-3, 100


def as_float64(x, device=None) -> torch.Tensor:
    """`x` (a tensor or an array) as a float64 tensor on `device`, by
    default the tensor's own (the CPU for an array)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (k, d)
    labels: torch.Tensor   # (n,) int64
    inertia: float         # sum of squared distances to the assigned centers
    n_iter: int


def _sq_dist(x, x_sq, c):
    """(n, k) squared distances ||x||^2 - 2 x.c + ||c||^2, clipped at 0."""
    return torch.clamp_min(x_sq[:, None] - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :], 0.0)


def kmeans_plusplus(x: torch.Tensor, n_clusters: int, generator: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ centers (k, d) of `x` (sklearn's _kmeans_plusplus):
    the first center uniform, each next one the best of 2 + ln k candidates
    drawn with probability proportional to the squared distance to the
    nearest center so far."""
    n = x.shape[0]
    n_local_trials = 2 + int(math.log(n_clusters))
    x_sq = (x * x).sum(1)
    first = torch.randint(n, (1,), generator=generator, device=x.device)
    centers = [x[first]]
    closest = _sq_dist(x, x_sq, centers[0])[:, 0]
    pot = closest.sum()
    for _ in range(1, n_clusters):
        r = torch.rand(n_local_trials, generator=generator, device=x.device, dtype=x.dtype) * pot
        cand = torch.clamp_max(torch.searchsorted(torch.cumsum(closest, 0), r), n - 1)
        dist = torch.minimum(closest[None, :], _sq_dist(x, x_sq, x[cand]).T)  # (trials, n)
        cand_pot = dist.sum(1)
        best = torch.argmin(cand_pot)
        pot, closest = cand_pot[best], dist[best]
        centers.append(x[cand[best]][None])
    return torch.cat(centers)


def _lloyd(x, x_sq, centers, tol: float):
    """Lloyd iterations from `centers`; stops when the labels repeat or the
    squared center shift is <= tol (sklearn's _kmeans_single_lloyd). An
    empty cluster takes the point farthest from its own center."""
    k = centers.shape[0]
    labels_old = None
    strict = False
    n_iter = 0
    for n_iter in range(1, KMEANS_MAX_ITER + 1):
        d = _sq_dist(x, x_sq, centers)
        labels = torch.argmin(d, 1)
        counts = torch.bincount(labels, minlength=k)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        new = sums / torch.clamp_min(counts, 1)[:, None].to(x.dtype)
        empty = counts == 0
        if bool(empty.any()):
            far = torch.argsort(d.gather(1, labels[:, None])[:, 0], descending=True)
            new[empty] = x[far[: int(empty.sum())]]
        shift = ((new - centers) ** 2).sum()
        centers = new
        same = labels_old is not None and bool(torch.equal(labels, labels_old))
        if same:
            strict = True
            break
        if float(shift) <= tol:
            break
        labels_old = labels
    if not strict:
        labels = torch.argmin(_sq_dist(x, x_sq, centers), 1)
    inertia = float(((x - centers[labels]) ** 2).sum())
    return centers, labels, inertia, n_iter


def kmeans(x, n_clusters: int, n_init: int = 10, generator: Optional[torch.Generator] = None,
           init=None) -> KMeansResult:
    """k-means of the rows of `x` in float64 on x's device: `n_init` runs
    from k-means++ seeds drawn from `generator` (seeded 0 on x's device when
    None), or one run from the given `init` centers (k, d); the run with the
    least inertia is kept."""
    x = as_float64(x)
    mean = x.mean(0)
    xc = x - mean
    x_sq = (xc * xc).sum(1)
    tol = float(torch.var(xc, 0, unbiased=False).mean()) * KMEANS_TOL
    if init is not None:
        starts = [as_float64(init, x.device) - mean]
    else:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        starts = [None] * n_init
    best = None
    for start in starts:
        c0 = kmeans_plusplus(xc, n_clusters, generator) if start is None else start
        centers, labels, inertia, n_iter = _lloyd(xc, x_sq, c0, tol)
        if best is None or inertia < best.inertia:
            best = KMeansResult(centers + mean, labels, inertia, n_iter)
    return best


# ---------------------------------------------------------------------------
# Gaussian mixture (full covariances) by EM
# ---------------------------------------------------------------------------

class GMMParams(NamedTuple):
    weights: torch.Tensor              # (k,)
    means: torch.Tensor                # (k, d)
    covariances: Optional[torch.Tensor]  # (k, d, d); None until the first M step
    precisions_cholesky: torch.Tensor  # (k, d, d), upper triangular


class GMMFit(NamedTuple):
    params: GMMParams
    n_iter: int
    lower_bound: float
    converged: bool


def _eye_like(a):
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)


def precisions_cholesky_from_covariances(cov: torch.Tensor) -> torch.Tensor:
    """U = L^-T for each covariance L L^T (sklearn's _compute_precision_cholesky)."""
    chol, info = torch.linalg.cholesky_ex(cov)
    if bool((info != 0).any()):
        raise ValueError("Fitting the mixture model failed because some components have "
                         "ill-defined empirical covariance")
    return torch.linalg.solve_triangular(chol, _eye_like(cov), upper=False).mT


def precisions_cholesky_from_precisions(prec: torch.Tensor) -> torch.Tensor:
    """The upper-triangular U with U U^T = prec, by the Cholesky factor of the
    precision with rows and columns reversed (sklearn's
    _compute_precision_cholesky_from_precisions)."""
    return torch.linalg.cholesky(prec.flip(-1, -2)).flip(-1, -2)


def estimate_gaussian_parameters(x, resp):
    """(nk, means, covariances) of the responsibilities `resp` (n, k)."""
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    diff = x[None, :, :] - means[:, None, :]                    # (k, n, d)
    cov = (resp.T[:, :, None] * diff).mT @ diff / nk[:, None, None]
    cov = cov + EM_REG_COVAR * _eye_like(cov)
    return nk, means, cov


def log_gaussian_prob(x, means, precisions_cholesky):
    """(n, k) log N(x | mean_k, Sigma_k) from the precision factors."""
    d = x.shape[1]
    log_det = torch.log(torch.diagonal(precisions_cholesky, dim1=-2, dim2=-1)).sum(-1)
    y = x[None] @ precisions_cholesky - means[:, None, :] @ precisions_cholesky  # (k, n, d)
    return -0.5 * (d * math.log(2 * math.pi) + (y * y).sum(-1).T) + log_det


def weighted_log_prob(x, params: GMMParams):
    return log_gaussian_prob(x, params.means, params.precisions_cholesky) + \
        torch.log(params.weights)


def e_step(x, params: GMMParams):
    """(mean log-likelihood tensor, log responsibilities (n, k))."""
    w = weighted_log_prob(x, params)
    norm = torch.logsumexp(w, 1)
    return norm.mean(), w - norm[:, None]


def m_step(x, log_resp) -> GMMParams:
    nk, means, cov = estimate_gaussian_parameters(x, torch.exp(log_resp))
    return GMMParams(nk / nk.sum(), means, cov, precisions_cholesky_from_covariances(cov))


def init_from_labels(x, labels, n_components: int) -> GMMParams:
    """The starting parameters of a one-hot responsibility matrix
    (sklearn's GaussianMixture._initialize): weights nk / n."""
    resp = torch.nn.functional.one_hot(torch.as_tensor(labels, device=x.device).long(),
                                       n_components).to(x.dtype)
    nk, means, cov = estimate_gaussian_parameters(x, resp)
    return GMMParams(nk / x.shape[0], means, cov, precisions_cholesky_from_covariances(cov))


def fit_gaussian_mixture(x, n_components: int = 10, generator: Optional[torch.Generator] = None,
                         init=None) -> GMMFit:
    """EM for a full-covariance Gaussian mixture of the rows of `x`, in
    float64 on x's device. Starts from `init` = (weights, means, precisions)
    where given, else from the labels of one k-means run (k-means++ seeded
    from `generator`)."""
    x = as_float64(x)
    if init is not None:
        weights, means, precisions = (as_float64(a, x.device) for a in init)
        params = GMMParams(weights, means, None, precisions_cholesky_from_precisions(precisions))
    else:
        labels = kmeans(x, n_components, n_init=1, generator=generator).labels
        params = init_from_labels(x, labels, n_components)
    lower_bound, converged, n_iter = -math.inf, False, 0
    for n_iter in range(1, EM_MAX_ITER + 1):
        prev = lower_bound
        norm, log_resp = e_step(x, params)
        params = m_step(x, log_resp)
        lower_bound = float(norm)
        if abs(lower_bound - prev) < EM_TOL:
            converged = True
            break
    return GMMFit(params, n_iter, lower_bound, converged)
