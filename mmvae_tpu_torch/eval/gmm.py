"""Gaussian-mixture latent sampler (mmvae_tpu/eval/gmm.py; reference
models/samplers/gaussian_mixture/gaussian_mixture_sampler.py): a
full-covariance mixture of 10 components fitted on train latents, sampled
for prior-replacement generation (multi_vaes.py:92-93,
generate_joint.py:107-114).

The fit is the port's own EM (eval/cluster.py) in float64 on the latents'
device, in place of scikit-learn's GaussianMixture; its k-means start and
the samples draw from `torch.Generator`s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import cluster


class GaussianMixtureSampler:
    """A full-covariance Gaussian mixture with `n_components` components
    (the reference's default 10). Without a generator, `fit` seeds its
    k-means start with 0, as the JAX package's random_state=0 does."""

    def __init__(self, n_components: int = 10):
        self.n_components = n_components
        self.params: Optional[cluster.GMMParams] = None
        self.fit_result: Optional[cluster.GMMFit] = None

    def fit(self, latents, generator: Optional[torch.Generator] = None, init=None):
        """EM on `latents` (n, d), in float64 on their device; `init` =
        (weights, means, precisions) starts it there instead of at k-means."""
        x = cluster.as_float64(latents)
        if generator is None and init is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        self.fit_result = cluster.fit_gaussian_mixture(x, self.n_components, generator=generator,
                                                       init=init)
        return self._set(self.fit_result.params)

    @classmethod
    def from_params(cls, weights, means, covariances, device=None):
        """A sampler with the given mixture (weights (k,), means (k, d),
        covariances (k, d, d)), in float64 on `device`."""
        w, m, c = (cluster.as_float64(a, device) for a in (weights, means, covariances))
        self = cls(n_components=len(w))
        return self._set(cluster.GMMParams(
            w, m, c, cluster.precisions_cholesky_from_covariances(c)))

    def _set(self, params: cluster.GMMParams):
        self.params = params
        self._chol = torch.linalg.cholesky(params.covariances)
        return self

    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None,
               dtype=torch.float32) -> torch.Tensor:
        """(num_samples, d) draws in `dtype`, grouped by component as
        scikit-learn returns them: the component of each draw from the
        weights, then mean + L eps with L L^T the component's covariance."""
        assert self.params is not None, "fit() first"
        w = self.params.weights
        comp, _ = torch.sort(torch.multinomial(w, num_samples, replacement=True,
                                               generator=generator))
        eps = torch.randn(num_samples, self.params.means.shape[1],
                          generator=generator, device=w.device, dtype=w.dtype)
        z = self.params.means[comp] + (self._chol[comp] @ eps[:, :, None])[:, :, 0]
        return z.to(dtype)

    def log_prob(self, z) -> torch.Tensor:
        """ln p(z) per row (scikit-learn's score_samples), float64."""
        assert self.params is not None, "fit() first"
        x = cluster.as_float64(z, self.params.means.device)
        return torch.logsumexp(cluster.weighted_log_prob(x, self.params), 1)


def fit_sampler_on_train_latents(loader, infer_fn, n_components: int = 10,
                                 generator: Optional[torch.Generator] = None):
    """Every batch of `loader` through `infer_fn(xs) -> latents` (the
    family's latent rule), then a GaussianMixtureSampler fitted on them
    (multi_vaes/jmvae_nf compute_all_train_latents; generate_joint.py:107-114).
    Returns (sampler, latents (n, d) tensor, labels (n,) numpy)."""
    lat, labs = [], []
    for xs, ls in loader:
        lat.append(infer_fn(xs))
        labs.append(np.asarray(ls[0]))
    latents = torch.cat(lat)
    labels = np.concatenate(labs)
    sampler = GaussianMixtureSampler(n_components).fit(latents, generator=generator)
    return sampler, latents, labels

