"""MMVAE: the mixture-of-experts multimodal VAE of Shi et al. 2019
(mmvae_tpu/models/mmvae.py; reference models/mmvae/mmvae.py).

The joint posterior is the uniform mixture of the unimodal posteriors. The
K-sample forward encodes each modality once and draws K posterior samples
from it, instead of replicating the inputs K-fold through the encoder: the
same math with K times less encoder work.

Samplers take one noise tensor per modality, `noise=[n_0, n_1, ...]`, of
the posterior family's kind (uniform u for "laplace", standard-normal eps
for "normal"; core/distributions.py), or draw it from `generator`.

`k_split` (None, or a mesh from `parallel.split_k`, which the Trainer
hands it) cuts the IWAE sample axis over the mesh's 'k' ranks, as JAX's
`zss_sharding` does (mmvae_tpu/models/mmvae.py:30,55-60), where n_k
divides K: each rank draws and decodes only its K / n_k samples, and the
objectives gather the log-weights over K. JAX's dry run sets it
(__graft_entry__.py:96); the train CLI never does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core import distributions as D
from ..core.distributions import LocScale
from ..parallel.mesh import k_split_of
from .vae import UnimodalVAE, encoder_posteriors


class MMVAE(nn.Module):
    def __init__(self, vaes: Sequence[UnimodalVAE], posterior: str = "normal"):
        super().__init__()
        self.vaes = nn.ModuleList(vaes)
        self.posterior = posterior  # params.dist: posterior AND prior family
        self.k_split = None

    @property
    def n_mod(self):
        return len(self.vaes)

    def encode_all(self, x):
        """Per-modality posterior params [(mu, std)] (mmvae.py:38-49)."""
        return encoder_posteriors(self.vaes, x)

    def encode_and_sample(self, x, K: int = 1, noise: Optional[Sequence] = None,
                          generator=None):
        """Posterior params + (M, K, B, D) samples. Split from decoding so
        that the DReG objectives can reweight the samples' gradient between
        the two (objectives.py:398-401). Under an active `k_split` the
        samples are this rank's K / n_k, (M, K / n_k, B, D): from `noise`
        when given (this rank's cut of the global noise), else the rank's
        cut of K draws from `generator`, which the k ranks of a data index
        share, so that together they hold the global K."""
        qz_params = self.encode_all(x)
        split = k_split_of(self, K)
        zss = []
        for m, (mu, std) in enumerate(qz_params):
            n = None if noise is None else noise[m]
            k = K
            if split is not None:
                k = K // split.n_k
                if n is None:
                    n = D.draw_noise(self.posterior, (K,) + mu.shape, generator, mu.device,
                                     mu.dtype)[split.k_samples(K)]
            zss.append(D.sample(self.posterior, LocScale(mu, std), (k,), noise=n,
                                generator=generator))
        return qz_params, torch.stack(zss)

    def decode_cross(self, zss):
        """M x M cross-reconstruction matrix: recons[e][d] = decoder_d(z_e)
        (mmvae.py:63-76)."""
        return [[vae.decode(zss[e]) for vae in self.vaes] for e in range(self.n_mod)]

    def forward(self, x, K: int = 1, noise: Optional[Sequence] = None, generator=None):
        """Full MMVAE forward (mmvae.py:31-80). Returns dict:
          qz_params: [(mu, std)] per modality, shapes (B, D)
          zss:       (M, K, B, D) posterior samples
          recons:    recons[e][d] = decoder_d(z_e), shape (K, B, *event_d)
        """
        qz_params, zss = self.encode_and_sample(x, K=K, noise=noise, generator=generator)
        return {"qz_params": qz_params, "zss": zss, "recons": self.decode_cross(zss)}

    def infer_latent_from_mod(self, cond_mod: int, x, K: int = 1, noise=None, generator=None):
        """A sample of q(z|x_m) (multi_vaes.py:71-79); K > 1 adds a leading
        axis of K samples. Nothing is decoded."""
        return self.vaes[cond_mod].sample_posterior(x, K, noise=noise, generator=generator)["z"]

    def decode_all(self, z):
        """Decode one latent in every modality (multi_vaes.py:94-95)."""
        return [vae.decode(z) for vae in self.vaes]
