"""MVAE: the product-of-experts multimodal VAE of Wu & Goodman
(mmvae_tpu/models/mvae.py; reference models/mvae/mvae.py).

The forward builds its own ELBO: one unimodal ELBO per modality on the PoE
of that expert with the prior, then the joint ELBO on the PoE of every
expert with the prior. Samplers take their standard-normal noise
explicitly, `noise=[z_0, z_1, ..., z_joint]` in the JAX package's draw
order, or draw it from `generator`.
"""

from __future__ import annotations

from itertools import combinations
from typing import Sequence

import torch
from torch import nn

from ..core import distributions as D
from ..core.distributions import LocScale
from .poe import poe
from .vae import UnimodalVAE, encoder_posteriors


def all_subsets(n_mod: int):
    """The modality subsets of size in [2, n_mod) that subsampling draws
    from (mvae.py:114-130); none for two modalities."""
    return [list(s) for k in range(2, n_mod) for s in combinations(range(n_mod), k)]


class MVAE(nn.Module):
    def __init__(self, vaes: Sequence[UnimodalVAE], lik_scaling: Sequence[float],
                 subsampling: bool = False, k_subsample: int = 0):
        super().__init__()
        if subsampling and all_subsets(len(vaes)):
            raise NotImplementedError("MVAE subset subsampling runs only on three or more "
                                      "modalities: the trimodal slice is not yet ported")
        self.vaes = nn.ModuleList(vaes)
        self.lik_scaling = tuple(lik_scaling)
        # a no-op with two modalities, whose subsets of subsampling are none
        self.subsampling = subsampling
        self.k_subsample = k_subsample

    @property
    def n_mod(self):
        return len(self.vaes)

    @staticmethod
    def _kl(mu, std):
        """KL(N(mu, std) || N(0, 1)) summed over batch and latent (mvae.py:60-61)."""
        return torch.sum(D.normal_kl(LocScale(mu, std),
                                     LocScale(torch.zeros_like(mu), torch.ones_like(std))))

    def _sq_err(self, m: int, x_m, recon):
        """-0.5 sum (x - recon)^2, scaled: the unit Gaussian's log-density
        without its 2 pi constant (mvae.py:96)."""
        return -0.5 * torch.sum((x_m - recon) ** 2) * self.lik_scaling[m]

    def forward(self, x, K: int = 1, noise=None, generator=None):
        """ELBO-building forward (mvae.py:73-139). K is not used. Returns
        dict(elbo, z_joint, joint_mu, joint_std)."""
        noise = [None] * (self.n_mod + 1) if noise is None else list(noise)
        mus, log_vars = [], []
        elbo = 0.0
        for m, vae in enumerate(self.vaes):
            mu_m, lv_m = vae.encode(x[m])
            mus.append(mu_m)
            log_vars.append(lv_m)
            mu, std = poe([mu_m], [lv_m])
            z = D.normal_sample(LocScale(mu, std), eps=noise[m], generator=generator)
            elbo = elbo + self._sq_err(m, x[m], vae.decode(z)) - self._kl(mu, std)

        joint_mu, joint_std = poe(mus, log_vars)
        z_joint = D.normal_sample(LocScale(joint_mu, joint_std), eps=noise[self.n_mod],
                                  generator=generator)
        for m, vae in enumerate(self.vaes):
            elbo = elbo + self._sq_err(m, x[m], vae.decode(z_joint))
        elbo = elbo - self._kl(joint_mu, joint_std)
        return {"elbo": elbo, "z_joint": z_joint, "joint_mu": joint_mu, "joint_std": joint_std}

    def encode_all(self, x):
        """Per-modality RAW encoder posterior params [(mu, std)], not the
        PoE with the prior: the proposal of the bis protocol, a reference
        quirk that the JAX package keeps (mvae.py:171-179)."""
        return encoder_posteriors(self.vaes, x)

    def infer_latent_from_mod(self, cond_mod: int, x, K: int = 1, noise=None, generator=None):
        """A sample of the PoE of expert `cond_mod` with the prior
        (mvae.py:64-70); K > 1 adds a leading axis of K samples."""
        mu_m, lv_m = self.vaes[cond_mod].encode(x)
        mu, std = poe([mu_m], [lv_m])
        shape = (K,) if K > 1 else ()
        return D.normal_sample(LocScale(mu, std), shape, eps=noise, generator=generator)

    def decode_all(self, z):
        return [vae.decode(z) for vae in self.vaes]

    def poe_subset_params(self, subset, x):
        """(mu, std) of the PoE of the experts in `subset` with the prior
        (mvae.py:268-301); x[m] is read for m in subset only."""
        encoded = [self.vaes[m].encode(x[m]) for m in subset]
        return poe([e[0] for e in encoded], [e[1] for e in encoded])
