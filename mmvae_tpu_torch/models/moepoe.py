"""MoE-PoE: the generalized multimodal ELBO of Sutter et al. 2021
(mmvae_tpu/models/moepoe.py; reference models/moepoe/moepoe.py).

The mixture's components are the unimodal posteriors and the PoE of every
subset of at least two of them (the prior expert joins the full subset
only). Stratified selection gives each component its own rows of the
batch; one draw from the selected rows is decoded in every modality. The
ELBO is the reconstruction under the decoders' likelihoods less the mean KL
of all components, times `beta_kl`. The sampler takes its standard-normal
noise explicitly, `noise=[eps]` (one draw), or draws it from `generator`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core import distributions as D
from ..core.distributions import LocScale
from .poe import mixture_component_selection, poe_for_all_subsets
from .vae import UnimodalVAE, encoder_posteriors


class MOEPOE(nn.Module):
    def __init__(self, vaes: Sequence[UnimodalVAE], lik_scaling: Sequence[float],
                 recon_dists: Sequence[str], beta_kl: float = 1.0):
        super().__init__()
        self.vaes = nn.ModuleList(vaes)
        self.lik_scaling = tuple(lik_scaling)
        self.recon_dists = tuple(recon_dists)
        self.beta_kl = beta_kl  # fixed at build time, as in the JAX registry

    @property
    def n_mod(self):
        return len(self.vaes)

    def forward(self, x, K: int = 1, noise=None, generator=None, block=None):
        """ELBO-building forward (moepoe.py:85-139). K is not used. Returns
        dict(elbo, z_joint, mus, log_vars), the last two stacked over the
        mixture's components. `block`: x is this rank's block of a batch
        sharded over ranks (parallel/mesh.py), for the stratified selection."""
        mus, log_vars = [], []
        for m, vae in enumerate(self.vaes):
            mu_m, lv_m = vae.encode(x[m])
            mus.append(mu_m)
            log_vars.append(lv_m)
        poe_mus, poe_lvs = poe_for_all_subsets(mus, log_vars)
        mus, log_vars = mus + poe_mus, log_vars + poe_lvs

        mu_sel, lv_sel = mixture_component_selection(mus, log_vars, block)
        z = D.normal_sample(LocScale(mu_sel, torch.exp(0.5 * lv_sel)),
                            eps=None if noise is None else noise[0], generator=generator)

        elbo = 0.0
        for m, vae in enumerate(self.vaes):
            recon = vae.decode(z)
            lpx_z = torch.sum(D.log_prob(self.recon_dists[m],
                                         LocScale(recon, torch.ones_like(recon)), x[m]))
            elbo = elbo + lpx_z * self.lik_scaling[m]

        prior = LocScale(mu_sel.new_zeros(1), mu_sel.new_ones(1))
        for mu_i, lv_i in zip(mus, log_vars):
            kld = D.normal_kl(LocScale(mu_i, torch.exp(0.5 * lv_i)), prior)
            elbo = elbo - torch.sum(kld) * self.beta_kl / len(mus)
        return {"elbo": elbo, "z_joint": z, "mus": torch.stack(mus),
                "log_vars": torch.stack(log_vars)}

    def encode_all(self, x):
        """Per-modality encoder posterior params [(mu, std)]: the unimodal
        proposals of the likelihood protocol (moepoe.py:160-215)."""
        return encoder_posteriors(self.vaes, x)

    def infer_latent_from_mod(self, cond_mod: int, x, K: int = 1, noise=None, generator=None):
        """A sample of unimodal VAE `cond_mod`'s posterior; K > 1 adds a
        leading axis of K samples."""
        return self.vaes[cond_mod].sample_posterior(x, K, noise=noise, generator=generator)["z"]

    def decode_all(self, z):
        return [vae.decode(z) for vae in self.vaes]
