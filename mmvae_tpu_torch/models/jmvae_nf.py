"""JMVAE-NF: a joint encoder with normalizing-flow unimodal posteriors, the
reference paper's model (mmvae_tpu/models/jmvae_nf.py; reference
models/jmvae_nf/jmvae_nf.py).

Samplers take their standard-normal noise explicitly or draw it from
`generator`, as in MMVAE. Epoch-phase freezing is the Trainer's (an
optimizer over the trainable parameters only, train/freezing.py); the
DCCA-filtered reconstruction loss runs the frozen DCCA encoders with their
target side under no_grad.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Sequence

import torch
from torch import nn

from ..core import distributions as D
from ..core.constants import LOG2PI
from ..core.distributions import LocScale
from .vae import UnimodalVAE, encoder_posteriors, gaussian_log_q_z0


class JMVAE_NF(nn.Module):
    def __init__(self, joint_encoder: nn.Module, vaes: Sequence[UnimodalVAE],
                 posterior: str = "normal", dcca_encoders: Optional[Sequence[nn.Module]] = None):
        super().__init__()
        self.joint_encoder = joint_encoder
        self.vaes = nn.ModuleList(vaes)
        # registered AFTER `vaes`: the DCCA encoders are the same modules as
        # the unimodal TwoStepsEncoders' trunks, and named_parameters() lists
        # a shared module once, under its first name. That name must be
        # vaes.i.encoder.first_encoder..., which the freezing prefix
        # "first_encoder" matches.
        self.dcca_encoders = None if dcca_encoders is None else nn.ModuleList(dcca_encoders)
        self.posterior = posterior  # qz_xy family (params.dist)

    @property
    def n_mod(self):
        return len(self.vaes)

    def encode_joint(self, x):
        """q(z|x,y) params (mu, std) from the joint encoder."""
        return self.joint_encoder(x)

    def forward(self, x, K: int = 1, noise=None, generator=None):
        """Joint forward (jmvae_nf.py:41-52): encode jointly, sample once,
        decode every modality. Returns dict(qz_xy=(mu, std), z_xy, recons).
        noise: the joint sample's standard-normal noise."""
        mu, std = self.encode_joint(x)
        shape = (K,) if K > 1 else ()
        z_xy = D.sample(self.posterior, LocScale(mu, std), shape, noise=noise, generator=generator)
        return {"qz_xy": (mu, std), "z_xy": z_xy,
                "recons": [vae.decode(z_xy) for vae in self.vaes]}

    def unimodal_log_q(self, m: int, x_m, z):
        """ln q_flow(z | x_m): the flow's density direction plus the base
        gaussian's density at z0 (jmvae_nf.py:64-71)."""
        z0, ldj = self.vaes[m].flow_forward(z)
        mu, log_var = self.vaes[m].encode(x_m)
        return gaussian_log_q_z0(mu, log_var, z0) + ldj

    def compute_kld(self, x, no_recon: bool = False, beta_kl: float = 1.0,
                    stop_joint_grad: bool = False, noise=None, generator=None):
        """KL(q(z|x,y) || q_flow(z|x_m)) regularizer plus, unless
        `no_recon`, the unimodal reconstruction terms (jmvae_nf.py:56-85).
        Returns (reg, details) with kld_{m} and recon_loss_{m}.

        As in the JAX package, only the joint ENCODER runs here, not a second
        full joint forward: that forward's reconstructions are used by no
        caller. `stop_joint_grad` (the objective sets it when the joint
        encoder and the decoders are both frozen) runs the joint encoder
        without a gradient: the frozen parameters' gradients would be
        dropped anyway, so the trainable ones are unchanged.

        noise: [joint sample, then one per modality for the unimodal VAE
        forwards], standard normal, or None to draw from `generator`."""
        noise = [None] * (1 + self.n_mod) if noise is None else list(noise)
        with torch.no_grad() if stop_joint_grad else nullcontext():
            mu, std = self.encode_joint(x)
            z_xy = D.sample(self.posterior, LocScale(mu, std), noise=noise[0],
                            generator=generator)
        lq_xy = torch.sum(D.log_prob(self.posterior, LocScale(mu, std), z_xy))
        reg = 0.0
        details = {}
        for m, vae in enumerate(self.vaes):
            kld_m = lq_xy - torch.sum(self.unimodal_log_q(m, x[m], z_xy))
            details[f"kld_{m}"] = kld_m
            if no_recon:
                reg = reg + beta_kl * kld_m
            else:
                vout = vae(x[m], noise=noise[1 + m], generator=generator)
                rl = self.compute_recon_loss(m, x[m], vout["recon"])
                details[f"recon_loss_{m}"] = rl
                reg = reg + beta_kl * kld_m + rl
        return reg, details

    def compute_recon_loss(self, m: int, x_m, recon):
        """Squared error in pixel space, or in the DCCA embedding space when
        DCCA encoders are attached (jmvae_nf.py:147-162)."""
        if self.dcca_encoders is not None:
            enc = self.dcca_encoders[m]
            with torch.no_grad():
                t = enc(x_m)
            return torch.sum((t - enc(recon)) ** 2)
        n = x_m.shape[0]
        return torch.sum((x_m.reshape(n, -1) - recon.reshape(n, -1)) ** 2)

    def dcca_embeddings(self, x):
        """LCCA-projected DCCA trunk outputs per modality."""
        return [enc(x[m]) for m, enc in enumerate(self.dcca_encoders)]

    def encode_all_unimodal(self, x):
        """Per-modality posterior params [(mu, std)]."""
        return encoder_posteriors(self.vaes, x)

    def vae_forward(self, x_m, m: int, K: int = 1, noise=None, generator=None):
        """Full forward of unimodal VAE m (jmvae_nf.py:134-137)."""
        return self.vaes[m](x_m, K, noise=noise, generator=generator)

    def vae_forward_by_mod(self, x_m, m: int, K: int = 1, noise=None, generator=None):
        """Unimodal VAE m's forward for the likelihood estimators
        (jmvae_nf.py:139-141), up to the latent: they read no recon."""
        return self.vaes[m].sample_posterior(x_m, K, noise=noise, generator=generator)

    def infer_latent_from_mod(self, cond_mod: int, x, K: int = 1, noise=None, generator=None):
        """A sample of the flow posterior q(z|x_m); K > 1 adds a leading axis."""
        return self.vaes[cond_mod].sample_posterior(x, K, noise=noise, generator=generator)["z"]

    def decode_all(self, z):
        return [vae.decode(z) for vae in self.vaes]

    def poe_density(self, subset, x, divide_prior: bool = True):
        """z -> the log density of the product of the flow-posterior experts
        in `subset` given x, for Hamiltonian sampling (jmvae_nf.py:294-329).
        The experts' encoders run once, here, not at each evaluation: their
        outputs do not depend on z."""
        experts = [(m, self.vaes[m].encode(x[m])) for m in subset]

        def log_density(z):
            lnqzs = z.new_zeros(z.shape[:-1])
            if divide_prior:
                lnqzs = lnqzs + torch.sum(0.5 * (z ** 2 + LOG2PI), dim=-1)
            for m, (mu, log_var) in experts:
                z0, ldj = self.vaes[m].flow_forward(z)
                lnqzs = lnqzs + gaussian_log_q_z0(mu, log_var, z0) + ldj
            return lnqzs

        return log_density
