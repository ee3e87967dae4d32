"""MMVAE-NF: MMVAE with flow-transformed unimodal posteriors
(mmvae_tpu/models/mmvae_nf.py; reference mmvae_nf.py:29-61)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .vae import UnimodalVAE


def gaussian_log_q_z0_noconst(mu, log_var, z0):
    """log N(z0; mu, var) WITHOUT the 2*pi constant: the reference drops it
    in MMVAE-NF (mmvae_nf.py:46-48) and pairs it with a constant-free prior
    term in m_elbo_nf."""
    return torch.sum(-0.5 * (log_var + (z0 - mu) ** 2 / torch.exp(log_var)), dim=-1)


class MMVAE_NF(nn.Module):
    def __init__(self, vaes: Sequence[UnimodalVAE]):
        super().__init__()
        self.vaes = nn.ModuleList(vaes)

    @property
    def n_mod(self):
        return len(self.vaes)

    def forward(self, x, K: int = 1, noise: Optional[Sequence] = None, generator=None):
        """Returns dict(ln_qz_xs, zs, recons), recons[e][d] the cross matrix.
        Each VAE runs at K=1, as in the reference: K does not reach it.
        noise: optional per-modality standard-normal noise, (B, latent) each."""
        n = self.n_mod
        recons = [[None] * n for _ in range(n)]
        zs, ln_qz_xs = [], []
        for m, vae in enumerate(self.vaes):
            o = vae(x[m], noise=None if noise is None else noise[m], generator=generator)
            recons[m][m] = o["recon"]
            zs.append(o["z"])
            ln_qz_xs.append(
                gaussian_log_q_z0_noconst(o["mu"], o["log_var"], o["z0"]) - o["log_abs_det_jac"])
        for e, z in enumerate(zs):
            for d, vae in enumerate(self.vaes):
                if e != d:
                    recons[e][d] = vae.decode(z)
        return {"ln_qz_xs": ln_qz_xs, "zs": zs, "recons": recons}

    def infer_latent_from_mod(self, cond_mod: int, x, K: int = 1, noise=None, generator=None):
        """A sample of the flow posterior q(z|x_m), through the flow's
        sampling direction (mmvae_nf.py:46-47); K > 1 adds a leading axis."""
        return self.vaes[cond_mod].sample_posterior(x, K, noise=noise, generator=generator)["z"]

    def decode_all(self, z):
        return [vae.decode(z) for vae in self.vaes]
