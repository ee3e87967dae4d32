"""Unimodal VAE with an optional posterior flow (mmvae_tpu/models/vae.py).

`flow=None` is the plain VAE; `flow=MAF(...)/IAF(...)` the flow-augmented
sampling path (reference vae_iaf_model_adapted.py:60-103);
`posterior="laplace"` the softmax-std Laplace posterior (laplace_vae.py:69).
Sampling takes the posterior family's noise explicitly (`noise`: standard
normal for "normal", uniform in (-1 + 1e-7, 1) for "laplace"; see
core/distributions.py), or draws it from `generator`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import distributions as D
from ..core.constants import LOG2PI
from ..core.distributions import LocScale


def gaussian_log_q_z0(mu, log_var, z0):
    """log N(z0; mu, exp(log_var)) summed over the latent dim, with the
    2*pi constant (JMVAE-NF, jmvae_nf.py:68; MMVAE-NF drops it, see
    models/mmvae_nf.py)."""
    return torch.sum(-0.5 * (log_var + LOG2PI + (z0 - mu) ** 2 / torch.exp(log_var)), dim=-1)


def encoder_posteriors(vaes, x):
    """Each VAE's encoder posterior params [(mu, std)] on its modality x[m]."""
    params = []
    for m, vae in enumerate(vaes):
        mu, log_var = vae.encode(x[m])
        params.append((mu, vae.posterior_std(log_var)))
    return params


class UnimodalVAE(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, latent_dim: int,
                 flow: Optional[nn.Module] = None, posterior: str = "normal",
                 model_name: str = "vae"):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.flow = flow
        self.latent_dim = latent_dim
        self.posterior = posterior
        self.model_name = model_name

    def posterior_std(self, log_var):
        if self.posterior == "laplace":
            return D.std_softmax_trick(log_var)
        return D.std_from_logvar(log_var)

    def encode(self, x):
        """-> (mu, log_var)."""
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def flow_forward(self, z):
        """Density direction z -> z0 with log|det J|."""
        if self.flow is None:
            return z, z.new_zeros(z.shape[:-1])
        return self.flow(z)

    def flow_inverse(self, z0):
        """Sampling direction z0 -> z with log|det J|."""
        if self.flow is None:
            return z0, z0.new_zeros(z0.shape[:-1])
        return self.flow.inverse(z0)

    def encode_and_sample(self, x, K: int = 1, noise=None, generator=None):
        """Posterior params + K samples (leading axis K)."""
        mu, log_var = self.encode(x)
        std = self.posterior_std(log_var)
        z0 = D.sample(self.posterior, LocScale(mu, std), (K,), noise=noise, generator=generator)
        z, ldj = self.flow_inverse(z0)
        return (mu, std), z, ldj

    def sample_posterior(self, x, K: int = 1, noise=None, generator=None):
        """The forward pass up to the latent, without decoding: mu, log_var,
        std, z0, z, log_abs_det_jac. Encoding runs once; the leading sample
        axis K is present only when K > 1."""
        mu, log_var = self.encode(x)
        std = self.posterior_std(log_var)
        shape = (K,) if K > 1 else ()
        z0 = D.sample(self.posterior, LocScale(mu, std), shape, noise=noise, generator=generator)
        z, ldj = self.flow_inverse(z0)
        return {"mu": mu, "log_var": log_var, "std": std, "z0": z0, "z": z,
                "log_abs_det_jac": ldj}

    def forward(self, x, K: int = 1, noise=None, generator=None):
        """Full forward pass: `sample_posterior`, plus recon, the decoded z."""
        out = self.sample_posterior(x, K, noise=noise, generator=generator)
        return {"recon": self.decode(out["z"]), **out}
