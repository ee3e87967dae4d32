"""MVAE: the product-of-experts multimodal VAE of Wu & Goodman
(mmvae_tpu/models/mvae.py; reference models/mvae/mvae.py).

The forward builds its own ELBO: one unimodal ELBO per modality on the PoE
of that expert with the prior, then the joint ELBO on the PoE of every
expert with the prior, and with `subsampling` (three or more modalities)
the ELBO of `k_subsample` modality subsets drawn at random. Samplers take
their noise explicitly, `noise=[z_0, z_1, ..., z_joint]` in the JAX
package's draw order (with subsampling followed by the subsets' 0/1 mask
and one z per subset), or draw it from `generator`.
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

    def forward(self, x, K: int = 1, noise=None, generator=None, block=None):
        """ELBO-building forward (mvae.py:73-139). K is not used. Returns
        dict(elbo, z_joint, joint_mu, joint_std).

        With subsampling, the JAX package draws a random 0/1 mask with
        `k_subsample` ones over `all_subsets`, from a permutation, and adds
        every subset's ELBO times its mask entry: the same expectation as
        the reference's k random subsets per step (mvae.py:114-130). Here the
        mask is noise[n_mod + 1], (S,), and subset s's sample noise
        noise[n_mod + 2 + s]; only the subsets the mask selects are
        computed, which gives the same value and gradients. `block`: x is
        this rank's block of a batch sharded over ranks (parallel/mesh.py);
        a drawn mask is then rank 0's on every rank, one draw per global
        batch as in the JAX package."""
        subsets = all_subsets(self.n_mod) if self.subsampling else []
        n_noise = self.n_mod + 1 + (1 + len(subsets) if subsets else 0)
        noise = [None] * n_noise if noise is None else list(noise)
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

        if subsets:
            mask = noise[self.n_mod + 1]
            if mask is None:
                sel = torch.randperm(len(subsets), generator=generator, device=joint_mu.device)
                mask = torch.zeros(len(subsets), dtype=joint_mu.dtype, device=joint_mu.device)
                mask[sel[: self.k_subsample]] = 1.0
                if block is not None:
                    block.mesh.broadcast_(mask)
            for si in torch.nonzero(mask).flatten().tolist():
                s = subsets[si]
                mu, std = poe([mus[i] for i in s], [log_vars[i] for i in s])
                sub_z = D.normal_sample(LocScale(mu, std), eps=noise[self.n_mod + 2 + si],
                                        generator=generator)
                term = -self._kl(mu, std)
                for m in s:
                    term = term + self._sq_err(m, x[m], self.vaes[m].decode(sub_z))
                elbo = elbo + mask[si] * term
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
