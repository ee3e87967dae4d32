"""Plain reference of the MMVAE (Shi et al. 2019) on MNIST-SVHN as the JMVAE-NF
authors' code configures it (`configs_experiments/mnist_svhn/mmvae.json`,
`src/bivae/models/mmvae/mmvae_mnist_svhn.py`), not the MMVAE paper's own
setting (a 400-wide MNIST MLP, Laplace likelihoods of scale 0.75): pythae's
512-wide MNIST MLP, the SVHN conv nets, Laplace posteriors with the
softmax-std trick, a Laplace prior, unit-scale normal likelihoods, the MNIST
term scaled by 3*32*32 / (1*28*28); its DReG-looser training objective and
its importance-sampled likelihoods."""

from __future__ import annotations

import math

import torch
from torch import nn

from . import common as C


class MMVAE(nn.Module):
    def __init__(self, latent: int):
        super().__init__()
        self.latent = latent

        class VAE(nn.Module):
            def __init__(self, encoder, decoder):
                super().__init__()
                self.encoder, self.decoder = encoder, decoder

        self.vaes = nn.ModuleList([
            VAE(C.MLPEncoder(latent, 784), C.MLPDecoder(latent, (1, 28, 28))),
            VAE(C.EncoderSVHN(latent), C.DecoderSVHN(latent)),
        ])

    def posteriors(self, xs):
        out = []
        for vae, x in zip(self.vaes, xs):
            mu, lv = vae.encoder(x)
            out.append((mu, C.posterior_std("laplace", lv)))
        return out

    def decode_all(self, z):
        return [vae.decoder(z) for vae in self.vaes]


def build(cfg: dict) -> nn.Module:
    if cfg["dist"] != "laplace" or not cfg["no_nf"]:
        raise ValueError("this reference is the MMVAE with Laplace posteriors and no flow")
    return MMVAE(cfg["latent_dim"])


def lik_scaling(cfg: dict):
    s = cfg.get("llik_scaling", 0.0)
    return ((3 * 32 * 32) / (1 * 28 * 28) if s == 0 else s, 1.0)


def train_noise(cfg: dict, batch: int):
    """The noise a train step takes: each modality's K Laplace draws."""
    return [("laplace", (cfg["K"], batch, cfg["latent_dim"]))] * 2


def train_loss(model: MMVAE, xs, noise, cfg: dict):
    """-(DReG-looser objective): per modality the IWAE log-weights of its
    K samples against the mixture posterior, weighted by their softmax over
    K, averaged over modalities; the samples' gradient scaled by the same
    weights, the posterior parameters stopped inside the log-weights."""
    scaling = lik_scaling(cfg)
    qz = model.posteriors(xs)
    zss = torch.stack([C.sample("laplace", mu, std, u) for (mu, std), u in zip(qz, noise)])
    qz_stopped = [(mu.detach(), std.detach()) for mu, std in qz]
    lws = []
    for r in range(len(xs)):
        z = zss[r]
        lpz = C.prior_log_prob("laplace", z)
        lqz = torch.logsumexp(torch.stack([C.log_prob("laplace", mu, std, z).sum(-1)
                                           for mu, std in qz_stopped]), 0) - math.log(len(xs))
        lpx = sum(C.unit_normal_lpx(recon, x, x.dim() - 1) * s
                  for recon, x, s in zip(model.decode_all(z), xs, scaling))
        lws.append(lpz + lpx - lqz)
    lws = torch.stack(lws)
    with torch.no_grad():
        w = torch.softmax(lws, dim=1)
    if zss.requires_grad:
        zss.register_hook(lambda g: g * w.unsqueeze(-1))
    return -(w * lws).mean(0).sum()


def likelihood(model: MMVAE, xs, draw, K: int, bk: int, rows_per_call: int):
    """The likelihood protocol's per-datapoint values, in the order the
    protocol draws its noise: the conditionals ln p(x_g | x_c), the joint
    ln p(x, y) under the Bernoulli mixture of the two posteriors, then the
    bis conditionals, each the joint from one posterior less the marginal
    from the prior. draw(kind, shape) -> noise."""
    n, d = xs[0].shape[0], model.latent
    qz = model.posteriors(xs)

    def is_(log_w, kinds):
        return C.chunked_is(log_w, lambda: [draw(k, (n, bk, w)) for k, w in kinds],
                            n, K, bk, rows_per_call)

    def lpx_all(z, sl):
        return sum(C.unit_normal_lpx(r, x[sl][:, None], x.dim() - 1)
                   for r, x in zip(model.decode_all(z), xs))

    out = {}
    for g in range(2):
        c = 1 - g
        mu, std = qz[c]

        def cond(sl, u, mu=mu, std=std, g=g):
            z = C.sample("laplace", mu[sl][:, None], std[sl][:, None], u)
            return C.unit_normal_lpx(model.vaes[g].decoder(z), xs[g][sl][:, None], 3)

        out[f"cond_likelihood_{c}_{g}"] = is_(cond, [("laplace", d)])

    def joint(sl, u, e0, e1):
        (m0, s0), (m1, s1) = [(mu[sl][:, None], std[sl][:, None]) for mu, std in qz]
        pick = (u < 0.5).to(m0.dtype)
        z = pick * C.sample("laplace", m0, s0, e0) + (1 - pick) * C.sample("laplace", m1, s1, e1)
        lqz = torch.logsumexp(torch.stack([C.log_prob("laplace", m0, s0, z).sum(-1),
                                           C.log_prob("laplace", m1, s1, z).sum(-1)]), 0) / 2
        return lpx_all(z, sl) + C.prior_log_prob("laplace", z) - lqz

    out["likelihood"] = is_(joint, [("uniform", 1), ("laplace", d), ("laplace", d)])

    for g in range(2):
        c = 1 - g
        mu, std = qz[c]

        def from_uni(sl, u, mu=mu, std=std):
            m, s = mu[sl][:, None], std[sl][:, None]
            z = C.sample("laplace", m, s, u)
            return lpx_all(z, sl) + C.prior_log_prob("laplace", z) \
                - C.log_prob("laplace", m, s, z).sum(-1)

        def from_prior(sl, u, c=c):
            z = C.sample("laplace", torch.zeros_like(u), torch.ones_like(u), u)
            return C.unit_normal_lpx(model.vaes[c].decoder(z), xs[c][sl][:, None], 3)

        joint_c = is_(from_uni, [("laplace", d)])
        out[f"conditional_likelihood_bis_{c}_{g}"] = joint_c - is_(from_prior, [("laplace", d)])
    return out
