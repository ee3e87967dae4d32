"""Plain reference of JMVAE-NF on MNIST-SVHN (the JMVAE-NF paper): a joint
encoder q(z|x, y) over the two encoders' embeddings, unimodal normal
posteriors each followed by a masked autoregressive flow of two MADE
blocks (three hidden layers of 128), unit-scale normal likelihoods, a
standard normal prior; its importance-sampled likelihoods."""

from __future__ import annotations

import torch
from torch import nn

from . import common as C


class JMVAENF(nn.Module):
    def __init__(self, latent: int, made_blocks: int):
        super().__init__()
        self.latent = latent
        self.joint_encoder = C.JointEncoder(
            [C.MLPEncoder(20, 784), C.EncoderSVHN(20)], latent, in_features=40)

        class VAE(nn.Module):
            def __init__(self, encoder, decoder):
                super().__init__()
                self.encoder, self.decoder = encoder, decoder
                self.flow = C.MAF(latent, made_blocks)

        self.vaes = nn.ModuleList([
            VAE(C.MLPEncoder(latent, 784), C.MLPDecoder(latent, (1, 28, 28))),
            VAE(C.EncoderSVHN(latent), C.DecoderSVHN(latent)),
        ])

    def decode_all(self, z):
        return [vae.decoder(z) for vae in self.vaes]


def build(cfg: dict) -> nn.Module:
    if cfg["dist"] != "normal" or cfg["no_nf"] or cfg.get("flow", "maf") != "maf" \
            or cfg.get("dcca") or cfg.get("num_hidden_layers", 1) != 1 \
            or cfg.get("s_bound_flow", 0.0) or cfg.get("n_made_blocks") not in (None, 2):
        raise ValueError("this reference is JMVAE-NF with MAF flows, no DCCA, one joint layer")
    return JMVAENF(cfg["latent_dim"], 2)


def likelihood(model: JMVAENF, xs, draw, K: int, bk: int, rows_per_call: int):
    """The likelihood protocol's per-datapoint values, in the order the
    protocol draws its noise: the conditionals ln p(x_g | x_c) with z from
    the flow posterior of x_c, the joint ln p(x, y) with the joint
    posterior as proposal, then the bis conditionals, each the joint with
    the flow posterior of x_c as proposal less the marginal of x_c from the
    prior. draw(kind, shape) -> noise."""
    n, d = xs[0].shape[0], model.latent
    encoded = [vae.encoder(x) for vae, x in zip(model.vaes, xs)]

    def is_(log_w):
        return C.chunked_is(log_w, lambda: [draw("normal", (n, bk, d))], n, K, bk, rows_per_call)

    def lpx_all(z, sl):
        return sum(C.unit_normal_lpx(r, x[sl][:, None], x.dim() - 1)
                   for r, x in zip(model.decode_all(z), xs))

    def flow_sample(c, sl, eps):
        mu, lv = (t[sl][:, None] for t in encoded[c])
        z0 = C.sample("normal", mu, torch.exp(0.5 * lv), eps)
        z, ldj = model.vaes[c].flow.inverse(z0)
        return mu, lv, z0, z, ldj

    out = {}
    for g in range(2):
        c = 1 - g

        def cond(sl, eps, c=c, g=g):
            z = flow_sample(c, sl, eps)[3]
            return C.unit_normal_lpx(model.vaes[g].decoder(z), xs[g][sl][:, None], 3)

        out[f"cond_likelihood_{c}_{g}"] = is_(cond)

    mu_j, std_j = model.joint_encoder(xs)

    def joint(sl, eps):
        m, s = mu_j[sl][:, None], std_j[sl][:, None]
        z = C.sample("normal", m, s, eps)
        return lpx_all(z, sl) + C.prior_log_prob("normal", z) \
            - C.log_prob("normal", m, s, z).sum(-1)

    out["likelihood"] = is_(joint)

    for g in range(2):
        c = 1 - g

        def from_uni(sl, eps, c=c):
            mu, lv, z0, z, ldj = flow_sample(c, sl, eps)
            log_q_z0 = torch.sum(-0.5 * (lv + C.LOG2PI + (z0 - mu) ** 2 / torch.exp(lv)), dim=-1)
            return lpx_all(z, sl) + C.prior_log_prob("normal", z) - (log_q_z0 - ldj)

        def from_prior(sl, eps, c=c):
            return C.unit_normal_lpx(model.vaes[c].decoder(eps), xs[c][sl][:, None], 3)

        joint_c = is_(from_uni)
        out[f"conditional_likelihood_bis_{c}_{g}"] = joint_c - is_(from_prior)
    return out
