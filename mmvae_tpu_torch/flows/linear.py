"""Planar and radial flows and their stack LinearNF (mmvae_tpu/flows/linear.py;
reference my_pythae vae_lin_nf, in Rezende & Mohamed's formulations).

Only the sampling direction z0 -> zK with log|det J| exists in closed
form. As in the JAX package, `forward` (the density direction a VAE asks
for) stands in with the same map: the reference exposes no density at
arbitrary points for these flows.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def _softplus(x):
    """jax.nn.softplus, logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class PlanarFlow(nn.Module):
    """z' = z + u_hat tanh(w.z + b), log|det| = log|1 + u_hat.h'(w.z + b) w|,
    with u_hat = u + (m(w.u) - w.u) w / |w|^2, m(a) = -1 + softplus(a),
    which keeps the map invertible."""

    def __init__(self, features: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(features))
        self.u = nn.Parameter(torch.empty(features))
        self.b = nn.Parameter(torch.zeros(()))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """w, u from normal(0.1), b zero: JAX's initialisers' laws."""
        for p in (self.w, self.u):
            p.copy_(0.1 * torch.randn(p.shape, generator=generator))
        self.b.zero_()

    def forward(self, z):
        w, u = self.w, self.u
        wu = torch.dot(w, u)
        u_hat = u + (-1.0 + _softplus(wu) - wu) * w / (torch.dot(w, w) + 1e-8)
        lin = z @ w + self.b
        f = z + u_hat * torch.tanh(lin)[..., None]
        psi = (1 - torch.tanh(lin) ** 2)[..., None] * w
        return f, torch.log(torch.abs(1.0 + psi @ u_hat) + 1e-8)


class RadialFlow(nn.Module):
    """z' = z + beta_hat h(alpha, r) (z - z0), r = |z - z0|, h = 1 / (alpha + r),
    alpha = exp(log_alpha) and beta_hat = -alpha + softplus(beta), which
    keeps the map invertible."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.z0 = nn.Parameter(torch.empty(features))
        self.log_alpha = nn.Parameter(torch.zeros(()))
        self.beta = nn.Parameter(torch.zeros(()))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """z0 from normal(0.1), log_alpha and beta zero."""
        self.z0.copy_(0.1 * torch.randn(self.z0.shape, generator=generator))
        self.log_alpha.zero_()
        self.beta.zero_()

    def forward(self, z):
        alpha = torch.exp(self.log_alpha)
        beta = -alpha + _softplus(self.beta)
        diff = z - self.z0
        r = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True))
        h = 1.0 / (alpha + r)
        f = z + beta * h * diff
        h0, r0 = h[..., 0], r[..., 0]
        logdet = (self.features - 1) * torch.log1p(beta * h0) + torch.log1p(
            beta * h0 + beta * (-r0 / (alpha + r0) ** 2))
        return f, logdet


class LinearNF(nn.Module):
    """A stack of planar and radial flows, default ("Planar", "Radial",
    "Planar"), named `<kind>_<i>` as in the JAX package (planar_0, radial_1,
    planar_2); a kind other than planar is radial."""

    def __init__(self, features: int, flows: Sequence[str] = ("Planar", "Radial", "Planar")):
        super().__init__()
        for i, kind in enumerate(flows):
            cls = PlanarFlow if kind.lower() == "planar" else RadialFlow
            self.add_module(f"{kind.lower()}_{i}", cls(features))

    def forward(self, z):
        """The density direction's stand-in: the z0 -> zK map itself."""
        return self.inverse(z)

    def inverse(self, z0):
        """Sampling direction z0 -> zK with the summed log|det J|."""
        z, ld = z0, z0.new_zeros(z0.shape[:-1])
        for layer in self.children():
            z, d = layer(z)
            ld = ld + d
        return z, ld
