"""Training objectives (mmvae_tpu/objectives/objectives.py).

An objective is a plain function
    (model, x, spec, K=..., eps=..., generator=..., **cfg) -> (objective, details)
returning the MAXIMIZATION objective (the train loop negates) and a dict of
scalar terms. Only the MMVAE-NF ELBO is ported so far.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model metadata consumed by objectives."""

    latent_dim: int
    posterior: str = "normal"
    recon_dists: Tuple[str, ...] = ("normal", "normal")
    lik_scaling: Tuple[float, ...] = (1.0, 1.0)
    vae_recon_losses: Tuple[str, ...] = ("mse", "mse")
    no_recon: bool = False
    linear_warmup: bool = False
    align: int = -1
    llik_scaling: float = 1.0


def m_elbo_nf(model, x, spec: ModelSpec, K=1, eps=None, generator=None, **kw):
    """Flow-posterior ELBO with unit-gaussian decoder (reference
    objectives.py:463-479), summed over the batch. K is not used: MMVAE_NF
    runs each VAE at K=1."""
    out = model(x, eps=eps, generator=generator)
    ln_qz_xs, zs, recons = out["ln_qz_xs"], out["zs"], out["recons"]
    n = len(zs)
    obj = 0.0
    for e in range(n):
        log_prob_z = -0.5 * torch.sum(zs[e] ** 2)
        kld = torch.sum(ln_qz_xs[e]) - log_prob_z
        obj = obj - kld / n
        for d, recon in enumerate(recons[e]):
            obj = obj + (-0.5 * torch.sum((recon - x[d]) ** 2)) / n * spec.lik_scaling[d]
    return obj, {}


OBJECTIVES = {
    "m_elbo_nf": m_elbo_nf,
}


def resolve(obj_name: str, multimodal: bool, looser: bool):
    """main.py:134-137 dispatch: ('m_' if multimodal) + obj + ('_looser' if
    looser and obj != 'elbo'). Returns (name, fn)."""
    name = ("m_" if multimodal else "") + obj_name
    if looser and obj_name != "elbo":
        name = name + "_looser"
    if name not in OBJECTIVES:
        raise NotImplementedError(f"objective {name!r} not yet ported")
    return name, OBJECTIVES[name]
