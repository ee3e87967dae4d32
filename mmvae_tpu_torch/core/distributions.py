"""Loc/scale distributions as plain tensor functions
(mmvae_tpu/core/distributions.py).

Samplers take the standard-normal noise `eps` explicitly, or a
`torch.Generator` that draws it on the parameters' device, in place of the
JAX `key`. Tests hand the same numpy noise to both packages, since the two
frameworks' generators give different numbers from one seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .constants import LOG2PI


class LocScale(NamedTuple):
    """Parameters of a loc/scale family distribution."""

    loc: torch.Tensor
    scale: torch.Tensor


def std_from_logvar(log_var: torch.Tensor) -> torch.Tensor:
    return torch.exp(0.5 * log_var)


def normal_log_prob(p: LocScale, x: torch.Tensor) -> torch.Tensor:
    var = p.scale ** 2
    return -((x - p.loc) ** 2) / (2 * var) - torch.log(p.scale) - 0.5 * LOG2PI


def normal_sample(p: LocScale, sample_shape=(), eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    shape = tuple(sample_shape) + torch.broadcast_shapes(p.loc.shape, p.scale.shape)
    if eps is None:
        eps = torch.randn(shape, generator=generator, device=p.loc.device,
                          dtype=p.loc.dtype)
    elif tuple(eps.shape) != shape:
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
    return p.loc + eps * p.scale


def sample(dist: str, p: LocScale, sample_shape=(), eps=None, generator=None):
    if dist != "normal":
        raise NotImplementedError(f"{dist} sampling not yet ported")
    return normal_sample(p, sample_shape, eps=eps, generator=generator)
