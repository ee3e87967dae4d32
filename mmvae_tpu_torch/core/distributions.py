"""Loc/scale distributions as plain tensor functions
(mmvae_tpu/core/distributions.py).

Samplers take their noise explicitly, or a `torch.Generator` that draws it
on the parameters' device, in place of the JAX `key`. What the noise is
depends on the family: standard-normal `eps` for the Normal, a uniform `u`
in (-1 + 1e-7, 1) for the Laplace, a uniform `u` in [0, 1) for the
Bernoulli (a draw is u < p). Tests hand the same numpy noise to both
packages, since the two frameworks' generators give different numbers from
one seed.

Scale conventions (as the JAX package):
- posterior std from encoders:      std = exp(0.5 * log_var)
- Laplace softmax-std trick:        std = softmax(lv) * D + 1e-6
- joint-encoder std:                std = exp(0.5 * raw) + 1e-6
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .constants import BERNOULLI_EPS, ETA, LOG2PI

# the open interval JAX's laplace_sample draws its uniform from
LAPLACE_U_MIN, LAPLACE_U_MAX = -1.0 + 1e-7, 1.0


class LocScale(NamedTuple):
    """Parameters of a loc/scale family distribution."""

    loc: torch.Tensor
    scale: torch.Tensor


def _sample_shape(p: LocScale, sample_shape) -> tuple:
    return tuple(sample_shape) + torch.broadcast_shapes(p.loc.shape, p.scale.shape)


def _check_noise(name: str, noise: torch.Tensor, shape: tuple) -> None:
    if tuple(noise.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(noise.shape)}, expected {shape}")


# --------------------------------------------------------------------------
# std parameterizations
# --------------------------------------------------------------------------

def std_from_logvar(log_var: torch.Tensor) -> torch.Tensor:
    return torch.exp(0.5 * log_var)


def std_softmax_trick(log_var: torch.Tensor) -> torch.Tensor:
    """MMVAE softmax-std trick (laplace_vae.py:69)."""
    return torch.softmax(log_var, dim=-1) * log_var.shape[-1] + ETA


def std_joint_encoder(raw: torch.Tensor) -> torch.Tensor:
    """Joint-encoder std head (joint_encoders.py:52,81)."""
    return torch.exp(0.5 * raw) + ETA


# --------------------------------------------------------------------------
# Normal
# --------------------------------------------------------------------------

def normal_log_prob(p: LocScale, x: torch.Tensor) -> torch.Tensor:
    var = p.scale ** 2
    return -((x - p.loc) ** 2) / (2 * var) - torch.log(p.scale) - 0.5 * LOG2PI


def draw_noise(dist: str, shape, generator: Optional[torch.Generator] = None,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """The noise `sample` draws for family `dist`: standard normal
    ("normal"), uniform in (-1 + 1e-7, 1) ("laplace"), or uniform in [0, 1)
    ("uniform" or "bernoulli": a Bernoulli(p) draw is u < p)."""
    if dist == "normal":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    r = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    if dist in ("uniform", "bernoulli"):
        return r
    if dist == "laplace":
        # jax.random.uniform: max(minval, r * (maxval - minval) + minval)
        return torch.clamp_min(r * (LAPLACE_U_MAX - LAPLACE_U_MIN) + LAPLACE_U_MIN, LAPLACE_U_MIN)
    raise NotImplementedError(f"{dist} noise not yet ported")


def normal_sample(p: LocScale, sample_shape=(), eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """loc + eps * scale, eps standard normal."""
    shape = _sample_shape(p, sample_shape)
    if eps is None:
        eps = draw_noise("normal", shape, generator, p.loc.device, p.loc.dtype)
    else:
        _check_noise("eps", eps, shape)
    return p.loc + eps * p.scale


def normal_kl(p: LocScale, q: LocScale) -> torch.Tensor:
    """KL(p || q) for diagonal normals."""
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def normal_entropy(p: LocScale) -> torch.Tensor:
    return 0.5 + 0.5 * LOG2PI + torch.log(p.scale)


# --------------------------------------------------------------------------
# Laplace
# --------------------------------------------------------------------------

def laplace_log_prob(p: LocScale, x: torch.Tensor) -> torch.Tensor:
    return -torch.abs(x - p.loc) / p.scale - torch.log(2 * p.scale)


def laplace_sample(p: LocScale, sample_shape=(), u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Reparameterized Laplace sample, loc - scale*sign(u)*log1p(-|u|), from
    a uniform u in (-1 + 1e-7, 1): JAX's range and formula. (The low end of
    torch.distributions.Laplace is eps - 1 instead.)"""
    shape = _sample_shape(p, sample_shape)
    dtype = p.loc.dtype
    if u is None:
        u = draw_noise("laplace", shape, generator, p.loc.device, dtype)
    else:
        _check_noise("u", u, shape)
    tiny = torch.finfo(dtype).tiny
    return p.loc - p.scale * torch.sign(u) * torch.log1p(-torch.clamp_min(u.abs(), tiny))


def laplace_kl(p: LocScale, q: LocScale) -> torch.Tensor:
    """KL(p || q) for Laplace."""
    scale_ratio = p.scale / q.scale
    loc_abs_diff = torch.abs(p.loc - q.loc)
    t1 = -torch.log(scale_ratio)
    t2 = loc_abs_diff / q.scale
    t3 = scale_ratio * torch.exp(-loc_abs_diff / p.scale)
    return t1 + t2 + t3 - 1.0


# --------------------------------------------------------------------------
# Bernoulli (probs parameterization, as the binary decoders use it)
# --------------------------------------------------------------------------

def bernoulli_log_prob(probs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x ln p + (1 - x) ln(1 - p), p clipped to [BERNOULLI_EPS, 1 - BERNOULLI_EPS]."""
    p = torch.clamp(probs, BERNOULLI_EPS, 1.0 - BERNOULLI_EPS)
    return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)


def bernoulli_sample(probs: torch.Tensor, sample_shape=(), u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """1 where a uniform u in [0, 1) lies below p, else 0, in the dtype of
    `probs`: the law of jax.random.bernoulli."""
    shape = tuple(sample_shape) + tuple(probs.shape)
    if u is None:
        u = draw_noise("uniform", shape, generator, probs.device, probs.dtype)
    else:
        _check_noise("u", u, shape)
    return (u < probs).to(probs.dtype)


# --------------------------------------------------------------------------
# Generic dispatch by family name
# --------------------------------------------------------------------------

_LOG_PROB = {"normal": normal_log_prob, "laplace": laplace_log_prob,
             # the loc/scale pair carries the probabilities in `loc`
             "bernoulli": lambda p, x: bernoulli_log_prob(p.loc, x)}
_KL = {"normal": normal_kl, "laplace": laplace_kl}


def _family(table, dist: str):
    if dist not in table:
        raise NotImplementedError(f"{dist} distribution not yet ported")
    return table[dist]


def log_prob(dist: str, p: LocScale, x: torch.Tensor) -> torch.Tensor:
    return _family(_LOG_PROB, dist)(p, x)


def sample(dist: str, p: LocScale, sample_shape=(), noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A sample of `dist` with leading `sample_shape`. `noise` is the
    family's own: standard-normal eps ("normal") or uniform u in
    (-1 + 1e-7, 1) ("laplace"), uniform u in [0, 1) ("bernoulli", whose
    probabilities are `p.loc`); without it the noise is drawn from
    `generator`."""
    if dist == "normal":
        return normal_sample(p, sample_shape, eps=noise, generator=generator)
    if dist == "laplace":
        return laplace_sample(p, sample_shape, u=noise, generator=generator)
    if dist == "bernoulli":
        return bernoulli_sample(p.loc, sample_shape, u=noise, generator=generator)
    raise NotImplementedError(f"{dist} sampling not yet ported")


def kl(dist: str, p: LocScale, q: LocScale, K: int = 100, noise: Optional[torch.Tensor] = None,
       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """KL(p || q): the closed form where the family has one, else the Monte
    Carlo estimate over K samples of p, mean of ln p - ln q (utils.py:147-153).
    `noise` is the K samples' noise, of the family's kind (see `sample`),
    or None to draw it from `generator`."""
    if dist in _KL:
        return _KL[dist](p, q)
    zs = sample(dist, p, (K,), noise=noise, generator=generator)
    return torch.mean(log_prob(dist, p, zs) - log_prob(dist, q, zs), dim=0)


def wasserstein_2(p: LocScale, q: LocScale) -> torch.Tensor:
    """The W2 distance between diagonal normals as the reference writes it
    (utils.py:155-162), with the standard deviations, not the variances, in
    the trace term."""
    return (p.loc - q.loc) ** 2 + p.scale + q.scale - 2 * torch.sqrt(p.scale * q.scale)
