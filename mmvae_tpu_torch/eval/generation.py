"""Generation utilities (mmvae_tpu/eval/generation.py; reference
multi_vaes.py:83-195).

Where the JAX functions take a PRNG key, these take a `Noise`: the source
every draw of the call comes from, in a fixed order. The ns conditional
samples of `sample_from_conditional` go through the model as one call of
ns*B rows (a leading sample axis), where JAX vmaps over ns keys. Callers run
these under `torch.no_grad()`: the flows' fused solve then records no tape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import distributions as D
from ..core.distributions import LocScale


class Noise:
    """The noise of an eval call, drawn from explicit generators.

    `draw(dist, shape)` returns `dist`'s kind of noise
    (`core.distributions.draw_noise`) of `shape`. With one generator every
    draw comes from it. With several, one per test batch, `sizes[b]` rows of
    each draw's first axis come from generator b: a call over several test
    batches then draws for each batch exactly what a call over that batch
    alone would, so grouping batches changes no value."""

    def __init__(self, generators: Sequence[torch.Generator], sizes: Optional[Sequence[int]] = None,
                 dtype=torch.float32):
        self.generators = list(generators)
        if sizes is None and len(self.generators) != 1:
            raise ValueError("several generators need the rows of each")
        self.sizes = None if sizes is None else [int(n) for n in sizes]
        self.dtype = dtype

    def draw(self, dist: str, shape) -> torch.Tensor:
        shape = tuple(shape)
        if self.sizes is None:
            g = self.generators[0]
            return D.draw_noise(dist, shape, g, g.device, self.dtype)
        if shape[0] != sum(self.sizes):
            raise ValueError(f"a draw of {shape[0]} rows over batches of {self.sizes}")
        return torch.cat([D.draw_noise(dist, (n,) + shape[1:], g, g.device, self.dtype)
                          for g, n in zip(self.generators, self.sizes)])


def _like(model) -> dict:
    p = next(model.parameters())
    return {"device": p.device, "dtype": p.dtype}


def generate(model, noise: Noise, spec, N: int, sampler=None):
    """Prior samples, or with `sampler` (a fitted latent sampler such as
    eval/gmm.py's, whose `sample(N, generator)` gives the latents) its
    samples, decoded in every modality (multi_vaes.py:83-103). The sampler
    draws from the Noise's generator. Returns a list of (N, *event_m)."""
    if sampler is not None:
        if len(noise.generators) != 1:
            raise ValueError("a fitted sampler draws from one generator")
        latents = sampler.sample(N, noise.generators[0])
        return model.decode_all(latents.to(**_like(model)))
    pz = LocScale(torch.zeros(N, spec.latent_dim, **_like(model)),
                  torch.ones(N, spec.latent_dim, **_like(model)))
    latents = D.sample(spec.posterior, pz, noise=noise.draw(spec.posterior, (N, spec.latent_dim)))
    return model.decode_all(latents)


def decode_all(model, latents):
    """Decode of given latents in every modality."""
    return model.decode_all(latents)


def _posterior_noise(model, cond_mod: int, noise: Noise, shape):
    return noise.draw(model.vaes[cond_mod].posterior, shape)


def sample_latents_from_mod(model, cond_mod: int, x, noise: Noise):
    """One posterior sample per input row through the model's own
    conditional inference rule (multi_vaes.py:71-79)."""
    eps = _posterior_noise(model, cond_mod, noise, (x.shape[0], model.vaes[cond_mod].latent_dim))
    return model.infer_latent_from_mod(cond_mod, x, noise=eps)


def sample_from_conditional(model, bdata, noise: Noise, n: int = 10):
    """M x M cross-generation matrix with n samples per datapoint
    (multi_vaes.py:184-195): samples[i][j] of shape (n, B, *event_j).
    Modality i's noise, (n, B, latent), is drawn before modality i + 1's."""
    samples = []
    for i, x in enumerate(bdata):
        latent = model.vaes[i].latent_dim
        eps = _posterior_noise(model, i, noise, (n, x.shape[0], latent))
        # the samplers add a leading sample axis only for K > 1
        z = model.infer_latent_from_mod(i, x, K=n, noise=eps if n > 1 else eps[0])
        samples.append(model.decode_all(z if n > 1 else z[None]))
    return samples


def generate_from_conditional(model, noise: Noise, spec, N: int = 10, sampler=None):
    """p(x, y) = p(x) p(y|x) generation (multi_vaes.py:105-126)."""
    data = generate(model, noise, spec, N, sampler=sampler)
    return data, sample_from_conditional(model, data, noise, n=1)
