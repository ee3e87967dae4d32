"""CelebA's JMVAE-NF builder in the port against the JAX package, on the
CPU: `jnf_celeba` (jmvae_nf.json, m_jmvae_nf past warmup with the unimodal
reconstructions, so both `ar_solve` directions run at D = 64), its value
and every gradient leaf in float32, as in test_torch_celeba_models.py (at
the published zero MADE biases: test_torch_celeba_tie.py).
"""

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.objectives import objectives as pobj

from test_torch_celeba import B, LATENT, _models
from test_torch_celeba_models import _R, _compare
from test_torch_circles import _inject

# past warmup, the unimodal reconstructions on
_PAST_WARMUP = dict(epoch=51, warmup=50, beta_prior=1.0, beta_kl=1.0, past_warmup=True)


def _draws(monkeypatch, dtype):
    """The four normal draws (the joint forward, compute_kld's joint
    sample, each unimodal forward), injected into JAX; the port's."""
    rng = np.random.default_rng(14)
    eps = [rng.standard_normal((B, LATENT)).astype(dtype) for _ in range(4)]
    _inject(monkeypatch, eps)
    return [torch.tensor(e) for e in eps]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_jnf_celeba_matches_jax(monkeypatch):
    """jmvae_nf.json past warmup (frozen joint encoder and decoders, the
    unimodal reconstructions on): the joint encoder of hidden width 1024 on
    the 128-wide ResNet and 40-wide MLP heads, scaling (attributes/image,
    1), both flow directions at D = 64."""
    jb, params, bundle = _models("jmvae_nf", made_bias_seed=14)
    assert bundle.spec.lik_scaling == (1.0 / _R, 1.0) and not bundle.spec.no_recon
    kw = _PAST_WARMUP
    _compare(monkeypatch, jb, params, bundle,
             lambda p, jx: jobj.m_jmvae_nf(jb.model, {"params": p}, jx, jax.random.PRNGKey(3),
                                           jb.spec, train=True, **kw),
             lambda m, xs, noise: pobj.m_jmvae_nf(m, xs, bundle.spec, noise=noise, **kw)[0],
             lambda dtype: _draws(monkeypatch, dtype), dtypes=("float32",))

