"""CelebA's builders in the port against the JAX package, on the CPU:
`mvae_celeba` and `moepoe_celeba` (m_self_built) and `mmvae_celeba`
(Laplace posteriors, m_dreg_looser at K=10), each objective's value in
float64 and float32; `mmvae_nf_celeba` (m_elbo_nf, two MAF blocks at
D = 64) in float32; every gradient leaf in float32; and the likelihood
scaling each builder executes (`jnf_celeba`: test_torch_celeba_jnf.py,
which takes its helpers from here). Weights, data and noise as in
test_torch_celeba.py, the flows' MADE biases moved off their zero init
(`_models`); JAX's flows on their plain solve. Tolerances: float64 values
rtol 1e-10, float32 values 1e-5 and gradients 1e-4 of a leaf's largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.core import distributions as D
from mmvae_tpu_torch.objectives import objectives as pobj

from test_torch_celeba import B, LATENT, _data, _models, _port_grads
from test_torch_circles import _assert_grads_close, _flat, _inject, _jax_dtype
from test_torch_mmvae import _inject_uniform
from test_torch_poe import _inject_normal

_R = 3 * 64 * 64 / 40  # the image's size over the attribute vector's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _compare(monkeypatch, jb, params, bundle, j_objective, p_objective, draws,
             dtypes=("float64", "float32"), jit=True):
    """The objective in JAX (`j_objective(p, xs)`, the first output) and in
    the port (`p_objective(model, xs, noise)`) on the same data and noise
    (`draws(dtype)` injects JAX's and returns the port's): the value in
    each of `dtypes`, every gradient leaf in float32, the last. `jit`
    False runs JAX op by op: the flows' unrolled solve at D = 64 compiles
    for a minute or more under jit and runs in seconds eagerly."""
    compile_ = jax.jit if jit else (lambda f: f)
    for dtype in dtypes:
        xs = _data(seed=10, dtype=dtype)
        noise = draws(dtype)
        with _jax_dtype(dtype, monkeypatch):
            jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
            jx = [jnp.asarray(x) for x in xs]

            def objective(p):
                return j_objective(p, jx)[0]

            if dtype == "float64":
                j_obj = compile_(objective)(jparams)
            else:
                j_obj, j_grads = compile_(jax.value_and_grad(objective))(jparams)
        model = bundle.model.to(getattr(torch, dtype)).train()
        obj = p_objective(model, [torch.tensor(x) for x in xs], noise)
        np.testing.assert_allclose(obj.item(), float(j_obj),
                                   rtol=1e-10 if dtype == "float64" else 1e-5)
    _assert_grads_close(_port_grads(model, obj), dict(_flat(j_grads)), 1e-4)


@pytest.mark.parametrize("name", ["mvae", "moepoe"])
def test_poe_builders_match_jax(monkeypatch, name):
    """m_self_built of mvae.json (scaling (1, 50) at llik_scaling 0) and
    moepoe.json (llik_scaling 50: (1, 50)), MVAE's draws z_0, z_1, z_joint
    and MoE-PoE's mixture draw injected."""
    jb, params, bundle = _models(name)
    assert bundle.spec.lik_scaling == (1.0, 50.0)
    n_draws = 3 if name == "mvae" else 1

    def draws(dtype):
        rng = np.random.default_rng(11)
        eps = [rng.standard_normal((B, LATENT)).astype(dtype) for _ in range(n_draws)]
        _inject_normal(monkeypatch, name, eps)
        return [torch.tensor(e) for e in eps]

    _compare(monkeypatch, jb, params, bundle,
             lambda p, jx: jobj.m_self_built(jb.model, {"params": p}, jx, jax.random.PRNGKey(3),
                                             jb.spec, K=1),
             lambda m, xs, noise: pobj.m_self_built(m, xs, bundle.spec, K=1, noise=noise)[0],
             draws)


def test_mmvae_celeba_matches_jax(monkeypatch):
    """mmvae.json: Laplace posteriors, scaling (1, image/attributes) at
    llik_scaling 0, m_dreg_looser at K=10."""
    jb, params, bundle = _models("mmvae")
    assert bundle.spec.lik_scaling == (1.0, _R) and bundle.spec.posterior == "laplace"
    k = 10

    def draws(dtype):
        rng = np.random.default_rng(12)
        us = [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, size=(k, B, LATENT)).astype(dtype)
              for _ in range(2)]
        _inject_uniform(monkeypatch, us)
        return [torch.tensor(u) for u in us]

    _compare(monkeypatch, jb, params, bundle,
             lambda p, jx: jobj.m_dreg_looser(jb.model, {"params": p}, jx,
                                              jax.random.PRNGKey(3), jb.spec, K=k),
             lambda m, xs, noise: pobj.m_dreg_looser(m, xs, bundle.spec, K=k, noise=noise)[0],
             draws)


def test_mmvae_nf_celeba_matches_jax(monkeypatch):
    """mmvae_nf.json: flow VAEs (two MAF blocks of 3x128 at D = 64), scaling
    (1, image/attributes), m_elbo_nf, one posterior draw per modality."""
    jb, params, bundle = _models("mmvae_nf", made_bias_seed=13)
    assert bundle.spec.lik_scaling == (1.0, _R)

    def draws(dtype):
        rng = np.random.default_rng(13)
        eps = [rng.standard_normal((B, LATENT)).astype(dtype) for _ in range(2)]
        _inject(monkeypatch, eps)
        return [torch.tensor(e) for e in eps]

    _compare(monkeypatch, jb, params, bundle,
             lambda p, jx: jobj.m_elbo_nf(jb.model, {"params": p}, jx, jax.random.PRNGKey(3),
                                          jb.spec),
             lambda m, xs, noise: pobj.m_elbo_nf(m, xs, bundle.spec, noise=noise)[0],
             draws, dtypes=("float32",), jit=False)
