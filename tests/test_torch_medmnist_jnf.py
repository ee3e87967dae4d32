"""The JMVAE-NF builders of MedMNIST and chest-X-ray <-> SVHN in the port
against the JAX package, on the CPU: `jnf_medmnist` (jnf_sbound.json:
m_jmvae_nf past warmup with the unimodal reconstructions, so both
`ar_solve` directions run at D = 16 with s_bound 8) in float64 and
float32, and
`jnf_chest_svhn` (jmvae_exact_synth.json: m_jmvae_nf in its linear warmup,
no flow) in float32: the objective, details and every gradient leaf. The
weights, data and noise as in test_torch_medmnist.py; tolerances there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.objectives import objectives as pobj

from test_torch_circles import _assert_grads_close, _flat, _inject, _jax_dtype
from test_torch_medmnist import B, TOL, _images, _models, _port_grads


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("fam,dtype,past_warmup", [("jnf", "float64", True),
                                                   ("jnf", "float32", True),
                                                   ("chest", "float32", False)])
def test_jnf_builders_match_jax(monkeypatch, fam, dtype, past_warmup):
    """m_jmvae_nf: jnf_sbound.json past warmup (the unimodal
    reconstructions on, latent 16, s_bound 8, likelihood scaling (1, 1)),
    and chest-SVHN's jmvae_exact_synth.json in its linear warmup (no flow,
    no_recon, nothing frozen): the value, details and every gradient leaf."""
    jb, params, bundle = _models(fam)
    assert bundle.spec.lik_scaling == (1.0, 1.0)
    latent = bundle.spec.latent_dim
    xs = _images(fam, seed=3, dtype=dtype)
    rng = np.random.default_rng(6)
    eps = [rng.standard_normal((B, latent)).astype(dtype) for _ in range(4)]
    calls = _inject(monkeypatch, eps)
    kw = (dict(epoch=51, warmup=50, beta_prior=1.0, beta_kl=1.0, past_warmup=True)
          if past_warmup else dict(epoch=2, warmup=3, beta_prior=1.0, beta_kl=1.0,
                                   past_warmup=False))
    with _jax_dtype(dtype, monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

        def objective(p):
            obj, det, _ = jobj.m_jmvae_nf(jb.model, {"params": p}, [jnp.asarray(x) for x in xs],
                                          jax.random.PRNGKey(3), jb.spec, train=True, **kw)
            return obj, det

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
    model = bundle.model.to(getattr(torch, dtype)).train()
    obj, det = pobj.m_jmvae_nf(model, [torch.tensor(x) for x in xs], bundle.spec,
                               noise=[torch.tensor(e) for e in eps[:len(calls)]], **kw)
    rtol, gtol = TOL[dtype]
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=rtol)
    assert sorted(det) == sorted(j_det)
    for k, v in j_det.items():
        np.testing.assert_allclose(float(det[k]), float(v), rtol=rtol, atol=1e-12, err_msg=k)
    _assert_grads_close(_port_grads(model, obj), dict(_flat(j_grads)), gtol)
