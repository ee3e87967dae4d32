"""Evaluation of the trimodal MNIST-SVHN-Fashion models in the port against
the JAX package, in float64 on the CPU: the conditional likelihoods of all
six ordered pairs with the MoE subset conditionals cond_lw_subset_i, the
joint likelihoods of MMVAE (whose mixture proposal has modalities 0 and 1
only, as JAX's) and MVAE on three modalities, and the PoE-subset
accuracies, analytic for MVAE and by Hamiltonian Monte Carlo for JMVAE-NF.
Models and weights as in test_torch_msf.py; noise injection as in
test_torch_eval.py (JAX traces each estimator once, so one noise array
serves every datapoint and chunk) and test_torch_circles_eval.py (HMC's
draws rebuilt from JAX's key sequence, and JAX's float32 acceptance carry
given a float64 `jnp`).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import hmc as JH
from mmvae_tpu.eval import likelihoods as JL
from mmvae_tpu.eval import modalities as JM
from mmvae_tpu_torch.eval import likelihoods as L
from mmvae_tpu_torch.eval import modalities as M
from test_torch_eval import GivenNoise, _bern_u, _inject
from test_torch_msf import (  # noqa: F401  (models: a fixture)
    LATENT, _jax_dtype, _one_torch_thread, _port, models,
)

SHAPES = [(1, 28, 28), (3, 32, 32), (1, 28, 28)]
K_IS, N = 4, 3


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    """JAX's eval programs are cached per model: each test traces anew with
    its own injected noise."""
    monkeypatch.setattr(JG, "_JIT_CACHE", {})


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(n,) + s) for s in SHAPES]


def _jparams(models, fam):
    return {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), models[fam][1])}


def _port64(models, fam):
    bundle = _port(models, fam, torch.float64)
    bundle.model.eval()
    return bundle


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------

def _inject_mvae_is(monkeypatch, eps):
    """JAX's joint_likelihood_mvae runs MVAE's forward for its proposal,
    whose seven normal draws (unimodal, joint, subsets) it discards, then
    draws the IS samples: those get `eps`, the forward's its means."""
    calls = []

    def normal_sample(p, key, sample_shape=()):
        if p.loc.shape != eps.shape:
            return p.loc
        calls.append("normal")
        return p.loc + jnp.asarray(eps, p.loc.dtype) * p.scale

    monkeypatch.setattr(JD, "normal_sample", normal_sample)
    return calls


@pytest.mark.parametrize("fam", ["jnf", "mmvae", "mvae"])
def test_trimodal_likelihoods_match_jax(models, monkeypatch, fam):
    """At one IS chunk of 4 samples for 3 datapoints, float64, to 1e-10
    relative: for JMVAE-NF the six conditional likelihoods and
    cond_lw_subset_0..2 (logsumexp of the two conditionals into modality
    i, less ln 2), JAX's batch means; for MMVAE and MVAE the joint
    likelihood."""
    jb = models[fam][0]
    bundle = _port64(models, fam)
    rng = np.random.default_rng(8)
    xs = _data(N, seed=9)
    key = jax.random.PRNGKey(11)
    post = "laplace" if fam == "mmvae" else "normal"
    n_draws = 6 if fam == "jnf" else 2 if fam == "mmvae" else 1
    eps = [rng.uniform(-1 + 1e-7, 1, size=(K_IS, LATENT)) if post == "laplace"
           else rng.standard_normal((K_IS, LATENT)) for _ in range(n_draws)]
    with _jax_dtype("float64", monkeypatch):
        given = [_bern_u(key, N, K_IS)] + eps if fam == "mmvae" else eps
        if fam == "mvae":
            calls = _inject_mvae_is(monkeypatch, eps[0])
        else:
            calls = _inject(monkeypatch, eps)
        v, jx = _jparams(models, fam), [jnp.asarray(x) for x in xs]
        if fam == "jnf":
            want = JL.compute_conditional_likelihoods(jb.model, v, jx, jb.spec, key, K_IS, K_IS)
        elif fam == "mmvae":
            want = JL.joint_likelihood_mmvae(jb.model, v, jx, jb.spec, key, K_IS, K_IS)
        else:
            want = JL.joint_likelihood_mvae(jb.model, v, jx, jb.spec, key, K_IS, K_IS)
    assert len(calls) == n_draws
    with torch.no_grad():
        data = [torch.tensor(x) for x in xs]
        noise = GivenNoise(given, "float64")
        if fam == "jnf":
            got = L.compute_conditional_likelihoods(bundle.model, data, bundle.spec, noise, K_IS,
                                                    K_IS)
        else:
            fn = L.joint_likelihood_mmvae if fam == "mmvae" else L.joint_likelihood_mvae
            got = fn(bundle.model, data, bundle.spec, noise, K_IS, K_IS)
    assert sorted(got) == sorted(want)
    if fam == "jnf":
        assert {f"cond_lw_subset_{i}" for i in range(3)} <= set(got)
        for i in range(3):
            lls = [got[f"cond_likelihood_{j}_{i}"] for j in range(3) if j != i]
            np.testing.assert_allclose(got[f"cond_lw_subset_{i}"].numpy(),
                                       np.logaddexp(*[t.numpy() for t in lls]) - np.log(2),
                                       rtol=1e-12)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].mean().item(), float(w), rtol=1e-10, err_msg=k)


# ---------------------------------------------------------------------------
# PoE-subset accuracies
# ---------------------------------------------------------------------------

def _classifiers(seed=3):
    """Linear stand-ins for the eval classifiers: 10 logits from the pixels."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((int(np.prod(s)), 10)) for s in SHAPES]
    jax_fns = [lambda x, w=w: x.reshape(x.shape[0], -1) @ jnp.asarray(w, x.dtype) for w in ws]
    port_fns = [lambda x, w=w: x.reshape(x.shape[0], -1) @ torch.tensor(w, dtype=x.dtype)
                for w in ws]
    return jax_fns, port_fns


SUBSETS = ([1, 2], [0, 2], [0, 1])


def _same_accuracies(got, want, n):
    """The same count of correct labels out of n (JAX takes its means in
    float32), and the other metrics to rtol 1e-12."""
    for k, w in want.items():
        if k.startswith("cond_acc_"):
            assert got[k] * n == round(w * n), k
        else:
            assert got[k] == pytest.approx(w, rel=1e-12, abs=0), k


def test_poe_subset_accuracy_mvae_matches_jax(models, monkeypatch):
    """MVAE's analytic PoE of each 2-subset with the prior, 2 samples for 3
    datapoints each, the same normal draws: the three cond_acc_m count the
    same correct labels, and there is no acceptance rate."""
    jb = models["mvae"][0]
    bundle = _port64(models, "mvae")
    xs = _data(N, seed=2)
    classes = [np.array([3, 1, 4])] * 3
    rng = np.random.default_rng(6)
    eps = [rng.standard_normal((2, N, LATENT)) for _ in range(3)]
    calls = []

    def normal_sample(p, key, sample_shape=()):
        calls.append(tuple(sample_shape))
        return p.loc + jnp.asarray(eps[len(calls) - 1]) * p.scale

    monkeypatch.setattr(JD, "normal_sample", normal_sample)
    jfns, pfns = _classifiers()
    with _jax_dtype("float64", monkeypatch):
        want = JM.poe_subset_accuracy(jb.model, _jparams(models, "mvae"), jfns,
                                      [jnp.asarray(x) for x in xs], classes,
                                      jax.random.PRNGKey(0), jb.spec, n_data=N, ns=2)
    assert calls == [(2,)] * 3
    with torch.no_grad():
        got = M.poe_subset_accuracy(bundle.model, pfns, [torch.tensor(x) for x in xs], classes,
                                    n_data=N, ns=2, draws=[{"eps": torch.tensor(e)} for e in eps])
    assert sorted(got) == sorted(want) == [f"cond_acc_{m}" for m in range(3)]
    _same_accuracies(got, want, 2 * N)


def test_poe_subset_accuracy_jnf_matches_jax(models, monkeypatch):
    """JMVAE-NF's HMC over each 2-subset's product of flow posteriors (3
    steps of 10 leapfrogs, 2 chains for 3 datapoints), float64: JAX's
    chains with their own draws, the port's with the start, momenta and
    accept-uniforms rebuilt from JAX's keys (fold_in(key, m), then as in
    test_torch_circles_eval.py): cond_acc_m count the same correct labels,
    hmc_acc_rate_m to rtol 1e-12."""
    jb = models["jnf"][0]
    bundle = _port64(models, "jnf")
    xs = _data(N, seed=4)
    classes = [np.array([0, 7, 2])] * 3
    steps, ns, n = 3, 2, 2 * N
    key = jax.random.PRNGKey(21)
    x64_jnp = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                       if not k.startswith("__")})
    x64_jnp.float32 = jnp.float64
    monkeypatch.setattr(JH, "jnp", x64_jnp)
    jfns, pfns = _classifiers()
    draws = []
    with _jax_dtype("float64", monkeypatch):
        v = _jparams(models, "jnf")
        jx = [jnp.asarray(x) for x in xs]
        want = JM.poe_subset_accuracy(jb.model, v, jfns, jx, classes, key, jb.spec, n_data=N,
                                      ns=ns, mcmc_steps=steps)
        for m, s in enumerate(SUBSETS):
            k0, k_loop = jax.random.split(jax.random.fold_in(key, m))
            z0 = JH.sample_from_moe_subset(jb.model, v, s, [jnp.concatenate([x] * ns) for x in jx],
                                           k0)
            rho, u = [], []
            for _ in range(steps):
                k_loop, k_gamma, k_acc = jax.random.split(k_loop, 3)
                rho.append(np.asarray(jax.random.normal(k_gamma, (n, LATENT), jnp.float64)))
                u.append(np.asarray(jax.random.uniform(k_acc, (n,))))
            draws.append({"z0": torch.tensor(np.asarray(z0)), "rho": torch.tensor(np.stack(rho)),
                          "u": torch.tensor(np.stack(u))})
    with torch.no_grad():
        got = M.poe_subset_accuracy(bundle.model, pfns, [torch.tensor(x) for x in xs], classes,
                                    n_data=N, ns=ns, mcmc_steps=steps, draws=draws)
    assert sorted(got) == sorted(want)
    assert {f"hmc_acc_rate_{m}" for m in range(3)} <= set(got)
    _same_accuracies(got, want, n)
