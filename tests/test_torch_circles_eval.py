"""Evaluation of the circles-squares models in the port against the JAX
package, on the CPU: the radius analytics (`extract_rayon`,
`negative_entropy`, `conditional_rdist_metrics`, `analyse_rayons`), the
posterior analyses, and Hamiltonian Monte Carlo over the product of experts
with the product-of-posteriors figure. Models, noise injection and
tolerances as in test_torch_circles.py, whose helpers this file uses; the
radii and the negative entropy on the same images are exact, and HMC is
held to JAX in float64 with JAX's own draws, rebuilt from its key sequence.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import vis as jvis
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import hmc as JH
from mmvae_tpu.eval import latent_analysis as JLA
from mmvae_tpu_torch import vis
from mmvae_tpu_torch.eval import hmc as H
from mmvae_tpu_torch.data import synthetic
from mmvae_tpu_torch.eval import latent_analysis as LA
from test_torch_circles import (  # noqa: F401  (models: a fixture)
    LATENT, GivenNoise, _images, _inject, _jax_dtype, _port, models,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    """JAX's eval programs are cached per model: each test traces anew with
    its own injected noise."""
    monkeypatch.setattr(JG, "_JIT_CACHE", {})


# ---------------------------------------------------------------------------
# radius analytics
# ---------------------------------------------------------------------------

def test_extract_rayon_and_negative_entropy_exact():
    """Bit for bit on the same images: extract_rayon (leading axes kept,
    pixels near the 0.5 threshold, an all-dark image) and negative_entropy
    of the radii."""
    rng = np.random.default_rng(5)
    imgs = (0.5 + 0.02 * rng.standard_normal((3, 7, 1, 32, 32))).astype(np.float32)
    imgs[0, 0] = 0.0
    r = vis.extract_rayon(imgs)
    assert r.shape == (3, 7) and r.dtype == np.float32 and r[0, 0] == 0.0
    np.testing.assert_array_equal(r, jvis.extract_rayon(imgs))
    rows = rng.uniform(0, 1, size=(9, 13))
    assert LA.negative_entropy(rows, (0, 1), 10) == JLA.negative_entropy(rows, (0, 1), 10)


def test_radius_metrics_match_jax(models, monkeypatch, tmp_path):
    """conditional_rdist_metrics (n = 2 samples of 5 rows each way) and
    analyse_rayons (n = 1) on the JNF model in float32 with the same noise
    (JAX traces its sampler once, so one noise serves every sample): equal
    metric values (rtol 1e-6: the decoded images agree to float32
    round-off, and no pixel lies that close to the 0.5 threshold, so the
    radii are equal), and the histograms written with their JSON."""
    jb, _ = models["jnf"]
    xs = _images(5, seed=2)
    d = synthetic.make_circles_squares(dataset_size=8, n_repeat=1, seed=2)
    r_sq, r_ci = d["r_squares_train"][:5], d["r_circles_train"][:5]
    rng = np.random.default_rng(6)
    eps = [rng.standard_normal((5, LATENT)).astype(np.float32) for _ in range(2)]
    xs = [x.astype(np.float32) for x in xs]
    bundle = _port(models, "jnf", "float32")
    bundle.model.eval()
    os.makedirs(tmp_path / "jax")
    with _jax_dtype("float32", monkeypatch):
        v = {"params": jax.tree.map(jnp.asarray, models["jnf"][1])}
        jx = [jnp.asarray(x) for x in xs]
        _inject(monkeypatch, eps + eps)  # conditional_rdist_metrics' trace, then analyse_rayons'
        j_ent = JLA.conditional_rdist_metrics(jb.model, v, jx, jax.random.PRNGKey(0), n=2, n_data=5)
        j_ray = JLA.analyse_rayons(jb.model, v, jx, r_sq, r_ci, jax.random.PRNGKey(0),
                                   str(tmp_path / "jax"), 1)
    tx = [torch.tensor(x) for x in xs]
    with torch.no_grad():
        ent = LA.conditional_rdist_metrics(bundle.model, tx, GivenNoise(eps, "float32"),
                                           run_path=str(tmp_path), epoch=0, n=2, n_data=5)
        ray = LA.analyse_rayons(bundle.model, tx, r_sq, r_ci, GivenNoise(eps, "float32"),
                                str(tmp_path), 1)
    assert sorted(ent) == sorted(j_ent) == ["neg_entropy"]
    np.testing.assert_allclose(ent["neg_entropy"], j_ent["neg_entropy"], rtol=1e-6)
    assert sorted(ray) == sorted(j_ray)
    for k in j_ray:
        np.testing.assert_allclose(ray[k], j_ray[k], rtol=1e-6, err_msg=k)
    for name in ("hist_000.png", "hist_rayon_01_001.png", "hist_rayon_10_001.png"):
        with open(tmp_path / (name + ".json")) as f:
            spec = json.load(f)
        assert len(spec["bins"]) == 31 and sum(spec["counts"]) == spec["n"]
    assert json.load(open(tmp_path / "hist_000.png.json"))["n"] == 2 * 5 * 2


def test_posterior_analyses_match_jax(models, monkeypatch):
    """analyse_joint_posterior on both families (JNF's joint encoder,
    MMVAE's mean of experts) and analyse_uni_posterior, float64 rtol 1e-10."""
    xs = _images(4, seed=3)
    rng = np.random.default_rng(7)
    for fam in ("jnf", "mmvae"):
        jb, _ = models[fam]
        e_joint = ([rng.standard_normal((4, LATENT))] if fam == "jnf" else
                   [rng.standard_normal((1, 4, LATENT)) for _ in range(2)])
        e_uni = [rng.standard_normal((4, LATENT)) for _ in range(2)]
        bundle = _port(models, fam, "float64")
        bundle.model.eval()
        with _jax_dtype("float64", monkeypatch):
            v = {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), models[fam][1])}
            jx = [jnp.asarray(x) for x in xs]
            _inject(monkeypatch, e_joint)
            jm, js, jz = JLA.analyse_joint_posterior(jb.model, v, jx, jax.random.PRNGKey(0), 4)
            _inject(monkeypatch, e_uni)
            ju = JLA.analyse_uni_posterior(jb.model, v, jx, jax.random.PRNGKey(0), 4)
        tx = [torch.tensor(x) for x in xs]
        with torch.no_grad():
            noise = ([torch.tensor(e_joint[0])] if fam == "jnf" else
                     [torch.tensor(e) for e in e_joint])
            m, s, z = LA.analyse_joint_posterior(bundle.model, tx,
                                                 noise[0] if fam == "jnf" else noise, n_samples=4)
            u = LA.analyse_uni_posterior(bundle.model, tx, GivenNoise(e_uni, "float64"), 4)
        np.testing.assert_allclose(m.numpy(), jm, rtol=1e-10)
        np.testing.assert_allclose(z.numpy(), jz, rtol=1e-10)
        assert (s is None) == (js is None)
        if s is not None:
            np.testing.assert_allclose(s.numpy(), js, rtol=1e-10)
        for a, b in zip(u, ju):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-10)


# ---------------------------------------------------------------------------
# HMC over the product of experts
# ---------------------------------------------------------------------------

def test_moe_subset_start_matches_jax(models, monkeypatch):
    """sample_from_moe_subset with JAX's choice (its randint on the first
    split key) and the same per-modality noise, float64 rtol 1e-10."""
    jb, _ = models["jnf"]
    xs = _images(6, seed=4)
    eps = [np.random.default_rng(8).standard_normal((6, LATENT)) for _ in range(2)]
    key = jax.random.PRNGKey(11)
    bundle = _port(models, "jnf", "float64")
    bundle.model.eval()
    with _jax_dtype("float64", monkeypatch):
        v = {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), models["jnf"][1])}
        _inject(monkeypatch, eps)
        want = JH.sample_from_moe_subset(jb.model, v, [0, 1], [jnp.asarray(x) for x in xs], key)
        choice = jax.random.randint(jax.random.split(key, 3)[0], (6,), 0, 2)
    with torch.no_grad():
        got = H.sample_from_moe_subset(bundle.model, [0, 1], [torch.tensor(x) for x in xs],
                                       choice=torch.tensor(np.asarray(choice)),
                                       eps=[torch.tensor(e) for e in eps])
    assert len(set(np.asarray(choice).tolist())) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("divide_prior", [False, True])
def test_hmc_matches_jax(models, monkeypatch, divide_prior):
    """sample_from_poe_subset, 4 steps of 10 leapfrogs at 0.01, 3 rows x 2
    chains, float64: JAX's chain with its own draws, the port's with those
    draws rebuilt from JAX's key sequence (k0, k_loop = split(key); per
    step key, k_gamma, k_acc = split(key, 3)). The samples agree to rtol
    1e-10 and the acceptance rate exactly; at float32 an accept test near
    its threshold could flip, and 100 steps would amplify it, hence the
    short chain in float64."""
    jb, _ = models["jnf"]
    xs = _images(3, seed=5)
    steps, k, n = 4, 2, 6
    key = jax.random.PRNGKey(21)
    bundle = _port(models, "jnf", "float64")
    bundle.model.eval()
    # JAX's chain starts its acceptance sum as jnp.float32(0.0), a loop
    # carry that x64 turns into a type mismatch: its module gets a jnp
    # whose float32 is float64
    x64_jnp = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                       if not k.startswith("__")})
    x64_jnp.float32 = jnp.float64
    monkeypatch.setattr(JH, "jnp", x64_jnp)
    with _jax_dtype("float64", monkeypatch):
        v = {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), models["jnf"][1])}
        jx = [jnp.asarray(x) for x in xs]
        want, want_acc = JH.sample_from_poe_subset(
            jb.model, v, [0, 1], jx, key, mcmc_steps=steps, n_lf=10, eps_lf=0.01, K=k,
            divide_prior=divide_prior, return_acceptance=True)
        k0, k_loop = jax.random.split(key)
        z0 = JH.sample_from_moe_subset(jb.model, v, [0, 1], [jnp.concatenate([x] * k) for x in jx],
                                       k0)
        rho, u = [], []
        for _ in range(steps):
            k_loop, k_gamma, k_acc = jax.random.split(k_loop, 3)
            rho.append(np.asarray(jax.random.normal(k_gamma, (n, LATENT), jnp.float64)))
            u.append(np.asarray(jax.random.uniform(k_acc, (n,))))
    got, acc = H.sample_from_poe_subset(
        bundle.model, [0, 1], [torch.tensor(x) for x in xs], mcmc_steps=steps, n_lf=10,
        eps_lf=0.01, K=k, divide_prior=divide_prior, return_acceptance=True,
        z0=torch.tensor(np.asarray(z0)), rho=torch.tensor(np.stack(rho)),
        u=torch.tensor(np.stack(u)))
    assert got.shape == (k, 3, LATENT) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    assert float(acc) == float(want_acc)


def test_hmc_density_matches_jax(models, monkeypatch):
    """The chain's density, whose experts are encoded once, and the
    gradient of its sum, taken under no_grad, against JAX's
    poe_log_density and jax.grad, float64 rtol 1e-10, with and without the
    prior divided out."""
    jb, _ = models["jnf"]
    bundle = _port(models, "jnf", "float64")
    bundle.model.eval()
    xs = _images(3, seed=6)
    z = np.random.default_rng(9).standard_normal((3, LATENT))
    for divide_prior in (False, True):
        with _jax_dtype("float64", monkeypatch):
            v = {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), models["jnf"][1])}

            def lnq(z_):
                return jb.model.apply(v, [0, 1], z_, [jnp.asarray(x) for x in xs],
                                      method="poe_log_density", divide_prior=divide_prior)

            want = np.asarray(lnq(jnp.asarray(z)))
            g_want = np.asarray(jax.grad(lambda z_: jnp.sum(lnq(z_)))(jnp.asarray(z)))
        with torch.no_grad():
            dens = bundle.model.poe_density([0, 1], [torch.tensor(x) for x in xs],
                                            divide_prior=divide_prior)
            got, g = H._log_q_and_grad(dens, torch.tensor(z))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-10, atol=1e-12)


def test_visualize_poe_writes_the_figure(models, tmp_path):
    """product_of_posteriors.png and its JSON: 2 rows of n_data panels, the
    unimodal posteriors beside the joint one (top) and the PoE (bottom)."""
    bundle = _port(models, "jnf", "float32")
    bundle.model.eval()
    xs = [torch.tensor(x, dtype=torch.float32) for x in _images(3, seed=7)]
    with torch.no_grad():
        path = LA.visualize_poe(bundle.model, xs, str(tmp_path), torch.Generator().manual_seed(0),
                                n_data=2, N=5, mcmc_steps=2)
    assert path == os.path.join(str(tmp_path), "product_of_posteriors.png")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(path + ".json") as f:
        spec = json.load(f)
    assert [[p["legend"] for p in row] for row in spec["panels"]] == [
        [["q(z|x)", "q(z|y)", "q(z|x,y)"]] * 2, [["q(z|x)", "q(z|y)", "PoE"]] * 2]
    assert all(len(s["points"]) == 5 for row in spec["panels"] for p in row for s in p["series"])

