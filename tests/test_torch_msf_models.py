"""Trimodal MNIST-SVHN-Fashion in the port against the JAX package: MVAE's
ELBO with subset subsampling, MMVAE's DReG-looser objective on three
modalities, the three-view mcca losses with their gradients, and one epoch
of the three-view DCCA Solver. Models and weights as in
test_torch_msf.py, whose helpers this file uses.

JAX's MVAE draws its normal noise through `mmvae_tpu.models.mvae.D` and
its subset mask from `jax.random.permutation`: both are replaced, in the
module, by namespaces that hand out the test's draws; the port takes them
as `noise=[z_0, z_1, z_2, z_joint, mask, z_{01}, z_{02}, z_{12}]`. JAX's
Laplace noise is injected as in test_torch_mmvae.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.data import get_dataloaders as jax_dataloaders
from mmvae_tpu.dcca import objectives as JO
from mmvae_tpu.dcca.nets import dcca_encoders_msf as j_trunks
from mmvae_tpu.dcca.train import Solver as JSolver
from mmvae_tpu.models import mvae as jmvae
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.bridge import export_jax_params
from mmvae_tpu_torch.core import distributions as D
from mmvae_tpu_torch.data import get_dataloaders
from mmvae_tpu_torch.dcca import objectives as O
from mmvae_tpu_torch.dcca.nets import DCCA_BUILDERS, dcca_encoders_msf
from mmvae_tpu_torch.dcca.train import Solver
from mmvae_tpu_torch.models.mvae import all_subsets
from mmvae_tpu_torch.objectives import objectives as pobj
from test_torch_msf import (  # noqa: F401  (models: a fixture)
    B, LATENT, TOLERANCES, _check, _flat, _inputs, _jax_dtype, _one_torch_thread, _port, models,
)


# ---------------------------------------------------------------------------
# MVAE with subset subsampling
# ---------------------------------------------------------------------------

def _inject_mvae(monkeypatch, eps, perm):
    """JAX's MVAE samples `eps` in turn and permutes its subsets by `perm`."""
    calls = []

    def normal_sample(p, key, sample_shape=()):
        assert tuple(sample_shape) == ()
        e = jnp.asarray(eps[len(calls)], p.loc.dtype)
        calls.append(e.shape)
        return p.loc + e * p.scale

    d = types.SimpleNamespace(**{k: getattr(JD, k) for k in dir(JD) if not k.startswith("__")})
    d.normal_sample = normal_sample
    random = types.SimpleNamespace(permutation=lambda key, n: jnp.asarray(perm))
    monkeypatch.setattr(jmvae, "D", d)
    monkeypatch.setattr(jmvae, "jax", types.SimpleNamespace(random=random))
    return calls


@pytest.mark.parametrize("dtype,chosen", [("float64", 2), ("float32", 0)])
def test_mvae_subsampling_matches_jax(models, monkeypatch, dtype, chosen):
    """m_self_built on mvae_msf: three unimodal ELBOs, the joint ELBO and the
    ELBO of the one 2-subset that JAX's permutation puts first, its mask
    and all seven normal draws injected; the value and every gradient leaf
    (tolerances of test_torch_msf.py). The port computes the chosen
    subset's term alone: the other two have gradient 0 in JAX."""
    jb, params = models["mvae"]
    assert all_subsets(3) == [[0, 1], [0, 2], [1, 2]]
    perm = np.roll(np.arange(3), -chosen)
    xs, eps = _inputs(dtype, 7)
    calls = _inject_mvae(monkeypatch, eps, perm)
    with _jax_dtype(dtype, monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        jx = [jnp.asarray(x) for x in xs]

        def objective(p):
            obj, details, _ = jobj.m_self_built(jb.model, {"params": p}, jx,
                                                jax.random.PRNGKey(3), jb.spec)
            return obj, details

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))
    assert len(calls) == 7
    mask = np.zeros(3, dtype)
    mask[chosen] = 1.0
    noise = eps[:4] + [mask] + eps[4:]
    bundle = _port(models, "mvae", getattr(torch, dtype))
    obj, details = pobj.m_self_built(bundle.model, [torch.tensor(x) for x in xs], bundle.spec,
                                     noise=[torch.tensor(e) for e in noise])
    _check(obj, details, bundle.model, j_obj, j_det, j_grads, dtype)


def test_mvae_subsampling_draws_one_subset(models):
    """From a generator, k_subsample = 1 subset a step: the ELBO differs from
    the one without subsampling by exactly one subset's term, which is one
    of the three the injected masks give."""
    bundle = _port(models, "mvae", torch.float64)
    xs, eps = _inputs("float64", 7, seed=1)
    xs, eps = [torch.tensor(x) for x in xs], [torch.tensor(e) for e in eps]
    with torch.no_grad():
        terms = []
        for s in range(3):
            mask = torch.zeros(3, dtype=torch.float64)
            mask[s] = 1.0
            terms.append(bundle.model(xs, noise=eps[:4] + [mask] + eps[4:])["elbo"].item())
        got = bundle.model(xs, noise=eps[:4] + [None, eps[4], eps[5], eps[6]],
                           generator=torch.Generator().manual_seed(5))["elbo"].item()
    assert len(set(terms)) == 3 and got in terms


# ---------------------------------------------------------------------------
# MMVAE-DReG on three modalities
# ---------------------------------------------------------------------------

K = 3


def _inject_uniform(monkeypatch, us):
    """JAX's laplace_sample draws `us` in turn (as test_torch_mmvae.py)."""
    calls = []

    def uniform(key, shape, dtype=None, minval=0.0, maxval=1.0):
        u = us[len(calls) % len(us)]
        calls.append(tuple(shape))
        assert tuple(shape) == u.shape
        return jnp.asarray(u, dtype=dtype)

    proxy = types.SimpleNamespace(random=types.SimpleNamespace(uniform=uniform), nn=jax.nn)
    monkeypatch.setattr(JD, "jax", proxy)
    return calls


def test_mmvae_dreg_looser_matches_jax(models, monkeypatch):
    """m_dreg_looser on mmvae_msf (Laplace posteriors, the (r, 1, r)
    likelihood scaling) at K=3 in float64: the value and every gradient
    leaf against JAX's own DReG gradients (rtol 1e-10, 1e-8 of a leaf)."""
    jb, params = models["mmvae"]
    rng = np.random.default_rng(4)
    xs, _ = _inputs("float64", 0)
    us = [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, size=(K, B, LATENT)) for _ in range(3)]
    calls = _inject_uniform(monkeypatch, us)
    with _jax_dtype("float64", monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, "float64"), params)
        out = jax.jit(lambda p: jobj.m_dreg_looser(jb.model, {"params": p},
                                                   [jnp.asarray(x) for x in xs],
                                                   jax.random.PRNGKey(3), jb.spec, K=K))(jparams)
        j_obj, j_grads = float(out[0]), dict(_flat(out[3]))
    assert len(calls) == 3
    bundle = _port(models, "mmvae", torch.float64)
    assert pobj.resolve("dreg", True, True)[0] == "m_dreg_looser"
    obj, details = pobj.m_dreg_looser(bundle.model, [torch.tensor(x) for x in xs], bundle.spec,
                                      K=K, noise=[torch.tensor(u) for u in us])
    _check(obj, details, bundle.model, j_obj, {}, j_grads, "float64")


# ---------------------------------------------------------------------------
# three-view DCCA
# ---------------------------------------------------------------------------

def test_mcca_losses_and_gradients_match_jax():
    """The pairwise mcca loss (eigh) and its Cholesky form over three
    views, value and the gradient of every view, float64: rtol 1e-10."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(120, 4))
    hs = [np.concatenate([z, rng.normal(size=(120, 4))], 1) @ rng.normal(size=(8, 8))
          + 0.3 * rng.normal(size=(120, 8)) for _ in range(3)]
    for jfn, fn in ((JO.mcca_loss, O.mcca_loss), (JO.mcca_loss_chol, O.mcca_loss_chol)):
        with pytest.MonkeyPatch.context() as mp, _jax_dtype("float64", mp):
            j_val, j_grads = jax.value_and_grad(lambda h: jfn(h, 4))([jnp.asarray(h) for h in hs])
        ts = [torch.tensor(h, requires_grad=True) for h in hs]
        val = fn(ts, 4)
        grads = torch.autograd.grad(val, ts)
        np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-10)
        for g, jg in zip(grads, j_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-12)


def test_three_view_solver_epoch_matches_jax(tmp_path):
    """One epoch of the three-view Solver (the pairwise mcca Cholesky loss,
    float32, batch 48: 9 steps) from the same weights as JAX's on the same
    triples, at learning rate 1e-5: the train and val losses to JAX's
    printed 4 decimals, every trunk parameter to 1e-4 of its leaf's largest
    entry, the linear CCA of the first two views' means and correlations to
    1e-3 of their largest entry; the artifact holds the first two views'
    projections only. (At the published 1e-3, RMSprop's early steps are
    about lr * sign(g), so float32 round-off in a small gradient moves a
    parameter by a few lr, and the three CCA pairs, falling from -11 to -21
    over the epoch, carry it to 4e-4 of the loss; the optimizer itself is
    held to optax in test_torch_dcca.py.)"""
    builder, outdim = DCCA_BUILDERS["mnist_svhn_fashion"]
    assert builder is dcca_encoders_msf and outdim == 16
    kw = dict(batch_size=48, synthetic_n=128, data_path=str(tmp_path / "data"))
    j_train, _, j_val = jax_dataloaders("mnist_svhn_fashion", **kw)
    train, _, val = get_dataloaders("mnist_svhn_fashion", **kw)
    xs, _ = next(iter(train))
    jsolver = JSolver(j_trunks(8), 8, learning_rate=1e-5, backend="chol")
    key = jax.random.PRNGKey(0)
    start, _ = jsolver.init(xs, key)
    logs = []
    jsolver.fit(j_train, j_val, epochs=1, key=key, log=logs.append)
    solver = Solver(dcca_encoders_msf(8), 8, learning_rate=1e-5, backend="chol", device="cpu")
    solver.fit(train, val, epochs=1, params=jax.tree.map(np.asarray, start["params"]),
               log=lambda s: None)
    (line,) = logs
    words = line.split()
    for k in ("train", "val"):
        assert abs(solver.history[f"{k}_loss"][0] - float(words[words.index(k) + 1])) <= 1.5e-4
    ours = dict(_flat(export_jax_params(solver.model)))
    theirs = dict(_flat(jax.tree.map(np.asarray, jsolver.variables["params"])))
    assert sorted(ours) == sorted(theirs) and any("encoders_2" in p for p in ours)
    for path, v in theirs.items():
        np.testing.assert_allclose(ours[path], v, rtol=0, atol=1e-4 * np.abs(v).max(),
                                   err_msg="/".join(path))
    for a, b in zip(solver.lcca.m + [solver.lcca.D], jsolver.lcca.m + [jsolver.lcca.D]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max())
    path = str(tmp_path / "dcca.npz")
    solver.save(path)
    with np.load(path) as npz:
        assert {"m0", "m1", "w0", "w1"} <= set(npz.files) and "m2" not in npz.files
        assert "params/encoders_2/Linear_0/kernel" in npz.files
