"""The unimodal objectives elbo, iwae and dreg of the port on a UnimodalVAE
against the JAX package in float64 (the value and every parameter's
gradient; for dreg JAX's own custom gradient, the fourth item it returns)
at K = 1, where UnimodalVAE drops the sample axis and the log-weights
restore it, and at K = 3, once through a MAF flow (the sampling
direction; JAX on `unrolled_solve`); `resolve` over every objective name of
the JAX package; and the Trainer's handling of the tail objectives:
m_jmvae freezes the joint encoder past warmup whatever fix_jencoder says,
m_vaevae_* leave it trainable at zero gradients and so unchanged, as
JAX's update does, and a unimodal DReG step.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.flows import MAF as JMAF
from mmvae_tpu.models import vae as jvae
from mmvae_tpu.models.vae import UnimodalVAE as JUnimodalVAE
from mmvae_tpu.nets import MLPDecoder as JMLPDecoder
from mmvae_tpu.nets import MLPEncoder as JMLPEncoder
from mmvae_tpu.objectives import ModelSpec as JSpec
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.flows import MAF
from mmvae_tpu_torch.models import UnimodalVAE
from mmvae_tpu_torch.nets import MLPDecoder, MLPEncoder, init_parameters
from mmvae_tpu_torch.objectives import ModelSpec
from mmvae_tpu_torch.objectives import objectives as pobj
from mmvae_tpu_torch.train import Trainer
from test_torch_objectives_tail import B, made_biases_off_zero, model as tail_model

LATENT, HIDDEN, SHAPE = 4, 16, (1, 8, 8)
SPEC = dict(latent_dim=LATENT, posterior="normal", recon_dists=("normal",), llik_scaling=1.5)
# float64 on both sides: values 1e-10 relative, gradients 1e-9 of each
# leaf's largest entry
RTOL, GRAD_TOL = 1e-10, 1e-9
CASES = [("elbo", 1, False), ("elbo", 3, False), ("iwae", 1, False), ("iwae", 3, False),
         ("dreg", 1, False), ("dreg", 3, False), ("dreg", 3, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _vae(flow: bool, seed=0):
    """The port's UnimodalVAE (MLP nets of 16, MAF flow of 16 if `flow`) in
    float64 and JAX's, with the port's initial weights as JAX params, the
    MADE biases moved off their zero init (`made_biases_off_zero`)."""
    vae = UnimodalVAE(MLPEncoder(LATENT, int(np.prod(SHAPE)), HIDDEN),
                      MLPDecoder(LATENT, SHAPE, HIDDEN), LATENT,
                      flow=MAF(LATENT, hidden_size=HIDDEN) if flow else None)
    init_parameters(vae, torch.Generator().manual_seed(seed))
    made_biases_off_zero(vae)
    jmodel = JUnimodalVAE(
        encoder=JMLPEncoder(latent_dim=LATENT, hidden_dim=HIDDEN),
        decoder=JMLPDecoder(latent_dim=LATENT, output_shape=SHAPE, hidden_dim=HIDDEN),
        latent_dim=LATENT, flow=JMAF(features=LATENT, hidden_size=HIDDEN) if flow else None)
    return vae.double(), jmodel, export_jax_params(vae)


@contextlib.contextmanager
def _x64(monkeypatch):
    monkeypatch.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jprec.use("float64"):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("name,K,flow", CASES,
                         ids=[f"{n}-K{k}{'-maf' if f else ''}" for n, k, f in CASES])
def test_unimodal_objective_matches_jax(monkeypatch, name, K, flow):
    """Value at rtol 1e-10 and every gradient leaf within 1e-9 of its
    largest entry, at the same weights and noise: (K, B, latent) draws, or
    (B, latent) where the VAE's forward drops the axis at K = 1 (dreg's
    encode_and_sample keeps it)."""
    vae, jmodel, params = _vae(flow)
    rng = np.random.default_rng(K)
    x = rng.uniform(size=(B,) + SHAPE)
    shape = (B, LATENT) if K == 1 and name != "dreg" else (K, B, LATENT)
    eps = rng.standard_normal(shape)
    calls = []

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal" and tuple(sample_shape) + p.loc.shape == eps.shape
        calls.append(dist)
        return p.loc + jnp.asarray(eps) * p.scale

    monkeypatch.setattr(jvae.D, "sample", sample)
    with _x64(monkeypatch):
        jp = jax.tree.map(jnp.asarray, params)
        args = (jnp.asarray(x), jax.random.PRNGKey(1), JSpec(**SPEC))
        if name == "dreg":
            j_obj, _, _, j_grads = jobj.dreg(jmodel, {"params": jp}, *args, K=K, train=True)
        else:
            def objective(p):
                return jobj.OBJECTIVES[name](jmodel, {"params": p}, *args, K=K, train=True,
                                             beta_prior=1.3)[0]

            j_obj, j_grads = jax.value_and_grad(objective)(jp)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))
    assert len(calls) == 1

    vae.train()
    obj, details = pobj.OBJECTIVES[name](vae, torch.tensor(x), ModelSpec(**SPEC), K=K,
                                         noise=torch.tensor(eps), beta_prior=1.3)
    assert details == {}
    np.testing.assert_allclose(obj.item(), j_obj, rtol=RTOL)
    grads = torch.autograd.grad(obj, list(vae.parameters()))
    saved = [p.detach().clone() for p in vae.parameters()]
    with torch.no_grad():
        for p, g in zip(vae.parameters(), grads):
            p.copy_(g)
        ours = dict(_flat(export_jax_params(vae)))
        for p, s in zip(vae.parameters(), saved):
            p.copy_(s)
    assert sorted(ours) == sorted(j_grads)
    for path, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-12)
        np.testing.assert_allclose(ours[path], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg="/".join(path))
    if flow:
        assert all(np.any(v) for p, v in ours.items() if p[0] == "flow")


def _names(name):
    """(obj, multimodal, looser) that main.py's dispatch turns into `name`."""
    multimodal, looser = name.startswith("m_"), name.endswith("_looser")
    obj = name[2:] if multimodal else name
    return obj[:-len("_looser")] if looser else obj, multimodal, looser


def test_resolve_refuses_no_jax_objective():
    """Every name of JAX's OBJECTIVES and CUSTOM_GRAD_OBJECTIVES (19)
    resolves to the port's function of that name; what JAX cannot resolve,
    the port cannot either."""
    names = sorted(set(jobj.OBJECTIVES) | set(jobj.CUSTOM_GRAD_OBJECTIVES))
    assert len(names) == 19 and sorted(pobj.OBJECTIVES) == names
    for name in names:
        got = pobj.resolve(*_names(name))
        assert got == (name, getattr(pobj, name)) and jobj.resolve(*_names(name))[0] == name
    assert pobj.resolve("elbo", True, True) == ("m_elbo", pobj.m_elbo)
    for args in (("elbo_nf", False, False), ("jmvae", True, True)):
        with pytest.raises(KeyError):
            jobj.resolve(*args)
        with pytest.raises(KeyError):
            pobj.resolve(*args)


@pytest.mark.parametrize("obj", ["jmvae", "vaevae_kl", "vaevae_w2"])
def test_trainer_keeps_the_joint_encoder(obj):
    """One post-warmup Trainer step on the small JMVAE_NF with fix_jencoder
    off: m_jmvae's freezing leaves the joint encoder out of the optimizer,
    m_vaevae_*'s never reach it, so its gradients are 0 and Adam's update
    of it is 0; either way it is bit-unchanged while the unimodal encoders
    move."""
    import copy

    model, spec = copy.deepcopy(tail_model("mlp")[0]).float(), tail_model("mlp")[1]
    cfg = ExperimentConfig(obj=obj, warmup=1, fix_jencoder=False, fix_decoders=False, beta=2.0)
    trainer = Trainer(model, spec, cfg, device="cpu")
    trainer.init_opt_state(past_warmup=True)
    joint = {n for n, _ in model.named_parameters() if n.startswith("joint_encoder")}
    assert joint and (joint.isdisjoint(trainer._trainable) == (obj == "jmvae"))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.uniform(size=(B,) + s), dtype=torch.float32)
          for s in [(1, 8, 8), (2, 6, 6)]]
    loss, details = trainer.train_step(xs, 1e-3, epoch=2)
    assert torch.isfinite(loss) and details["nan_skipped"] == 0.0
    after = dict(model.named_parameters())
    assert all(torch.equal(before[n], after[n]) for n in joint)
    assert all(not torch.equal(before[n], after[n]) for n in after
               if n.startswith("vaes.0.encoder"))


def test_unimodal_dreg_trainer_step():
    """A Trainer of a UnimodalVAE (multimodal=False) takes one tensor x and
    steps dreg at K=3 through a MAF flow: finite, every parameter moved."""
    vae = _vae(True)[0].float()
    cfg = ExperimentConfig(obj="dreg", K=3)
    trainer = Trainer(vae, ModelSpec(**SPEC), cfg, multimodal=False, device="cpu")
    assert trainer.obj_name == "dreg"
    trainer.init_opt_state()
    before = [p.detach().clone() for p in vae.parameters()]
    x = torch.tensor(np.random.default_rng(0).uniform(size=(B,) + SHAPE), dtype=torch.float32)
    loss, details = trainer.train_step(x, 1e-3)
    assert torch.isfinite(loss) and details["nan_skipped"] == 0.0
    assert all(not torch.equal(a, b) for a, b in zip(before, vae.parameters()))


def test_kl_fallback_and_wasserstein_match_jax(monkeypatch):
    """`kl`'s Monte Carlo estimate for a family without a closed form (the
    Bernoulli: K = 100 draws of p, the mean of ln p - ln q) from the same
    draws, and `wasserstein_2` with the reference's standard deviations in
    its trace term, against JAX in float64; closed forms stay closed."""
    from mmvae_tpu.core import distributions as JD
    from mmvae_tpu_torch.core import distributions as PD

    rng = np.random.default_rng(4)
    probs = [rng.uniform(0.05, 0.95, size=(B, LATENT)) for _ in range(2)]
    u = rng.uniform(size=(100, B, LATENT))
    monkeypatch.setattr(JD, "sample", lambda dist, p, key, shape=(): jnp.asarray(
        (u < np.asarray(p.loc)).astype(np.float64)))
    locs = [rng.standard_normal((B, LATENT)) for _ in range(2)]
    scales = [rng.uniform(0.2, 2.0, size=(B, LATENT)) for _ in range(2)]
    with _x64(monkeypatch):
        j_kl = JD.kl("bernoulli", *(JD.LocScale(jnp.asarray(p), jnp.ones_like(jnp.asarray(p)))
                                    for p in probs), key=jax.random.PRNGKey(0))
        j_w2 = JD.wasserstein_2(*(JD.LocScale(jnp.asarray(m), jnp.asarray(s))
                                  for m, s in zip(locs, scales)))
        j_normal = JD.kl("normal", *(JD.LocScale(jnp.asarray(m), jnp.asarray(s))
                                     for m, s in zip(locs, scales)))
    t = torch.tensor
    got = PD.kl("bernoulli", *(PD.LocScale(t(p), torch.ones_like(t(p))) for p in probs),
                noise=t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_kl), rtol=RTOL, atol=RTOL)
    pairs = [PD.LocScale(t(m), t(s)) for m, s in zip(locs, scales)]
    np.testing.assert_allclose(PD.wasserstein_2(*pairs).numpy(), np.asarray(j_w2), rtol=RTOL)
    np.testing.assert_allclose(PD.kl("normal", *pairs, noise=t(u)).numpy(),
                               np.asarray(j_normal), rtol=RTOL)
    with pytest.raises(ValueError):
        PD.kl("bernoulli", *(PD.LocScale(t(p), torch.ones_like(t(p))) for p in probs), K=5,
              noise=t(u))
