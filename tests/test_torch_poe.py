"""MVAE and MoE-PoE of the port against the JAX package: the product-of-
experts functions, each model's self-built ELBO and every gradient leaf in
float64 and float32, the `m_self_built` objective, the two MNIST-SVHN
registry functions and the bridge of both parameter trees.

The registry's nets at latent 4 and B=4. Noise is drawn with numpy and
injected on the JAX side by replacing the module `D` that the JAX models
sample through (`mmvae_tpu.models.mvae.D`, `mmvae_tpu.models.moepoe.D`)
with a namespace whose `normal_sample` hands out the draws in turn: MVAE's
z_0, z_1, then z_joint; MoE-PoE's one mixture draw.
"""

import contextlib
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.models import moepoe as jmoepoe
from mmvae_tpu.models import mvae as jmvae
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.models import MOEPOE, MVAE, UnimodalVAE, poe, registry
from mmvae_tpu_torch.models.mvae import all_subsets
from mmvae_tpu_torch.objectives import objectives as pobj

# the package's __init__ exports the function `poe` under the module's name
jpoe = importlib.import_module("mmvae_tpu.models.poe")

CONFIGS = {"mvae": "configs/mnist_svhn/mvae_synth.json",
           "moepoe": "configs/mnist_svhn/moepoe_synth.json"}
JAX_MODULES = {"mvae": jmvae, "moepoe": jmoepoe}
N_DRAWS = {"mvae": 3, "moepoe": 1}
LATENT, B = 4, 4
# (value rtol, gradient tolerance as a share of each leaf's largest entry)
TOLERANCES = {"float64": (1e-10, 1e-8), "float32": (1e-5, 1e-4)}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _x64(dtype):
    """JAX in float64 (x64 on, the float64 policy), or as it is."""
    if dtype == "float32":
        yield
        return
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jprec.use("float64"):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _inject_normal(monkeypatch, fam, eps):
    """The JAX model `fam` samples `eps` in turn; returns the calls made."""
    calls = []

    def normal_sample(p, key, sample_shape=()):
        assert tuple(sample_shape) == ()
        e = jnp.asarray(eps[len(calls)], p.loc.dtype)
        calls.append(e.shape)
        return p.loc + e * p.scale

    proxy = types.SimpleNamespace(**{k: getattr(JD, k) for k in dir(JD) if not k.startswith("__")})
    proxy.normal_sample = normal_sample
    monkeypatch.setattr(JAX_MODULES[fam], "D", proxy)
    return calls


@pytest.fixture(scope="module")
def jax_models():
    """{family: (JAX bundle, float32 numpy params)} at latent 4."""
    out = {}
    for fam, path in CONFIGS.items():
        jcfg = JCfg.from_json(path)
        jcfg.latent_dim = LATENT
        jb = jreg.build(jcfg)
        xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
        params = jax.jit(lambda k, x, jb=jb: jb.model.init(
            {"params": k, "sample": k}, x, K=1)["params"])(jax.random.PRNGKey(0), xs)
        out[fam] = (jb, jax.tree.map(np.asarray, params))
    return out


def _port(jax_models, fam, dtype=torch.float32):
    cfg = ExperimentConfig.from_json(CONFIGS[fam])
    cfg.latent_dim = LATENT
    bundle = registry.build(cfg)
    bundle.model.to(dtype)
    load_jax_params(bundle.model, jax_models[fam][1])
    return bundle


def _grads_tree(model, grads):
    """The JAX-layout tree of `grads` (one per model parameter)."""
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(model)))
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


# ---------------------------------------------------------------------------
# the PoE functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_mod", [2, 3])
def test_poe_functions_match_jax(n_mod):
    """poe (with and without the prior expert), poe_log_var on a subset and
    poe_for_all_subsets, float64 on both sides: rtol 1e-12. Log-variances
    spread over [-6, 6], so that one expert dominates some entries."""
    rng = np.random.default_rng(n_mod)
    mus = [rng.standard_normal((5, 3)) for _ in range(n_mod)]
    lvs = [rng.uniform(-6, 6, size=(5, 3)) for _ in range(n_mod)]
    t_mus, t_lvs = [torch.tensor(m) for m in mus], [torch.tensor(v) for v in lvs]
    with _x64("float64"):
        j_mus, j_lvs = [jnp.asarray(m) for m in mus], [jnp.asarray(v) for v in lvs]
        want = {"poe": jpoe.poe(j_mus, j_lvs),
                "poe_no_prior": jpoe.poe(j_mus, j_lvs, include_prior=False),
                "poe_log_var": jpoe.poe_log_var(j_mus, j_lvs, [1, 0], include_prior=True),
                "all_subsets": sum(jpoe.poe_for_all_subsets(j_mus, j_lvs), [])}
        want = {k: [np.asarray(a) for a in v] for k, v in want.items()}
    got = {"poe": poe.poe(t_mus, t_lvs),
           "poe_no_prior": poe.poe(t_mus, t_lvs, include_prior=False),
           "poe_log_var": poe.poe_log_var(t_mus, t_lvs, [1, 0], include_prior=True),
           "all_subsets": sum(poe.poe_for_all_subsets(t_mus, t_lvs), [])}
    assert len(got["all_subsets"]) == 2 * (1 if n_mod == 2 else 4)
    for k, w in want.items():
        assert len(got[k]) == len(w)
        for a, b in zip(got[k], w):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("b,rows", [(128, [(0, 42), (42, 84), (84, 128)]),
                                    (79, [(0, 26), (26, 52), (52, 79)])])
def test_mixture_component_selection_matches_jax(b, rows):
    """Stratified selection over 3 components: component k's rows, the last
    taking the tail, as JAX's split (B=128, and a ragged batch of 79)."""
    rng = np.random.default_rng(b)
    mus = [rng.standard_normal((b, 2)).astype(np.float32) for _ in range(3)]
    lvs = [rng.standard_normal((b, 2)).astype(np.float32) for _ in range(3)]
    mu, lv = poe.mixture_component_selection([torch.tensor(m) for m in mus],
                                             [torch.tensor(v) for v in lvs])
    j_mu, j_lv = jpoe.mixture_component_selection([jnp.asarray(m) for m in mus],
                                                  [jnp.asarray(v) for v in lvs])
    np.testing.assert_array_equal(mu.numpy(), np.asarray(j_mu))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(j_lv))
    for k, (s, e) in enumerate(rows):
        np.testing.assert_array_equal(mu[s:e].numpy(), mus[k][s:e])


# ---------------------------------------------------------------------------
# the models' ELBOs and gradients
# ---------------------------------------------------------------------------

def _inputs(dtype, fam, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(B, 1, 28, 28)), rng.uniform(size=(B, 3, 32, 32))]
    eps = [rng.standard_normal((B, LATENT)) for _ in range(N_DRAWS[fam])]
    return [x.astype(dtype) for x in xs], [e.astype(dtype) for e in eps]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fam", list(CONFIGS))
def test_self_built_elbo_matches_jax(jax_models, monkeypatch, fam, dtype):
    """m_self_built on MVAE and MoE-PoE (the published beta_kl 20): the
    ELBO and every parameter's gradient (jax.grad of JAX's m_self_built),
    both packages in `dtype` at the same weights and noise; tolerances in
    TOLERANCES. The details are empty on both sides."""
    jb, params = jax_models[fam]
    xs, eps = _inputs(dtype, fam)
    calls = _inject_normal(monkeypatch, fam, eps)
    with _x64(dtype):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        jx = [jnp.asarray(x) for x in xs]

        def objective(p):
            obj, details, _ = jobj.m_self_built(jb.model, {"params": p}, jx,
                                                jax.random.PRNGKey(3), jb.spec, K=30)
            return obj, details

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))
    assert len(calls) == N_DRAWS[fam] and j_det == {}

    bundle = _port(jax_models, fam, getattr(torch, dtype))
    name, fn = pobj.resolve("self_built", True, False)
    assert name == "m_self_built" and fn is pobj.m_self_built
    obj, details = fn(bundle.model, [torch.tensor(x) for x in xs], bundle.spec, K=30,
                      noise=[torch.tensor(e) for e in eps])
    assert details == {} and obj.dtype == getattr(torch, dtype)
    value_rtol, grad_tol = TOLERANCES[dtype]
    np.testing.assert_allclose(obj.item(), j_obj, rtol=value_rtol)
    params_ = list(bundle.model.parameters())
    grads = torch.autograd.grad(obj, params_, allow_unused=True)
    ours = _grads_tree(bundle.model,
                       [torch.zeros_like(p) if g is None else g for p, g in zip(params_, grads)])
    assert sorted(ours) == sorted(j_grads)
    for path, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(ours[path], g, rtol=grad_tol, atol=grad_tol * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("fam", list(CONFIGS))
def test_forward_outputs_match_jax(jax_models, monkeypatch, fam):
    """The forward's other outputs, float64: MVAE's z_joint and joint
    posterior, MoE-PoE's draw and its components' stacked (mu, log_var),
    the two unimodal posteriors and the PoE of both, to rtol 1e-10."""
    jb, params = jax_models[fam]
    xs, eps = _inputs("float64", fam, seed=1)
    _inject_normal(monkeypatch, fam, eps)
    with _x64("float64"):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = jax.jit(lambda p, x: jb.model.apply({"params": p}, x, rngs={
            "sample": jax.random.PRNGKey(0)}))(jparams, [jnp.asarray(x) for x in xs])
        want = {k: np.asarray(v) for k, v in want.items()}
    bundle = _port(jax_models, fam, torch.float64)
    with torch.no_grad():
        got = bundle.model([torch.tensor(x) for x in xs], noise=[torch.tensor(e) for e in eps])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-10, atol=1e-12, err_msg=k)
    if fam == "moepoe":
        assert tuple(got["mus"].shape) == (3, B, LATENT)


def test_registry_functions_follow_the_config():
    """Both registry functions and their entries: MNIST-SVHN nets with
    normal posteriors and no flow, the (3*32*32)/(28*28) likelihood
    scaling, the MoE-PoE KL weight fixed from the config's beta_kl (20
    published, 1 in the _b1 twin), as JAX builds them."""
    for path, cls, beta in (("configs/mnist_svhn/mvae.json", MVAE, None),
                            ("configs/mnist_svhn/moepoe.json", MOEPOE, 20),
                            ("configs/mnist_svhn/moepoe_synth_b1.json", MOEPOE, 1)):
        cfg, jcfg = ExperimentConfig.from_json(path), JCfg.from_json(path)
        bundle, jb = registry.build(cfg), jreg.build(jcfg)
        model = bundle.model
        assert isinstance(model, cls) and bundle.model_name == jb.model_name
        assert registry.REGISTRY[cfg.model] is getattr(registry, cfg.model)
        assert model.lik_scaling == tuple(jb.model.lik_scaling) == (3 * 32 * 32 / 784, 1.0)
        assert bundle.spec.lik_scaling == tuple(jb.spec.lik_scaling)
        assert bundle.spec.posterior == "normal" and bundle.spec.latent_dim == 20
        assert bundle.dataset == "mnist_svhn" and bundle.classifier_keys == ("mnist", "svhn")
        assert all(isinstance(v, UnimodalVAE) and v.flow is None and v.posterior == "normal"
                   for v in model.vaes)
        if beta is not None:
            assert model.beta_kl == jb.model.beta_kl == beta
            assert model.recon_dists == ("normal", "normal")


def test_mvae_subsampling_needs_three_modalities():
    """With two modalities subsampling has no subset to draw, as in JAX; on
    three modalities the model takes it, with the three 2-subsets
    (tests/test_torch_msf_models.py holds it to JAX)."""
    cfg = ExperimentConfig.from_json(CONFIGS["mvae"])
    vaes = list(registry.build(cfg).model.vaes)
    assert MVAE(vaes, (1.0, 1.0), subsampling=True, k_subsample=1).subsampling
    assert all_subsets(2) == [] and all_subsets(3) == [[0, 1], [0, 2], [1, 2]]
    model = MVAE(vaes + vaes[:1], (1.0, 1.0, 1.0), subsampling=True, k_subsample=1)
    assert model.subsampling and model.n_mod == 3


@pytest.mark.parametrize("fam", list(CONFIGS))
def test_bridge_maps_jax_trees(jax_models, fam):
    """Every leaf of the JAX MVAE and MoE-PoE trees lands on one port
    parameter and comes back unchanged."""
    _, params = jax_models[fam]
    bundle = _port(jax_models, fam)
    back = dict(_flat(export_jax_params(bundle.model)))
    ref = dict(_flat(params))
    assert sorted(back) == sorted(ref)
    for path, v in ref.items():
        np.testing.assert_array_equal(back[path], v)
