"""Trimodal MNIST-SVHN-Fashion in the port against the JAX package: the
loaders (with the binarized MNIST-SVHN and MNIST-OASIS, the last two of
the JAX package's datasets), the three builders through the bridge, and
JMVAE-NF's and TELBO-NF's objectives with every gradient leaf on three
modalities (MVAE, MMVAE and DCCA: test_torch_msf_models.py; evaluation:
test_torch_msf_eval.py; the CLIs: test_torch_msf_cli.py).

The registry's nets at latent 4 and B=4 (the joint heads stay 20 wide, as
the JAX registry builds them). The weights are the port's initialiser's,
exported to JAX's layout: JAX's own init only gives the tree's structure
(`jax.eval_shape`), which the bridge must match, since compiling its
trimodal init costs tens of seconds on the CPU. Noise is drawn with numpy
and injected on the JAX side by monkeypatching the sampler
(mmvae_tpu.models.vae.D.sample), in JAX's draw order; the JAX flows run
their own plain solve (`unrolled_solve`), as in test_torch_jmvae_nf.py.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.data import loaders as jloaders
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.models import vae as jvae
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import loaders
from mmvae_tpu_torch.models import JMVAE_NF, MMVAE, MVAE, registry
from mmvae_tpu_torch.nets.conv import init_parameters
from mmvae_tpu_torch.objectives import m_jmvae_nf, m_telbo_nf

CONFIGS = {"jnf": "configs/msf/jmvae_nf.json", "jnf_dcca": "configs/msf/jmvae_nf_dcca.json",
           "mmvae": "configs/msf/mmvae.json", "mvae": "configs/msf/mvae.json"}
LATENT, B = 4, 4
R = (3 * 32 * 32) / (28 * 28)


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


def _zeros(n=2):
    return [jnp.zeros((n, 1, 28, 28)), jnp.zeros((n, 3, 32, 32)), jnp.zeros((n, 1, 28, 28))]


def _cfgs(fam):
    jcfg, cfg = JCfg.from_json(CONFIGS[fam]), ExperimentConfig.from_json(CONFIGS[fam])
    for c in (jcfg, cfg):
        c.latent_dim = LATENT
    return jcfg, cfg


def jax_tree_shapes(jb, jnf: bool):
    """{path: shape} of the JAX model's params, from its init traced
    abstractly (init_all for JMVAE-NF, which reaches every path)."""
    def init(k, x):
        return jb.model.init({"params": k, "sample": k}, x, K=1,
                             method="init_all" if jnf else None)["params"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)
        tree = jax.eval_shape(init, jax.random.PRNGKey(0), _zeros())
    return {k: tuple(v.shape) for k, v in _flat_shapes(tree)}


def _flat_shapes(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat_shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def models():
    """{family: (JAX bundle, float32 numpy params)} at latent 4: the port's
    initial weights (seed 0) in JAX's layout."""
    out = {}
    for fam in CONFIGS:
        jb = jreg.build(_cfgs(fam)[0])
        bundle = registry.build(_cfgs(fam)[1])
        init_parameters(bundle.model, torch.Generator().manual_seed(0))
        out[fam] = (jb, export_jax_params(bundle.model))
    return out


def _port(models, fam, dtype=torch.float32):
    bundle = registry.build(_cfgs(fam)[1])
    bundle.model.to(dtype)
    load_jax_params(bundle.model, models[fam][1])
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
# the loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("mnist_svhn_fashion", dict(synthetic_n=512)),
    ("binary_mnist_svhn", dict(synthetic_n=256, len_train=300)),
    ("mnist_oasis", dict(synthetic_n=256, oasis_dim=64)),
])
def test_loaders_match_jax(name, kw):
    """Train, test and val splits: every modality and label array bit-equal
    to the JAX package's, and the same batches in the same order."""
    ours = loaders.get_dataloaders(name, data_path="/nonexistent", batch_size=32, **kw)
    theirs = jloaders.get_dataloaders(name, data_path="/nonexistent", batch_size=32, **kw)
    for a, b in zip(ours, theirs):
        assert len(a.dataset) == len(b.dataset) > 0 and len(a) == len(b)
        assert len(a.dataset.modalities) == (3 if name == "mnist_svhn_fashion" else 2)
        for ma, mb in zip(a.dataset.modalities, b.dataset.modalities):
            np.testing.assert_array_equal(np.asarray(ma), np.asarray(mb))
        for la, lb in zip(a.dataset.labels, b.dataset.labels):
            np.testing.assert_array_equal(la, lb)
        (xa, ya), (xb, yb) = next(iter(a)), next(iter(b))
        for u, v in zip(xa + ya, xb + yb):
            np.testing.assert_array_equal(u, v)
    if name == "binary_mnist_svhn":
        assert set(np.unique(np.asarray(ours[0].dataset.modalities[0]))) <= {0.0, 1.0}


def test_every_jax_dataset_is_ported():
    """get_dataloaders takes every key of the JAX package's DATASETS."""
    assert sorted(loaders.DATASETS) == sorted(jloaders.DATASETS)


# ---------------------------------------------------------------------------
# the builders and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(CONFIGS))
def test_bridge_maps_jax_trees(models, fam):
    """The port's tree in JAX's layout has every path and shape of JAX's
    own; each leaf loads onto one port parameter and comes back unchanged;
    the builders wire the model as JAX's do."""
    jb, params = models[fam]
    ref = dict(_flat(params))
    assert {k: v.shape for k, v in ref.items()} == jax_tree_shapes(jb, fam.startswith("jnf"))
    bundle = registry.build(_cfgs(fam)[1])
    load_jax_params(bundle.model, jax.tree.map(lambda a: a + 1.0, params))
    back = dict(_flat(export_jax_params(bundle.model)))
    assert sorted(back) == sorted(ref)
    for path, v in ref.items():
        np.testing.assert_array_equal(back[path], v + 1.0)
    model = bundle.model
    assert bundle.dataset == jb.dataset == "mnist_svhn_fashion"
    assert bundle.model_name == jb.model_name
    assert bundle.shape_mods == tuple(jb.shape_mods)
    assert bundle.classifier_keys == ("mnist", "svhn", "fashion")
    assert tuple(bundle.spec.lik_scaling) == tuple(jb.spec.lik_scaling)
    assert tuple(bundle.spec.recon_dists) == tuple(jb.spec.recon_dists)
    assert len(model.vaes) == 3
    if fam.startswith("jnf"):
        assert isinstance(model, JMVAE_NF) and all(v.flow is not None for v in model.vaes)
        assert (model.dcca_encoders is not None) == (fam == "jnf_dcca")
        if fam == "jnf_dcca":
            # three raw trunks behind the identity, under TwoStepsEncoders
            for i, d in enumerate(model.dcca_encoders):
                assert d is model.vaes[i].encoder.first_encoder and not d.fitted_lcca
                np.testing.assert_array_equal(d.w.numpy(), np.eye(16, dtype=np.float32))
    elif fam == "mmvae":
        assert isinstance(model, MMVAE) and model.posterior == "laplace"
    else:
        assert isinstance(model, MVAE) and model.subsampling and model.k_subsample == 1


@pytest.mark.parametrize("llik", [0.0, 2.5])
def test_lik_scaling_follows_the_family(llik):
    """(r, 1, r) at llik_scaling 0 for MMVAE and MVAE, r = 3*32*32/(28*28);
    otherwise (1, 1, 1) for MMVAE and (llik, 1, llik) for MVAE; JMVAE-NF
    (1, 1, 1) always. The same on the JAX side."""
    want = {"mmvae": (R, 1.0, R) if llik == 0 else (1.0, 1.0, 1.0),
            "mvae": (R, 1.0, R) if llik == 0 else (llik, 1.0, llik),
            "jnf": (1.0, 1.0, 1.0)}
    for fam, ls in want.items():
        jcfg, cfg = _cfgs(fam)
        jcfg.llik_scaling = cfg.llik_scaling = llik
        bundle = registry.build(cfg)
        assert bundle.spec.lik_scaling == pytest.approx(ls)
        assert tuple(jreg.build(jcfg).spec.lik_scaling) == pytest.approx(ls)
        if fam == "mvae":
            assert bundle.model.lik_scaling == pytest.approx(ls)


# ---------------------------------------------------------------------------
# JMVAE-NF and TELBO-NF on three modalities
# ---------------------------------------------------------------------------

def _inputs(dtype, n_eps, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(B, 1, 28, 28)), rng.uniform(size=(B, 3, 32, 32)),
          rng.uniform(size=(B, 1, 28, 28))]
    eps = [rng.standard_normal((B, LATENT)) for _ in range(n_eps)]
    return [x.astype(dtype) for x in xs], [e.astype(dtype) for e in eps]


def _inject_normal(monkeypatch, eps):
    """The JAX package's samplers draw `eps` in turn."""
    calls = []

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal" and tuple(sample_shape) == ()
        e = eps[len(calls)]
        calls.append(dist)
        return p.loc + jnp.asarray(e) * p.scale

    monkeypatch.setattr(jvae.D, "sample", sample)
    return calls


@contextlib.contextmanager
def _jax_dtype(dtype, monkeypatch):
    """JAX's flows on their plain solve, in float64 (x64 on, the float64
    policy) or as they are."""
    monkeypatch.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)
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


# (value rtol, gradient tolerance as a share of each leaf's largest entry)
TOLERANCES = {"float64": (1e-10, 1e-8), "float32": (1e-5, 1e-4)}
# case -> (objective, past warmup)
CASES = {"jnf_warmup": ("jmvae_nf", False), "jnf_post": ("jmvae_nf", True),
         "telbo_post": ("telbo_nf", True)}


def _check(obj, details, model, j_obj, j_det, j_grads, dtype):
    value_rtol, grad_tol = TOLERANCES[dtype]
    assert obj.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(obj.item(), j_obj, rtol=value_rtol)
    assert sorted(details) == sorted(j_det)
    for k, v in j_det.items():
        np.testing.assert_allclose(float(details[k]), v, rtol=value_rtol,
                                   atol=value_rtol * abs(j_obj), err_msg=k)
    params_ = list(model.parameters())
    grads = torch.autograd.grad(obj, params_, allow_unused=True)
    ours = _grads_tree(model, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params_, grads)])
    assert sorted(ours) == sorted(j_grads)
    for path, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(ours[path], g, rtol=grad_tol, atol=grad_tol * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_jnf_objectives_match_jax(models, monkeypatch, case, dtype):
    """m_jmvae_nf in warmup and past warmup (compute_kld over three flow
    posteriors, with the unimodal reconstructions) and m_telbo_nf past
    warmup (three unimodal VAE forwards under autograd) on jnf_msf: the
    value, its details and every gradient leaf, both packages in `dtype` at
    the same weights and noise; tolerances in TOLERANCES. TELBO's spec
    names the squared error for all three VAEs, which the port's builder
    sets and the JAX package's lacks (its default names two)."""
    name, past = CASES[case]
    jb, params = models["jnf"]
    n_eps = (2 + 3 if past else 1) if name == "jmvae_nf" else 1 + 3
    xs, eps = _inputs(dtype, n_eps)
    calls = _inject_normal(monkeypatch, eps)
    kw = dict(epoch=2 if past else 1, warmup=2, beta_prior=1.0, past_warmup=past)
    if name == "jmvae_nf":
        kw["beta_kl"] = 0.7
    bundle = _port(models, "jnf", getattr(torch, dtype))
    assert len(jb.spec.vae_recon_losses) == 2 and bundle.spec.vae_recon_losses == ("mse",) * 3
    spec = dataclasses.replace(jb.spec, vae_recon_losses=("mse",) * 3)
    jfn = getattr(jobj, f"m_{name}")
    with _jax_dtype(dtype, monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        jx = [jnp.asarray(x) for x in xs]

        def objective(p):
            obj, details, _ = jfn(jb.model, {"params": p}, jx, jax.random.PRNGKey(3), spec,
                                  train=True, **kw)
            return obj, details

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))
        j_det = {k: float(v) for k, v in j_det.items()}
    assert len(calls) == n_eps
    fn = m_jmvae_nf if name == "jmvae_nf" else m_telbo_nf
    obj, details = fn(bundle.model, [torch.tensor(x) for x in xs], bundle.spec,
                      noise=[torch.tensor(e) for e in eps], **kw)
    _check(obj, details, bundle.model, j_obj, j_det, j_grads, dtype)
