"""The multimodal objectives that no config of the repo selects, on the
port's JMVAE_NF, against the JAX package: m_jmvae (in warmup and past it),
m_vaevae_kl, m_vaevae_w2 (also with `align`), m_svae, m_multi_elbos and
m_telbo, each's value, details and every parameter's gradient (jax.grad
on the JAX side), in float64, on the small model of JAX's own tail tests
(latent 4, B=3, MLP nets of 16, tests/test_objectives_tail_parity.py);
once with MAF flows on the unimodal VAEs (the sampling direction, JAX on
`unrolled_solve`), and once on jnf_mnist_fashion's BatchNorm conv VAEs,
with the running statistics after the pass (test_torch_objectives_bn.py);
JMVAE_NF.unimodal_cross_forward on its own. The port's initial weights go to JAX through the bridge,
checked against the tree of JAX's init (jax.eval_shape); the noise is
drawn with numpy and handed to JAX's sampler (mmvae_tpu.models.vae.D.sample)
in draw order: the joint forward's, then each unimodal VAE's.
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
from mmvae_tpu.flows import MAF as JMAF
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.models import vae as jvae
from mmvae_tpu.models.jmvae_nf import JMVAE_NF as JJMVAE_NF
from mmvae_tpu.models.vae import UnimodalVAE as JUnimodalVAE
from mmvae_tpu.nets import DoubleHeadMLP as JDoubleHeadMLP
from mmvae_tpu.nets import MLPDecoder as JMLPDecoder
from mmvae_tpu.nets import MLPEncoder as JMLPEncoder
from mmvae_tpu.objectives import ModelSpec as JSpec
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, export_jax_variables
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.flows import MAF
from mmvae_tpu_torch.models import JMVAE_NF, UnimodalVAE, registry
from mmvae_tpu_torch.nets import DoubleHeadMLP, MLPDecoder, MLPEncoder, init_parameters
from mmvae_tpu_torch.objectives import ModelSpec
from mmvae_tpu_torch.objectives import objectives as pobj

LATENT, B, HIDDEN = 4, 3, 16
SHAPES = [(1, 8, 8), (2, 6, 6)]
LIK, LLIK = (2.0, 1.0), 1.5
# float64 on both sides: values 1e-10 relative, gradients 1e-9 of each
# leaf's largest entry
RTOL, GRAD_TOL = 1e-10, 1e-9
KW = dict(beta=2.5, beta_prior=1.3, epoch=3, warmup=2)
# objective -> the standard-normal draws it takes: the joint forward's,
# then each unimodal VAE's
DRAWS = {"m_jmvae": 1, "m_vaevae_kl": 2, "m_vaevae_w2": 2, "m_svae": 3, "m_multi_elbos": 3,
         "m_telbo": 3}
# (objective, model, past_warmup, spec overrides)
CASES = [("m_jmvae", "mlp", False, {}), ("m_jmvae", "mlp", True, {}),
         ("m_vaevae_kl", "mlp", True, {}), ("m_vaevae_w2", "mlp", True, {}),
         ("m_vaevae_w2", "mlp", False, dict(align=2)), ("m_svae", "mlp", True, {}),
         ("m_multi_elbos", "mlp", True, {}), ("m_telbo", "mlp", True, {}),
         ("m_telbo", "maf", True, {})]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _x64(monkeypatch):
    """JAX in float64, its flows on the plain solve."""
    monkeypatch.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jprec.use("float64"):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _small(flow: bool):
    """The port's and JAX's small JMVAE_NF, with MAF flows of 16 hidden
    units on the VAEs if `flow`."""
    vaes, jvaes = [], []
    for i, s in enumerate(SHAPES):
        vaes.append(UnimodalVAE(MLPEncoder(LATENT, int(np.prod(s)), HIDDEN),
                                MLPDecoder(LATENT, s, HIDDEN), LATENT,
                                flow=MAF(LATENT, hidden_size=HIDDEN) if flow else None))
        jvaes.append(JUnimodalVAE(
            encoder=JMLPEncoder(latent_dim=LATENT, hidden_dim=HIDDEN),
            decoder=JMLPDecoder(latent_dim=LATENT, output_shape=s, hidden_dim=HIDDEN),
            latent_dim=LATENT, flow=JMAF(features=LATENT, hidden_size=HIDDEN) if flow else None,
            model_name=f"m{i}"))
    joint = DoubleHeadMLP(LATENT, HIDDEN, [int(np.prod(s)) for s in SHAPES], num_hidden_layers=1)
    jjoint = JDoubleHeadMLP(latent_dim=LATENT, hidden_dim=HIDDEN, num_hidden_layers=1,
                            name="joint_encoder")
    spec = dict(latent_dim=LATENT, posterior="normal", recon_dists=("normal", "normal"),
                lik_scaling=LIK, llik_scaling=LLIK)
    return (JMVAE_NF(joint, vaes), ModelSpec(**spec), JJMVAE_NF(joint_encoder=jjoint, vaes=jvaes),
            JSpec(**spec), SHAPES, LATENT)


def _fashion():
    """jnf_mnist_fashion (BatchNorm conv MNIST VAEs, no flow) at latent 3,
    from both registries."""
    kw = dict(model="jnf_mnist_fashion", obj="multi_elbos", dist="normal",
              recon_losses=("normal", "normal"), latent_dim=3, batch_size=B, warmup=0,
              no_nf=True)
    cfg, jcfg = ExperimentConfig(**kw), JCfg(**kw)
    bundle, jb = registry.build(cfg), jreg.build(jcfg)
    return bundle.model, bundle.spec, jb.model, jb.spec, [(1, 28, 28)] * 2, 3


_MODELS = {}


def made_biases_off_zero(model, seed=5):
    """Move every MADE bias of `model` by uniform(-0.1, 0.1). At their zero
    init a hidden unit whose inputs are all 0 sits exactly on its ReLU's
    kink, where JAX's unrolled_solve (jnp.maximum) passes half a gradient
    and the port none, a deliberate divergence (ROADMAP.md section 3,
    tests/test_torch_celeba_tie.py)."""
    from mmvae_tpu_torch.flows import MaskedDense

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedDense):
                m.bias.add_(torch.empty(m.bias.shape).uniform_(-0.1, 0.1, generator=gen)
                            .to(m.bias.dtype))


def model(which):
    """which ("mlp", "maf", "bn") -> (port model in float64, spec, JAX model,
    JAX spec, shapes, latent, JAX variables of the port's initial weights),
    built once; the tree checked against JAX's init."""
    if which not in _MODELS:
        model, spec, jmodel, jspec, shapes, latent = (
            _fashion() if which == "bn" else _small(which == "maf"))
        init_parameters(model, torch.Generator().manual_seed(0))
        made_biases_off_zero(model)
        model.double()
        variables = {c: t for c, t in export_jax_variables(model).items() if t}
        xs = [jnp.zeros((2,) + s) for s in shapes]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)
            tree = jax.eval_shape(lambda k: jmodel.init({"params": k, "sample": k}, xs, K=1,
                                                        method="init_all"),
                                  jax.random.PRNGKey(0))
        assert {c: {p: v.shape for p, v in _flat(t)} for c, t in variables.items()} == \
            {c: {p: v.shape for p, v in _flat(t)} for c, t in tree.items()}
        _MODELS[which] = (model, spec, jmodel, jspec, shapes, latent, variables)
    return _MODELS[which]


def _inject(monkeypatch, eps):
    calls = []

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal" and tuple(sample_shape) == ()
        e = eps[len(calls)]
        calls.append(dist)
        return p.loc + jnp.asarray(e) * p.scale

    monkeypatch.setattr(jvae.D, "sample", sample)
    return calls


def _inputs(shapes, latent, n_draws, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(B,) + s) for s in shapes]
    return xs, [rng.standard_normal((B, latent)) for _ in range(n_draws)]


def _grads_tree(model, grads):
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(model)))
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


def check_objective(monkeypatch, name, which, past_warmup, overrides):
    """The objective's value and details at rtol 1e-10, every gradient leaf
    within 1e-9 of its largest entry, and the BatchNorm running statistics
    after the pass, at the same weights and noise. A conv bias right before
    a BatchNorm has a gradient of 0 but for round-off in both packages: it
    is held within 1e-9 of its kernel's largest entry."""
    model_, spec, jmodel, jspec, shapes, latent, variables = model(which)
    xs, eps = _inputs(shapes, latent, DRAWS[name])
    calls = _inject(monkeypatch, eps)
    kw = dict(KW, past_warmup=past_warmup)
    with _x64(monkeypatch):
        jv = jax.tree.map(jnp.asarray, variables)
        js = dataclasses.replace(jspec, **overrides)

        def objective(p):
            obj, details, state = jobj.OBJECTIVES[name](
                jmodel, {**jv, "params": p}, [jnp.asarray(x) for x in xs],
                jax.random.PRNGKey(3), js, train=True, **kw)
            return obj, (details, state)

        (j_obj, (j_det, j_state)), j_grads = jax.value_and_grad(objective, has_aux=True)(
            jv["params"])
        j_obj, j_grads = float(j_obj), {k: np.asarray(v) for k, v in _flat(j_grads)}
        j_det = {k: float(v) for k, v in j_det.items()}
        j_stats = {k: np.asarray(v) for k, v in _flat(j_state.get("batch_stats", {}))}
    assert len(calls) == DRAWS[name]

    model_.train()
    saved = [b.clone() for b in model_.buffers()]
    try:
        obj, details = pobj.OBJECTIVES[name](
            model_, [torch.tensor(x) for x in xs], dataclasses.replace(spec, **overrides),
            noise=[torch.tensor(e) for e in eps], frozen_joint=True, **kw)
        stats = dict(_flat(export_jax_variables(model_)["batch_stats"]))
        params = list(model_.parameters())
        grads = torch.autograd.grad(obj, params, allow_unused=True)
    finally:
        with torch.no_grad():
            for b, s in zip(model_.buffers(), saved):
                b.copy_(s)
    np.testing.assert_allclose(obj.item(), j_obj, rtol=RTOL)
    assert sorted(details) == sorted(j_det)
    for k, v in j_det.items():
        np.testing.assert_allclose(float(details[k]), v, rtol=RTOL, atol=RTOL * abs(j_obj),
                                   err_msg=k)
    ours = _grads_tree(model_, [torch.zeros_like(p) if g is None else g
                                for p, g in zip(params, grads)])
    assert sorted(ours) == sorted(j_grads)
    for path, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-12)
        kernel = j_grads.get(path[:-1] + ("kernel",))
        if "bn" in which and path[-1] == "bias" and kernel is not None and \
                scale < 1e-10 * np.abs(kernel).max():
            scale = np.abs(kernel).max()
        np.testing.assert_allclose(ours[path], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg="/".join(path))
    joint = [np.abs(v).max() for p, v in ours.items() if p[0] == "joint_encoder"]
    assert (max(joint) == 0) == name.startswith("m_vaevae")
    assert sorted(stats) == sorted(j_stats) and (which == "bn") == bool(stats)
    for path, v in j_stats.items():
        np.testing.assert_allclose(stats[path], v, rtol=RTOL, atol=RTOL, err_msg="/".join(path))


@pytest.mark.parametrize("name,which,past_warmup,overrides", CASES,
                         ids=[f"{o}-{m}-{'post' if p else 'warmup'}{'-align' if s else ''}"
                              for o, m, p, s in CASES])
def test_tail_objective_matches_jax(monkeypatch, name, which, past_warmup, overrides):
    """`check_objective` on the small model, without and with MAF flows."""
    check_objective(monkeypatch, name, which, past_warmup, overrides)


def test_unimodal_cross_forward_matches_jax(monkeypatch):
    """JMVAE_NF.unimodal_cross_forward with MAF flows: each VAE's posterior,
    its sample (through the flow) and the M x M cross reconstructions."""
    model_, _, jmodel, _, shapes, latent, variables = model("maf")
    xs, eps = _inputs(shapes, latent, 2, seed=1)
    _inject(monkeypatch, eps)
    with _x64(monkeypatch):
        out = jmodel.apply(jax.tree.map(jnp.asarray, variables), [jnp.asarray(x) for x in xs],
                           train=False, method="unimodal_cross_forward",
                           rngs={"sample": jax.random.PRNGKey(0)})
    model_.eval()
    with torch.no_grad():
        got = model_.unimodal_cross_forward([torch.tensor(x) for x in xs],
                                           noise=[torch.tensor(e) for e in eps])
    pairs = [(got["zs"][m], out["zs"][m]) for m in range(2)]
    pairs += [(a, b) for m in range(2) for a, b in zip(got["qz_params"][m], out["qz_params"][m])]
    pairs += [(got["recons"][r][m], out["recons"][r][m]) for r in range(2) for m in range(2)]
    assert [tuple(t.shape) for t in got["recons"][0]] == [(B,) + s for s in shapes]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=RTOL)
