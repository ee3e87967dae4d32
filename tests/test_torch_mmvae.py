"""The flagship MMVAE-DReG slice of the port against the JAX package:
MMVAE on MNIST-SVHN with Laplace posteriors (softmax-std trick), the six
MMVAE objectives and the bf16 mixed-precision policy, at B=8, K=5 and
latent 20 with the registry's full-width nets (the train CLI:
test_torch_mmvae_cli.py).

Noise is drawn with numpy: a uniform u per modality, injected on the JAX
side by replacing the `jax.random.uniform` that the JAX package's
`laplace_sample` calls (its own formula then runs on the injected u), and
handed to the port as `noise=[u_0, u_1]`.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.nets import conv as jconv
from mmvae_tpu.nets import encoders as jenc
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.core import distributions as D
from mmvae_tpu_torch.core import precision
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.models import MMVAE, registry
from mmvae_tpu_torch.nets import Conv2d, ConvTranspose2d, EncoderSVHN, Linear
from mmvae_tpu_torch.objectives import objectives as pobj
from mmvae_tpu_torch.train import Trainer

CONFIG = "configs/mnist_svhn/mmvae_synth.json"
CONFIG_BF16 = "configs/mnist_svhn/mmvae_synth_bf16.json"
B, K, LATENT = 8, 5, 20
OBJECTIVES = ["m_elbo_naive", "m_elbo", "m_iwae", "m_iwae_looser", "m_dreg", "m_dreg_looser"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores (a CLI epoch here took 50 times as long
    beside five other workers as alone)."""
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


def _inputs(seed=0, k=K):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(B, 1, 28, 28)).astype(np.float32),
          rng.uniform(size=(B, 3, 32, 32)).astype(np.float32)]
    us = [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, size=(k, B, LATENT)).astype(np.float32)
          for _ in range(2)]
    return xs, us


def _inject_uniform(monkeypatch, us):
    """Make the JAX package's laplace_sample draw `us` in turn (modality 0
    first): only the module's own `jax.random.uniform` is replaced."""
    calls = []

    def uniform(key, shape, dtype=None, minval=0.0, maxval=1.0):
        assert (minval, maxval) == (D.LAPLACE_U_MIN, D.LAPLACE_U_MAX)
        u = us[len(calls) % len(us)]
        calls.append(tuple(shape))
        assert tuple(shape) == u.shape
        return jnp.asarray(u, dtype=dtype)

    proxy = types.SimpleNamespace(random=types.SimpleNamespace(uniform=uniform), nn=jax.nn)
    monkeypatch.setattr(JD, "jax", proxy)
    return calls


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship at K=5 and its params (float32 numpy)."""
    jcfg = JCfg.from_json(CONFIG)
    jcfg.K = K
    jb = jreg.build(jcfg)
    xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k, x: jb.model.init({"params": k, "sample": k}, x, K=1)["params"])(
        key, xs)
    return jb, jax.tree.map(np.asarray, params)


def _port(params, dtype=torch.float32, **overrides):
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.K = K
    for k, v in overrides.items():
        setattr(cfg, k, v)
    bundle = registry.build(cfg)
    bundle.model.to(dtype)
    load_jax_params(bundle.model, params)
    return cfg, bundle


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


def _assert_grads_close(ours, theirs, tol):
    """Each leaf to `tol` of its largest entry."""
    assert sorted(ours) == sorted(theirs)
    for path, g in theirs.items():
        scale = max(np.abs(g).max(), 1e-30)
        err = np.abs(ours[path] - g).max() / scale
        assert err <= tol, f"{'/'.join(path)}: {err:.3g} of the leaf's largest entry"


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------

def test_distributions_match_jax(monkeypatch):
    """Laplace log-prob, KL and sample (the same u), the softmax-std trick,
    the joint-encoder std, and the Normal KL and entropy, float32 on both
    sides: rtol/atol 1e-6."""
    rng = np.random.default_rng(1)
    loc, lv, x, loc2, lv2 = (rng.standard_normal((3, LATENT)).astype(np.float32)
                             for _ in range(5))
    u = rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, size=(4, 3, LATENT)).astype(np.float32)
    u[0, 0, :3] = [D.LAPLACE_U_MIN, 0.0, np.nextafter(np.float32(1), np.float32(0))]

    def close(ours, theirs):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)

    close(D.std_softmax_trick(torch.tensor(lv)), JD.std_softmax_trick(jnp.asarray(lv)))
    close(D.std_joint_encoder(torch.tensor(lv)), JD.std_joint_encoder(jnp.asarray(lv)))
    p = D.LocScale(torch.tensor(loc), D.std_softmax_trick(torch.tensor(lv)))
    q = D.LocScale(torch.tensor(loc2), D.std_from_logvar(torch.tensor(lv2)))
    jp = JD.LocScale(jnp.asarray(loc), JD.std_softmax_trick(jnp.asarray(lv)))
    jq = JD.LocScale(jnp.asarray(loc2), JD.std_from_logvar(jnp.asarray(lv2)))
    for dist in ("laplace", "normal"):
        close(D.log_prob(dist, p, torch.tensor(x)), JD.log_prob(dist, jp, jnp.asarray(x)))
        close(D.kl(dist, p, q), JD.kl(dist, jp, jq))
    close(D.normal_entropy(q), JD.normal_entropy(jq))

    _inject_uniform(monkeypatch, [u])
    close(D.sample("laplace", p, (4,), noise=torch.tensor(u)),
          JD.sample("laplace", jp, jax.random.PRNGKey(0), (4,)))
    with pytest.raises(ValueError):
        D.sample("laplace", p, (3,), noise=torch.tensor(u))
    # the Bernoulli family (its probabilities in loc): 1 where u < p
    ub = rng.uniform(size=(4, 3, LATENT)).astype(np.float32)
    np.testing.assert_array_equal(D.sample("bernoulli", p, (4,), noise=torch.tensor(ub)).numpy(),
                                  (ub < loc).astype(np.float32))


def test_laplace_generator_draws():
    """Without noise the Laplace sampler draws u in JAX's range from the
    generator: a Laplace(loc, scale) sample (mean loc, mean |z - loc| =
    scale), reproducible from the seed, on the parameters' dtype."""
    p = D.LocScale(torch.full((2,), 3.0), torch.tensor([0.5, 2.0]))
    z = D.laplace_sample(p, (200_000,), generator=torch.Generator().manual_seed(0))
    assert z.shape == (200_000, 2) and z.dtype == torch.float32
    np.testing.assert_allclose(z.mean(0).numpy(), [3.0, 3.0], atol=0.03)
    np.testing.assert_allclose((z - 3.0).abs().mean(0).numpy(), [0.5, 2.0], rtol=0.02)
    again = D.sample("laplace", p, (200_000,), generator=torch.Generator().manual_seed(0))
    assert torch.equal(z, again)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_bridge_maps_jax_mmvae_tree(flagship):
    """A JAX-initialised MMVAE tree loads into the port's MMVAE one to one
    (vaes_0/encoder/Linear_0/..., vaes_1/decoder/ConvTranspose2d_3/...) and
    exports back bit-exactly."""
    _, params = flagship
    _, bundle = _port(params)
    assert isinstance(bundle.model, MMVAE) and bundle.model_name == "mmvae_mnist_svhn"
    back = dict(_flat(export_jax_params(bundle.model)))
    theirs = dict(_flat(params))
    assert sorted(back) == sorted(theirs)
    for path, arr in theirs.items():
        np.testing.assert_array_equal(back[path], arr, err_msg="/".join(path))
    assert ("vaes_0", "encoder", "Linear_0", "kernel") in theirs
    assert ("vaes_1", "encoder", "c2", "kernel") in theirs


def test_registry_and_resolve(flagship):
    jb, params = flagship
    cfg, bundle = _port(params)
    assert bundle.spec == pobj.ModelSpec(**{
        f: getattr(jb.spec, f) for f in ("latent_dim", "posterior", "recon_dists", "lik_scaling")})
    assert bundle.spec.posterior == "laplace" and bundle.model.posterior == "laplace"
    assert all(v.posterior == "laplace" for v in bundle.model.vaes)
    assert pobj.resolve(cfg.obj, True, cfg.looser)[0] == "m_dreg_looser"
    for obj, looser, name in [("elbo_naive", False, "m_elbo_naive"), ("elbo", True, "m_elbo"),
                              ("iwae", False, "m_iwae"), ("iwae", True, "m_iwae_looser"),
                              ("dreg", False, "m_dreg"), ("dreg", True, "m_dreg_looser")]:
        assert pobj.resolve(obj, True, looser) == (name, getattr(pobj, name))
    # the unimodal objectives are ported too; a name JAX has not is refused
    assert pobj.resolve("dreg", False, False) == ("dreg", pobj.dreg)
    with pytest.raises(KeyError):
        pobj.resolve("elbo_nf", False, False)


def test_mmvae_forward_matches_jax(flagship, monkeypatch):
    """encode_and_sample (posterior params and the (M, K, B, D) samples),
    decode_cross, infer_latent_from_mod and decode_all at the same weights
    and u: rtol/atol 1e-5."""
    jb, params = flagship
    _, bundle = _port(params)
    xs, us = _inputs()
    calls = _inject_uniform(monkeypatch, us)

    def japply(method, *args, **kw):
        return jax.jit(lambda *a: jb.model.apply({"params": params}, *a, method=method,
                                                 rngs={"sample": jax.random.PRNGKey(2)},
                                                 **kw))(*args)

    jx = [jnp.asarray(x) for x in xs]
    jout = japply(None, jx, K=K)
    assert calls == [(K, B, LATENT)] * 2
    _inject_uniform(monkeypatch, [us[0][0]])  # one sample at K=1
    jlat = japply(type(jb.model).infer_latent_from_mod, cond_mod=1, x=jx[1])
    jdec = japply(type(jb.model).decode_all, jout["zss"][0])

    model = bundle.model
    with torch.no_grad():
        out = model([torch.tensor(x) for x in xs], K=K, noise=[torch.tensor(u) for u in us])
        lat = model.infer_latent_from_mod(1, torch.tensor(xs[1]), noise=torch.tensor(us[0][0]))
        dec = model.decode_all(out["zss"][0])

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    assert out["zss"].shape == (2, K, B, LATENT)
    close(out["zss"], jout["zss"])
    for (mu, std), (jmu, jstd) in zip(out["qz_params"], jout["qz_params"]):
        close(mu, jmu)
        close(std, jstd)
    for e in range(2):
        for d in range(2):
            assert out["recons"][e][d].shape == (K, B) + xs[d].shape[1:]
            close(out["recons"][e][d], jout["recons"][e][d])
    close(lat, jlat)
    for a, b in zip(dec, jdec):
        close(a, b)


@contextlib.contextmanager
def _jax_dtype(dtype):
    """JAX in float64 (x64 on, the float64 policy) or as it is."""
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


# (value rtol, gradient tolerance as a share of each leaf's largest entry).
# float32: the IWAE and DReG weights are softmaxes over log-weights near
# -6,000, where an ulp is 4.9e-4, so the two packages' summation orders
# move a weight, and the gradients with it, by about 1e-3.
TOLERANCES = {("float64", False): (1e-10, 1e-8), ("float64", True): (1e-10, 1e-8),
              ("float32", False): (1e-5, 1e-4), ("float32", True): (1e-5, 5e-3)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_objective_matches_jax(flagship, monkeypatch, name, dtype):
    """The objective's value and every parameter's gradient, both packages
    in `dtype` at the same weights and u, JAX's own grads for the DReG
    objectives and jax.grad for the others; tolerances in TOLERANCES. In
    float64 the algorithm agrees to round-off; float32 is the dtype that
    trains."""
    jb, params = flagship
    xs, us = _inputs()
    xs, us = [x.astype(dtype) for x in xs], [u.astype(dtype) for u in us]
    _inject_uniform(monkeypatch, us)
    jfn = getattr(jobj, name)
    key = jax.random.PRNGKey(3)
    with _jax_dtype(dtype):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        jx = [jnp.asarray(x) for x in xs]
        if name in jobj.CUSTOM_GRAD_OBJECTIVES:
            out = jax.jit(lambda p: jfn(jb.model, {"params": p}, jx, key, jb.spec, K=K))(jparams)
            j_obj, j_grads = out[0], out[3]
        else:
            j_obj, j_grads = jax.jit(jax.value_and_grad(
                lambda p: jfn(jb.model, {"params": p}, jx, key, jb.spec, K=K)[0]))(jparams)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))

    _, bundle = _port(params, getattr(torch, dtype))
    model = bundle.model
    obj, _ = pobj.OBJECTIVES[name](model, [torch.tensor(x) for x in xs], bundle.spec, K=K,
                                   noise=[torch.tensor(u) for u in us])
    assert obj.dtype == getattr(torch, dtype)
    value_rtol, grad_tol = TOLERANCES[dtype, "iwae" in name or "dreg" in name]
    np.testing.assert_allclose(obj.item(), j_obj, rtol=value_rtol)
    grads = torch.autograd.grad(obj, list(model.parameters()))
    _assert_grads_close(_grads_tree(model, grads), j_grads, grad_tol)


def test_dreg_eval_value_and_train_step(flagship):
    """The DReG eval step (no_grad) returns the surrogate's value, the
    value the train step's objective has, and registers no hook; a train
    step on the same batch and noise reports the same loss."""
    _, params = flagship
    cfg, bundle = _port(params)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu")
    trainer.init_opt_state()
    xs, us = _inputs(seed=2)
    xs, us = [torch.tensor(x) for x in xs], [torch.tensor(u) for u in us]
    eval_loss, _ = trainer.eval_step(xs, noise=us)
    loss, details = trainer.train_step(xs, cfg.learning_rate, noise=us)
    assert trainer.obj_name == "m_dreg_looser"
    torch.testing.assert_close(eval_loss, loss, rtol=1e-6, atol=0)
    assert details["nan_skipped"].item() == 0.0 and trainer.opt.count.item() == 1
    with torch.no_grad():
        _, zss = bundle.model.encode_and_sample(xs, K=K, noise=us)
    assert not zss.requires_grad and not zss._backward_hooks


# ---------------------------------------------------------------------------
# bf16 policy
# ---------------------------------------------------------------------------

def _layer_pair(kind, use_bias):
    if kind == "linear":
        return (jconv.Linear(features=24, use_bias=use_bias), Linear(40, 24, use_bias),
                (16, 40))
    if kind == "conv":
        return (jconv.Conv2d(features=8, kernel_size=4, stride=2, padding=1, use_bias=use_bias),
                Conv2d(3, 8, 4, 2, padding=1, use_bias=use_bias), (4, 3, 16, 16))
    return (jconv.ConvTranspose2d(features=8, kernel_size=4, stride=2, padding=1,
                                  use_bias=use_bias),
            ConvTranspose2d(16, 8, 4, 2, padding=1, use_bias=use_bias), (4, 16, 4, 4))


@pytest.mark.parametrize("kind", ["linear", "conv", "conv_transpose"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_bf16_layers_match_jax(kind, use_bias):
    """Under the bf16 policy, at the same weights, on the CPU: a Linear's
    output is float32 and agrees with JAX's to float32 round-off (rtol
    1e-5: the products of bf16 operands are exact, only the summation
    order differs); a conv's output before its bias is rounded to bf16
    once and agrees with JAX's to one bf16 ulp (2^-8 relative), where the
    two summation orders straddle a rounding boundary. Both differ from
    the float32 layer. Parameters stay float32."""
    jmod, pmod, shape = _layer_pair(kind, use_bias)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    with torch.no_grad():  # one layer: its own tree, no module path to map
        kernel = np.asarray(params["kernel"])
        pmod.weight.copy_(torch.tensor(kernel.T if kind == "linear" else kernel))
        if use_bias:
            pmod.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    with jprec.use("bfloat16"):
        theirs = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    with precision.use("bfloat16"):
        ours = pmod(torch.tensor(x))
    with torch.no_grad():
        f32 = pmod(torch.tensor(x)).numpy()
    assert ours.dtype == torch.float32 and all(p.dtype == torch.float32 for p in pmod.parameters())
    ours = ours.detach().numpy()
    if kind == "linear":
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    else:
        bias = np.asarray(params["bias"])[None, :, None, None] if use_bias else 0.0
        if not use_bias:
            np.testing.assert_array_equal(ours, torch.tensor(ours).bfloat16().float().numpy())
        # one bf16 ulp of the value before the bias
        assert np.all(np.abs(ours - theirs) <= 2 ** -8 * np.abs(theirs - bias) + 1e-6)
    assert np.abs(ours - f32).max() > 1e-4 * np.abs(f32).max()
    np.testing.assert_allclose(ours, f32, rtol=0.02, atol=0.02)


def test_activation_policy_matches_jax():
    """compute and activation dtype bf16: the SVHN encoder's inner convs
    store bf16, the c1/c2 heads stay float32, and the output agrees with
    JAX's under the same policy to four bf16 ulps of its scale (2^-6): each
    of the four convs on the path rounds once, and where the two summation
    orders straddle a rounding boundary the stored values differ by one
    ulp."""
    x = np.random.default_rng(5).uniform(size=(4, 3, 32, 32)).astype(np.float32)
    jmod, pmod = jenc.EncoderSVHN(latent_dim=LATENT), EncoderSVHN(latent_dim=LATENT)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    load_jax_params(pmod, params)
    with jprec.use("bfloat16", "bfloat16"):
        theirs = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    seen = {}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: seen.__setitem__(n, o.dtype))
             for n, m in pmod.named_children()]
    with torch.no_grad(), precision.use("bfloat16", "bfloat16"):
        ours = pmod(torch.tensor(x))
    for h in hooks:
        h.remove()
    assert seen == {"Conv2d_0": torch.bfloat16, "Conv2d_1": torch.bfloat16,
                    "Conv2d_2": torch.bfloat16, "c1": torch.float32, "c2": torch.float32}
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2 ** -6 * np.abs(b).max())


def test_bf16_dreg_looser_matches_jax(flagship, monkeypatch):
    """The DReG-looser objective under the bf16 policy, port against JAX
    at the same weights and u, within the rtol 0.05 that the JAX package's
    own bf16 tests use; the float32 objectives agree to 1e-5. A bf16 train
    step keeps every parameter float32 and finite."""
    jb, params = flagship
    xs, us = _inputs(seed=4)
    _inject_uniform(monkeypatch, us)
    jx = [jnp.asarray(x) for x in xs]
    values = {}
    for policy in (None, "bfloat16"):
        with jprec.use(policy):
            out = jax.jit(lambda p: jobj.m_dreg_looser(jb.model, {"params": p}, jx,
                                                       jax.random.PRNGKey(5), jb.spec, K=K))(params)
        cfg, bundle = _port(params)
        cfg.extra = {**cfg.extra, "compute_dtype": policy}
        trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu")
        trainer.init_opt_state()
        loss, details = trainer.train_step([torch.tensor(x) for x in xs], cfg.learning_rate,
                                           noise=[torch.tensor(u) for u in us])
        values[policy] = (-loss.item(), float(out[0]))
        assert details["nan_skipped"].item() == 0.0
        for p in bundle.model.parameters():
            assert p.dtype == torch.float32 and torch.isfinite(p).all()
    np.testing.assert_allclose(*values[None], rtol=1e-5)
    np.testing.assert_allclose(*values["bfloat16"], rtol=0.05)
    np.testing.assert_allclose(values["bfloat16"][0], values[None][0], rtol=0.05)
    assert values["bfloat16"][0] != values[None][0]


def test_precision_names():
    assert precision.parse(None) is precision.parse("float32") is None
    assert precision.parse("bf16") is precision.parse("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        precision.parse("float16")
    assert precision.compute_dtype() is None and precision.activation_dtype() is None
    with precision.use("bfloat16", "bfloat16"):
        assert precision.compute_dtype() is precision.activation_dtype() is torch.bfloat16
    assert precision.compute_dtype() is None
