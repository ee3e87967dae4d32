"""The circles-squares slice of the port against the JAX package, on the
CPU: the dataset, its loader's splits and radius extras and the device
pipeline; the empty/full eval classifier; MMVAE-DReG (normal posteriors,
K=10) and JMVAE-NF at latent 2 (objective and every gradient leaf); and the
fused solve at D = 2, where every MADE degree is 0. Its evaluation (radius
analytics, posterior analyses, HMC) is in test_torch_circles_eval.py, which
takes its helpers from here.

Weights come from JAX's init through the bridge. Noise is drawn with numpy
and injected on the JAX side by replacing `mmvae_tpu.core.distributions
.sample`; HMC is held to JAX with JAX's own draws, rebuilt on the test side
from JAX's key sequence. JAX's flows run their plain solve
(`unrolled_solve`) except in the one Pallas interpret-mode case.
Tolerances: float64 rtol 1e-10 on values and 1e-8 of a leaf's largest
entry on gradients; float32 1e-5 and 1e-4 (two summation orders); the data,
splits, extras, radii and negative entropy on the same images exact.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.data import loaders as jloaders
from mmvae_tpu.data import synthetic as jsyn
from mmvae_tpu.eval import classifiers as JCl
from mmvae_tpu.flows.made import build_masks as jax_build_masks
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params, load_jax_variables
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import loaders, synthetic
from mmvae_tpu_torch.data.device_pipeline import from_array_loader
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.flows.made import build_masks
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.nets.conv import init_parameters
from mmvae_tpu_torch.objectives import objectives as pobj
from mmvae_tpu_torch.ops import ar_flow

CONFIGS = {"mmvae": "configs/circles/mmvae.json", "jnf": "configs/circles/jmvae_nf.json"}
SHAPE = (1, 32, 32)
LATENT = 2  # the configs' own
TOL = {"float64": (1e-10, 1e-8), "float32": (1e-5, 1e-4)}


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


@pytest.fixture(scope="module")
def models():
    """{family: (JAX bundle, float32 numpy params)} of the two circles configs:
    the port's initial weights (seed 0) in JAX's layout (JAX's init runs op
    by op for 15 s and compiles for longer; tests/test_torch_msf.py)."""
    out = {}
    for fam, path in CONFIGS.items():
        bundle = registry.build(ExperimentConfig.from_json(path))
        init_parameters(bundle.model, torch.Generator().manual_seed(0))
        out[fam] = (jreg.build(JCfg.from_json(path)), export_jax_params(bundle.model))
    return out


def _port(models, fam, dtype):
    bundle = registry.build(ExperimentConfig.from_json(CONFIGS[fam]))
    bundle.model.to(getattr(torch, dtype))
    load_jax_params(bundle.model, models[fam][1])
    return bundle


@contextlib.contextmanager
def _jax_dtype(dtype, monkeypatch, pallas=False):
    """JAX in float64 (x64, the float64 policy) or float32, its flows on
    the plain solve unless `pallas` (interpret mode on the CPU)."""
    if not pallas:
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


def _inject(monkeypatch, eps):
    """JAX's normal samples take `eps` in turn (broadcast to the draw)."""
    calls = []

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal"
        e = jnp.asarray(eps[len(calls)], p.loc.dtype)
        calls.append(tuple(sample_shape))
        return p.loc + e * p.scale

    monkeypatch.setattr(JD, "sample", sample)
    return calls


class GivenNoise:
    """The port's side: the same arrays in turn, broadcast to each draw."""

    def __init__(self, arrays, dtype):
        self.arrays, self.dtype, self.i = list(arrays), getattr(torch, dtype), 0

    def draw(self, dist, shape):
        a = np.broadcast_to(self.arrays[self.i], tuple(shape))
        self.i += 1
        return torch.tensor(a, dtype=self.dtype)


def _images(n, seed=0):
    """Circles-squares pairs of the dataset itself."""
    d = synthetic.make_circles_squares(dataset_size=max(n, 8), n_repeat=1, seed=seed)
    return [d["squares_train"][:n].astype(np.float64), d["circles_train"][:n].astype(np.float64)]


def _grads_tree(model, grads):
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(model)))
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


def _assert_grads_close(ours, theirs, tol):
    assert set(ours) == set(theirs)
    for k, g in theirs.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(ours[k], g, rtol=0, atol=tol * scale, err_msg="/".join(k))


# ---------------------------------------------------------------------------
# data and classifier
# ---------------------------------------------------------------------------

def test_dataset_loaders_and_pipeline_match_jax():
    """make_circles_squares array for array; the loader's train, val and
    test splits, labels and radius extras; 0/1 images through the uint8
    device pipeline exactly."""
    ours = synthetic.make_circles_squares(dataset_size=60, n_repeat=4)
    theirs = jsyn.make_circles_squares(dataset_size=60, n_repeat=4)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    p_l = loaders.get_dataloaders("circles_squares", dataset_size=60, n_repeat=4, batch_size=16)
    j_l = jloaders.get_dataloaders("circles_squares", dataset_size=60, n_repeat=4, batch_size=16)
    assert [l.num_examples for l in p_l] == [168, 36, 36]
    for p, j in zip(p_l, j_l):
        for a, b in zip(p.dataset.modalities + p.dataset.labels,
                        j.dataset.modalities + j.dataset.labels):
            np.testing.assert_array_equal(a, b)
        assert sorted(p.dataset.extras) == ["r_circles", "r_squares"]
        for k in j.dataset.extras:
            np.testing.assert_array_equal(p.dataset.extras[k], j.dataset.extras[k])
    pipe = from_array_loader(p_l[0], shuffle=False, device="cpu")
    assert pipe.is_uint8 == [True, True]
    rows = next(pipe.epoch_index_batches())
    for got, want in zip(pipe.gather(torch.from_numpy(rows)), p_l[0].dataset.modalities):
        np.testing.assert_array_equal(got.numpy(), want[rows])


def test_circles_classifier_matches_jax():
    """The empty/full classifier's logits and penultimate features, float32."""
    x = _images(6)[1].astype(np.float32)
    arch = JCl.ARCHS["empty_full"]()
    v = jax.tree.map(np.asarray, arch.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    model = Cl.ARCHS["empty_full"](in_shape=SHAPE)
    load_jax_variables(model, v)
    model.eval()
    with torch.no_grad():
        for features in (False, True):
            got = model(torch.tensor(x), features=features).numpy()
            want = np.asarray(arch.apply(v, jnp.asarray(x), features=features))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the two families' objectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64"])
def test_mmvae_dreg_matches_jax(models, monkeypatch, dtype):
    """m_dreg (the config's `dreg`, not looser) at K=10 with normal
    posteriors: the value and every gradient leaf (JAX's own DReG
    gradients), in float64 (in float32 DReG's softmax weights amplify
    round-off to about 1e-3 of a leaf, test_torch_mmvae.py); TOL."""
    jb, _ = models["mmvae"]
    b, k = 4, 10
    xs = [x.astype(dtype) for x in _images(b)]
    rng = np.random.default_rng(2)
    eps = [rng.standard_normal((k, b, LATENT)).astype(dtype) for _ in range(2)]
    _inject(monkeypatch, eps)
    with _jax_dtype(dtype, monkeypatch):
        v = {"params": jax.tree.map(lambda a: jnp.asarray(a, dtype), models["mmvae"][1])}
        # jitted: op by op the float64 conv gradients take twice as long
        out = jax.jit(lambda v, xs: jobj.m_dreg(jb.model, v, xs, jax.random.PRNGKey(3), jb.spec,
                                                K=k))(v, [jnp.asarray(x) for x in xs])
        j_obj, j_grads = float(out[0]), dict(_flat(out[3]))
    bundle = _port(models, "mmvae", dtype)
    assert pobj.resolve("dreg", True, False)[0] == "m_dreg"
    obj, _ = pobj.OBJECTIVES["m_dreg"](bundle.model, [torch.tensor(x) for x in xs], bundle.spec,
                                      K=k, noise=[torch.tensor(e) for e in eps])
    rtol, gtol = TOL[dtype]
    np.testing.assert_allclose(obj.item(), j_obj, rtol=rtol)
    grads = torch.autograd.grad(obj, list(bundle.model.parameters()))
    _assert_grads_close(_grads_tree(bundle.model, grads), j_grads, gtol)


@pytest.mark.parametrize("dtype,past_warmup", [("float64", True), ("float32", False),
                                               ("float32", True)])
def test_jnf_matches_jax(models, monkeypatch, dtype, past_warmup):
    """m_jmvae_nf of jmvae_nf.json (no_recon) at latent 2 in warmup and
    past it, with the frozen joint path: the value, details and every
    gradient leaf; tolerances in TOL."""
    jb, _ = models["jnf"]
    b = 4
    xs = [x.astype(dtype) for x in _images(b, seed=1)]
    rng = np.random.default_rng(4)
    eps = [rng.standard_normal((b, LATENT)).astype(dtype) for _ in range(2)]
    _inject(monkeypatch, eps)
    kw = dict(epoch=16 if past_warmup else 1, warmup=15, beta_prior=1.0, beta_kl=1.0,
              past_warmup=past_warmup, frozen_joint=past_warmup)
    with _jax_dtype(dtype, monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), models["jnf"][1])

        def objective(p):
            obj, det, _ = jobj.m_jmvae_nf(jb.model, {"params": p}, [jnp.asarray(x) for x in xs],
                                          jax.random.PRNGKey(3), jb.spec, train=True, **kw)
            return obj, det

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
    bundle = _port(models, "jnf", dtype)
    assert bundle.spec.no_recon
    obj, det = pobj.m_jmvae_nf(bundle.model, [torch.tensor(x) for x in xs], bundle.spec,
                               noise=[torch.tensor(e) for e in eps], **kw)
    rtol, gtol = TOL[dtype]
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=rtol)
    assert sorted(det) == sorted(j_det)
    for k_, v_ in j_det.items():
        np.testing.assert_allclose(float(det[k_]), float(v_), rtol=rtol, atol=1e-12, err_msg=k_)
    grads = torch.autograd.grad(obj, list(bundle.model.parameters()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(bundle.model.parameters(), grads)]
    _assert_grads_close(_grads_tree(bundle.model, grads), dict(_flat(j_grads)), gtol)


# ---------------------------------------------------------------------------
# the fused solve at D = 2
# ---------------------------------------------------------------------------

def _made_weights(seed, d=2, h=128, n_hidden=3, scale=0.5):
    rng = np.random.default_rng(seed)
    masks, out_mask = build_masks(d, (h,) * n_hidden)
    masks = masks + [np.concatenate([out_mask, out_mask], axis=1)]
    ws = [(rng.standard_normal(m.shape) * scale / np.sqrt(m.shape[0]) * m).astype(np.float32)
          for m in masks]
    bs = [(rng.standard_normal(m.shape[1]) * 0.1).astype(np.float32) for m in masks]
    return ws, bs


def test_masks_at_latent_2():
    """At D = 2 every hidden degree is 0: every hidden unit sees y_0 only,
    and only head columns 1 and 1 + D carry weights."""
    ours, out = build_masks(2, (128,) * 3)
    theirs, jout = jax_build_masks(2, (128,) * 3)
    for a, b in zip(ours + [out], theirs + [jout]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[0], np.r_[np.ones((1, 128)), np.zeros((1, 128))])
    head = np.concatenate([out, out], axis=1)
    np.testing.assert_array_equal(head.any(axis=0), [False, True, False, True])


@pytest.mark.parametrize("sign,s_bound", [(1, 0.0), (1, 8.0), (-1, 0.0), (-1, 8.0)])
def test_solve_at_latent_2_matches_jax(sign, s_bound):
    """The port's solve (on the CPU, autograd through its plain version)
    against JAX's unrolled_solve and jax.grad: y, the log-det, and the
    gradients of a random projection of both with respect to x, every
    weight and every bias (float32: values 1e-5, gradients 1e-4)."""
    ws, bs = _made_weights(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 2)).astype(np.float32)
    ry = rng.standard_normal((37, 2)).astype(np.float32)
    rld = rng.standard_normal(37).astype(np.float32)

    def loss(x_, ws_, bs_):
        y, ld = jax_ar.unrolled_solve(x_, list(ws_), list(bs_), sign, s_bound)
        return jnp.sum(y * ry) + jnp.sum(ld * rld), (y, ld)

    (_, (y_j, ld_j)), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b_) for b_ in bs])
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    bt = [torch.tensor(b_, requires_grad=True) for b_ in bs]
    y, ld = ar_flow.ar_solve(xt, wt, bt, sign, s_bound)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_j), rtol=1e-5, atol=1e-5)
    g = torch.autograd.grad((y * torch.tensor(ry)).sum() + (ld * torch.tensor(rld)).sum(),
                            [xt] + wt + bt)
    want = [g_j[0]] + list(g_j[1]) + list(g_j[2])
    for got, w in zip(g, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_solve_at_latent_2_matches_jax_pallas_interpret():
    """The forward at D = 2 against JAX's Pallas kernel in interpret mode,
    sign +1 (the samplers' direction), float32 1e-5."""
    ws, bs = _made_weights(2)
    x = np.random.default_rng(3).standard_normal((2, 5, 2)).astype(np.float32)
    y_j, ld_j = jax_ar.ar_solve(jnp.asarray(x), ws, bs, 1, 8.0)
    with torch.no_grad():
        y, ld = ar_flow.ar_solve(torch.tensor(x), [torch.tensor(w) for w in ws],
                                 [torch.tensor(b_) for b_ in bs], 1, 8.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-5, atol=1e-5)
