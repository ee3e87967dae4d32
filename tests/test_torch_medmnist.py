"""MedMNIST (pneumonia <-> blood) and chest-X-ray <-> SVHN in the port
against the JAX package, on the CPU: the ResNet encoders and decoders at
the same weights in both directions of the bridge; the MedMNIST .npz
reader, the blood-label remap and both loaders, on real-format files and
on the synthetic stand-ins; the builders `mmvae_medmnist` (Laplace
posteriors, m_dreg_looser at K=10) and `mvae_medmnist` (m_self_built): the
objective and every gradient leaf; and the fused solve at D = 16 with
s_bound 8. The JMVAE-NF builders are in test_torch_medmnist_jnf.py, which
takes its helpers from here.

Weights come from JAX's init through the bridge, at the configs' own
widths (latent 16 or 20, ResNets of 64/128 channels) and batches of 3.
Noise is drawn with numpy and injected on the JAX side as in
test_torch_circles.py (normal draws), test_torch_mmvae.py (Laplace's u)
and test_torch_poe.py (MVAE's draws). JAX's flows run their plain solve.
Tolerances: float64 values rtol 1e-10 and gradients 1e-8 of a leaf's
largest entry; float32 1e-5 and 1e-4; the data exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.data import loaders as jloaders
from mmvae_tpu.data import pairing as jpairing
from mmvae_tpu.data import sources as jsources
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.nets import resnets as jres
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.core import distributions as D
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import loaders, pairing, sources
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.nets import init_parameters, resnets
from mmvae_tpu_torch.objectives import objectives as pobj
from mmvae_tpu_torch.ops import ar_flow

from test_torch_circles import (
    _assert_grads_close, _flat, _grads_tree, _jax_dtype, _made_weights,
)
from test_torch_mmvae import _inject_uniform
from test_torch_poe import _inject_normal

CONFIGS = {"jnf": "configs/medmnist/jnf_sbound.json", "mmvae": "configs/medmnist/mmvae.json",
           "mvae": "configs/medmnist/mvae.json",
           "chest": "configs/chest_svhn/jmvae_exact_synth.json"}
SHAPES = {"jnf": [(1, 28, 28), (3, 28, 28)], "mmvae": [(1, 28, 28), (3, 28, 28)],
          "mvae": [(1, 28, 28), (3, 28, 28)], "chest": [(1, 28, 28), (3, 32, 32)]}
B = 3
TOL = {"float64": (1e-10, 1e-8), "float32": (1e-5, 1e-4)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _images(fam, seed=0, dtype="float64"):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(B,) + s).astype(dtype) for s in SHAPES[fam]]


# ---------------------------------------------------------------------------
# the ResNets
# ---------------------------------------------------------------------------

NETS = {"encoder_1": (lambda m: m.medmnist_encoder(16, 1), (B, 1, 28, 28)),
        "encoder_3": (lambda m: m.medmnist_encoder(16, 3), (B, 3, 28, 28)),
        "decoder_1": (lambda m: m.medmnist_decoder(16, 1), (2, B, 16)),
        "decoder_3": (lambda m: m.medmnist_decoder(16, 3), (2, B, 16))}


@pytest.mark.parametrize("net", list(NETS))
def test_resnets_match_jax(net, monkeypatch):
    """The MedMNIST ResNets in float64 at JAX's init weights (JAX -> port),
    then at the port's own draw exported to JAX (port -> JAX): outputs
    within 1e-12 (the decoders keep a leading sample axis); the bridge's
    round trip is exact."""
    build, shape = NETS[net]
    x = np.random.default_rng(1).standard_normal(shape)
    if net.startswith("encoder"):
        x = np.abs(x) % 1.0
    jmod, pmod = build(jres), build(resnets).double()
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x, jnp.float32))["params"])
    with _jax_dtype("float64", monkeypatch):
        for tree in (params, None):
            if tree is None:  # the port's own weights, from its init, to JAX
                init_parameters(pmod, torch.Generator().manual_seed(3))
                tree = export_jax_params(pmod)
            else:
                load_jax_params(pmod, tree)
                for k, a in _flat(export_jax_params(pmod)):
                    np.testing.assert_array_equal(a, dict(_flat(tree))[k])
            want = jmod.apply({"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), tree)},
                              jnp.asarray(x))
            got = pmod(torch.tensor(x))
            for a, b in zip(got if isinstance(got, tuple) else [got],
                            want if isinstance(want, tuple) else [want]):
                assert tuple(a.shape) == b.shape
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-12,
                                           atol=1e-12)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _write_medmnist(root, rng):
    """PneumoniaMNIST (N, 28, 28) and BloodMNIST (N, 28, 28, 3) archives
    in the official layout, with every blood class 0..7."""
    for flag, shape, n_cls in (("pneumoniamnist", (28, 28), 2), ("bloodmnist", (28, 28, 3), 8)):
        arrays = {}
        for split, n in (("train", 40), ("test", 24), ("val", 16)):
            arrays[f"{split}_images"] = rng.integers(0, 256, size=(n,) + shape, dtype=np.uint8)
            arrays[f"{split}_labels"] = rng.integers(0, n_cls, size=(n, 1), dtype=np.uint8)
        np.savez(root / f"{flag}.npz", **arrays)


def test_medmnist_reader_remap_and_real_loaders_match_jax(tmp_path):
    """load_medmnist on both archives, the blood remap (classes 1 and 6 to
    0 and 1, the rest dropped), and the medmnist and chest_svhn loaders on
    the real-format files (SVHN there from the stand-in), exactly."""
    rng = np.random.default_rng(4)
    _write_medmnist(tmp_path, rng)
    for flag in ("pneumoniamnist", "bloodmnist"):
        for split in ("train", "test", "val"):
            for a, b in zip(sources.load_medmnist(str(tmp_path), flag, split),
                            jsources.load_medmnist(str(tmp_path), flag, split)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    labels = rng.integers(0, 8, 200)
    keep, new = pairing.remap_medmnist_blood_labels(labels)
    for a, b in zip((keep, new), jpairing.remap_medmnist_blood_labels(labels)):
        np.testing.assert_array_equal(a, b)
    assert set(labels[keep]) == {1, 6} and set(new) == {0, 1}
    np.testing.assert_array_equal(new, (labels[keep] == 6).astype(new.dtype))
    for name in ("medmnist", "chest_svhn"):
        kw = dict(data_path=str(tmp_path), batch_size=8, synthetic_n=64)
        for p, j in zip(loaders.get_dataloaders(name, **kw), jloaders.get_dataloaders(name, **kw)):
            assert p.num_examples == j.num_examples > 0
            for a, b in zip(p.dataset.modalities + p.dataset.labels,
                            j.dataset.modalities + j.dataset.labels):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["medmnist", "chest_svhn"])
def test_synthetic_loaders_match_jax(name):
    """The synthetic stand-ins, pairing, splits and first batches, exactly;
    chest-SVHN's digits restricted to 0 and 1."""
    kw = dict(data_path="/nonexistent", synthetic_n=96, batch_size=16)
    ours, theirs = loaders.get_dataloaders(name, **kw), jloaders.get_dataloaders(name, **kw)
    for p, j in zip(ours, theirs):
        assert p.num_examples == j.num_examples > 0
        for a, b in zip(p.dataset.modalities + p.dataset.labels,
                        j.dataset.modalities + j.dataset.labels):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        (pb, pl), (jb_, jl) = next(iter(p)), next(iter(j))
        for a, b in zip(pb + pl, jb_ + jl):
            np.testing.assert_array_equal(a, b)
    assert set(np.unique(ours[0].dataset.labels[1])) <= {0, 1}


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _models(fam):
    """(JAX bundle, float32 numpy params, port bundle) of the config."""
    jb = jreg.build(JCfg.from_json(CONFIGS[fam]))
    xs = [jnp.zeros((2,) + s) for s in SHAPES[fam]]
    method = "init_all" if fam in ("jnf", "chest") else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        params = jax.jit(lambda k, x: jb.model.init({"params": k, "sample": k}, x, K=1,
                                                    method=method)["params"])(
            jax.random.PRNGKey(0), xs)
    params = jax.tree.map(np.asarray, params)
    bundle = registry.build(ExperimentConfig.from_json(CONFIGS[fam]))
    load_jax_params(bundle.model, params)
    assert (bundle.model_name, bundle.dataset) == (jb.model_name, jb.dataset)
    assert bundle.classifier_keys == jb.classifier_keys
    assert tuple(map(tuple, bundle.shape_mods)) == tuple(map(tuple, jb.shape_mods))
    assert tuple(bundle.spec.lik_scaling) == tuple(jb.spec.lik_scaling)
    return jb, params, bundle


def _port_grads(model, obj):
    params = list(model.parameters())
    grads = torch.autograd.grad(obj, params, allow_unused=True)
    return _grads_tree(model, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)])


def test_mmvae_medmnist_matches_jax(monkeypatch):
    """mmvae.json (Laplace posteriors, DReG-looser at K=10, scaling (3, 1))
    in float64: the value and every gradient leaf (JAX's DReG gradients)."""
    jb, params, bundle = _models("mmvae")
    assert bundle.spec.lik_scaling == (3.0, 1.0) and bundle.spec.posterior == "laplace"
    k, latent = 10, bundle.spec.latent_dim
    xs = _images("mmvae", seed=7)
    rng = np.random.default_rng(8)
    us = [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, size=(k, B, latent)) for _ in range(2)]
    _inject_uniform(monkeypatch, us)
    with _jax_dtype("float64", monkeypatch):
        v = {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), params)}
        out = jax.jit(lambda v_: jobj.m_dreg_looser(jb.model, v_, [jnp.asarray(x) for x in xs],
                                                    jax.random.PRNGKey(3), jb.spec, K=k))(v)
        j_obj, j_grads = float(out[0]), dict(_flat(out[3]))
    assert pobj.resolve("dreg", True, True)[0] == "m_dreg_looser"
    model = bundle.model.double()
    obj, _ = pobj.m_dreg_looser(model, [torch.tensor(x) for x in xs], bundle.spec, K=k,
                                noise=[torch.tensor(u) for u in us])
    np.testing.assert_allclose(obj.item(), j_obj, rtol=1e-10)
    _assert_grads_close(_port_grads(model, obj), j_grads, 1e-8)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mvae_medmnist_matches_jax(monkeypatch, dtype):
    """mvae.json (scaling (3, 1)): m_self_built's ELBO and every gradient
    leaf, the draws z_0, z_1, z_joint injected."""
    jb, params, bundle = _models("mvae")
    assert bundle.spec.lik_scaling == (3.0, 1.0)
    xs = _images("mvae", seed=9, dtype=dtype)
    rng = np.random.default_rng(10)
    eps = [rng.standard_normal((B, bundle.spec.latent_dim)).astype(dtype) for _ in range(3)]
    calls = _inject_normal(monkeypatch, "mvae", eps)
    with _jax_dtype(dtype, monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

        def objective(p):
            return jobj.m_self_built(jb.model, {"params": p}, [jnp.asarray(x) for x in xs],
                                     jax.random.PRNGKey(3), jb.spec, K=1)[0]

        j_obj, j_grads = jax.jit(jax.value_and_grad(objective))(jparams)
    assert len(calls) == 3
    model = bundle.model.to(getattr(torch, dtype))
    obj, _ = pobj.m_self_built(model, [torch.tensor(x) for x in xs], bundle.spec, K=1,
                               noise=[torch.tensor(e) for e in eps])
    rtol, gtol = TOL[dtype]
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=rtol)
    _assert_grads_close(_port_grads(model, obj), dict(_flat(j_grads)), gtol)


# ---------------------------------------------------------------------------
# the fused solve at D = 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sign", [1, -1])
def test_solve_at_latent_16_matches_jax(sign):
    """At MedMNIST's latent 16 with its s_bound 8: the port's solve (on the
    CPU, autograd through its plain version) against JAX's unrolled_solve
    and jax.grad, and the backward kernel's plain algorithm (`plain_tape`,
    `plain_backward`, `reduce_grads`) against the same gradients: y, the
    log-det and the gradients of a random projection of both for x, every
    weight and every bias (float32: values 1e-5, gradients 1e-4)."""
    ws, bs = _made_weights(11, d=16)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((37, 16)).astype(np.float32)
    ry = rng.standard_normal((37, 16)).astype(np.float32)
    rld = rng.standard_normal(37).astype(np.float32)

    def loss(x_, ws_, bs_):
        y, ld = jax_ar.unrolled_solve(x_, list(ws_), list(bs_), sign, 8.0)
        return jnp.sum(y * ry) + jnp.sum(ld * rld), (y, ld)

    (_, (y_j, ld_j)), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b_) for b_ in bs])
    want = [g_j[0]] + list(g_j[1]) + list(g_j[2])
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    bt = [torch.tensor(b_, requires_grad=True) for b_ in bs]
    y, ld = ar_flow.ar_solve(xt, wt, bt, sign, 8.0)
    for a, b in ((y, y_j), (ld, ld_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    g = torch.autograd.grad((y * torch.tensor(ry)).sum() + (ld * torch.tensor(rld)).sum(),
                            [xt] + wt + bt)
    with torch.no_grad():
        y_p, _, tape = ar_flow.plain_tape(torch.tensor(x), [w.detach() for w in wt],
                                          [b_.detach() for b_ in bt], sign, 8.0)
        gx, deltas = ar_flow.plain_backward(torch.tensor(x), y_p, torch.tensor(ry),
                                            torch.tensor(rld), tape, [w.detach() for w in wt],
                                            sign, 8.0)
        gws, gbs = ar_flow.reduce_grads(tape, deltas)
    for got in (g, [gx, *gws, *gbs]):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
