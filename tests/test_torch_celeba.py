"""CelebA (image <-> 40 attributes) in the port against the JAX package, on
the CPU: the loader on its three sources (the synthetic stand-in, the
celeba64_<split>.npz archives and the torchvision layout of PNGs and
attribute lists); the ResNet nets at 64x64; the image and attribute
classifiers; the attribute metrics (`celeba_attribute_metrics`,
`attribute_accuracies`) on injected noise; and the fused solve at D = 64,
CelebA's latent width. The five builders are in test_torch_celeba_models.py
and test_torch_celeba_jnf.py, which take their helpers from here.

Weights come from JAX's init through the bridge, at the configs' own
widths (latent 64, ResNets of 64/128 channels at 64x64, MLP 512), batches
of 2. Noise is drawn with numpy and injected on the JAX side as in
test_torch_poe_eval.py. The 64x64 ResNets' gradients are compared in
float32 (XLA compiles their float64 gradients for minutes on the CPU),
their values in float64. Tolerances: float64 values rtol 1e-10; float32
values 1e-5 and gradients 1e-4 of a leaf's largest entry; the data and the
attribute metrics exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.data import loaders as jloaders
from mmvae_tpu.eval import classifiers as JCl
from mmvae_tpu.eval import coherence as JC
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import modalities as JM
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.nets import resnets as jres
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import load_jax_params, load_jax_variables
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import loaders
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.eval.coherence import attribute_accuracies
from mmvae_tpu_torch.eval.modalities import celeba_attribute_metrics
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.nets import resnets
from mmvae_tpu_torch.ops import ar_flow

from test_torch_circles import GivenNoise, _grads_tree, _jax_dtype, _made_weights
from test_torch_poe_eval import _inject

CONFIGS = {name: f"configs/celeba/{name}.json"
           for name in ("mmvae", "jmvae_nf", "mmvae_nf", "mvae", "moepoe")}
SHAPES = [(3, 64, 64), (1, 1, 40)]
B, LATENT = 2, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n=B, seed=0, dtype="float64"):
    """Images in [0, 1] and 0/1 attributes."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(n,) + SHAPES[0]).astype(dtype),
            (rng.uniform(size=(n,) + SHAPES[1]) < 0.3).astype(dtype)]


def _models(name, made_bias_seed=None):
    """(JAX bundle, float32 numpy params, port bundle) of a CelebA config.
    With `made_bias_seed`, the flows' MADE biases are moved off their zero
    init (uniform in +-0.1), as training moves them (at zero biases a hidden
    unit whose masked inputs are all inactive sits exactly at ReLU's kink:
    test_relu_tie_in_the_solve and test_torch_celeba_tie.py hold that case
    against JAX)."""
    jb = jreg.build(JCfg.from_json(CONFIGS[name]))
    xs = [jnp.zeros((2,) + s) for s in SHAPES]
    method = "init_all" if name == "jmvae_nf" else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        # op by op: compiling the init costs more than running it
        params = jb.model.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                               xs, K=1, method=method)["params"]
    params = jax.tree.map(np.asarray, params)
    if made_bias_seed is not None:
        rng = np.random.default_rng(made_bias_seed)
        params = _map_leaves(params, lambda path, a: rng.uniform(-0.1, 0.1, a.shape).astype(
            a.dtype) if len(path) >= 4 and path[-4] == "flow" and path[-1] == "bias" else a)
    bundle = registry.build(ExperimentConfig.from_json(CONFIGS[name]))
    load_jax_params(bundle.model, params)
    assert (bundle.model_name, bundle.dataset) == (jb.model_name, jb.dataset)
    assert bundle.classifier_keys == jb.classifier_keys == ("celeba_img", "celeba_attr")
    assert tuple(map(tuple, bundle.shape_mods)) == tuple(map(tuple, jb.shape_mods))
    assert tuple(bundle.spec.lik_scaling) == tuple(jb.spec.lik_scaling)
    assert tuple(bundle.spec.recon_dists) == ("normal", "bernoulli")
    return jb, params, bundle


def _map_leaves(tree, fn, path=()):
    return {k: _map_leaves(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def _port_grads(model, obj):
    params = list(model.parameters())
    grads = torch.autograd.grad(obj, params, allow_unused=True)
    return _grads_tree(model, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _write_celeba(root, rng, n=12):
    """The torchvision layout: partition and attribute lists, 64x64 PNGs in
    img_align_celeba/celeba_64x64/train (every split is read from there)."""
    from PIL import Image

    d = root / "celeba"
    img_dir = d / "img_align_celeba" / "celeba_64x64" / "train"
    img_dir.mkdir(parents=True)
    names = [f"{i:06d}.jpg" for i in range(n)]
    (d / "list_eval_partition.txt").write_text(
        "".join(f"{nm} {i % 3}\n" for i, nm in enumerate(names)))
    attrs = rng.choice([-1, 1], size=(n, 40))
    (d / "list_attr_celeba.txt").write_text(
        f"{n}\n" + " ".join(f"a{k}" for k in range(40)) + "\n"
        + "".join(nm + " " + " ".join(map(str, a)) + "\n" for nm, a in zip(names, attrs)))
    for nm in names:
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            img_dir / nm.replace(".jpg", ".png"))


@pytest.mark.parametrize("source", ["synthetic", "npz", "torchvision"])
def test_celeba_loader_matches_jax(tmp_path, source):
    """The three splits' images, 1x1x40 attributes and labels (attribute
    20), exactly JAX's: the stand-in's attributes drawn from one
    default_rng(7) over train, test, valid; the npz archives; the PNG
    layout through PIL."""
    rng = np.random.default_rng(5)
    if source == "npz":
        (tmp_path / "celeba").mkdir()
        for split, n in (("train", 10), ("test", 6), ("valid", 4)):
            np.savez(tmp_path / "celeba" / f"celeba64_{split}.npz",
                     images=rng.integers(0, 256, (n, 3, 64, 64), dtype=np.uint8),
                     attrs=(rng.uniform(size=(n, 40)) < 0.5).astype(np.uint8))
    elif source == "torchvision":
        _write_celeba(tmp_path, rng)
    kw = dict(data_path=str(tmp_path), synthetic_n=32, batch_size=4)
    ours, theirs = loaders.get_dataloaders("celeba", **kw), jloaders.get_dataloaders("celeba", **kw)
    for p, j in zip(ours, theirs):
        assert p.num_examples == j.num_examples > 0
        for a, b in zip(p.dataset.modalities + p.dataset.labels,
                        j.dataset.modalities + j.dataset.labels):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        imgs, attrs = p.dataset.modalities
        assert imgs.shape[1:] == SHAPES[0] and attrs.shape[1:] == SHAPES[1]
        np.testing.assert_array_equal(p.dataset.labels[0], attrs[:, 0, 0, 20])
    if source == "synthetic":
        assert [l.num_examples for l in ours] == [32, 8, 8]


# ---------------------------------------------------------------------------
# nets and classifiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_celeba_resnets_match_jax(net, monkeypatch):
    """celeba_encoder (64x64 -> 8x8, 2 ResBlocks) and celeba_decoder (8x8
    -> 16 by output_padding 1 -> 64x64) in float64 at JAX's weights."""
    x = (_data(3)[0] if net == "encoder"
         else np.random.default_rng(2).standard_normal((2, 3, LATENT)))
    jmod = getattr(jres, f"celeba_{net}")(LATENT)
    pmod = getattr(resnets, f"celeba_{net}")(LATENT).double()
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1),
                                                jnp.asarray(x, jnp.float32))["params"])
    load_jax_params(pmod, params)
    with _jax_dtype("float64", monkeypatch):
        want = jmod.apply({"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), params)},
                          jnp.asarray(x))
    got = pmod(torch.tensor(x))
    for a, b in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def _classifier_pair(key, seed):
    """A JAX classifier's variables (running statistics moved off their
    init) and the port's at the same values."""
    x = _data(4, seed=seed, dtype="float32")[0 if key == "celeba_img" else 1]
    arch = JCl.ARCHS[key]()
    v = jax.tree.map(np.asarray, dict(arch.init(jax.random.PRNGKey(seed), jnp.asarray(x))))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(lambda a: a + 0.25, v["batch_stats"])
    model = Cl.ARCHS[key](in_shape=x.shape[1:])
    load_jax_variables(model, v)
    return arch, v, model, x


@pytest.mark.parametrize("key", ["celeba_img", "celeba_attr"])
@pytest.mark.parametrize("train", [False, True])
def test_celeba_classifiers_match_jax(key, train):
    """CelebAImgClassifier (BatchNorm convs, a spatial mean) and
    AttributesClassifier: 40 logits and the penultimate features in eval
    mode, and in training the logits and updated running statistics,
    float32 1e-5."""
    arch, v, model, x = _classifier_pair(key, 3)
    model.train(train)
    with torch.no_grad():
        for features in (False, True):
            if train:
                want, _ = arch.apply(v, jnp.asarray(x), train=True, features=features,
                                     mutable=["batch_stats"])
            else:
                want = arch.apply(v, jnp.asarray(x), features=features)
            got = model(torch.tensor(x), features=features)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert got.shape[1] == (128 if key == "celeba_img" else 512)


# ---------------------------------------------------------------------------
# the attribute metrics
# ---------------------------------------------------------------------------

def test_celeba_attribute_metrics_match_jax(monkeypatch):
    """celeba_attribute_metrics on MVAE (float64) with random image and
    attribute classifiers: accuracy1, accuracy2 and joint_coherence equal to
    JAX's on the same conditional and prior noise (n_data 3 of 4, ns 2), as
    counts of agreeing bits; and attribute_accuracies on the same
    attributes and on noisy ones."""
    monkeypatch.setattr(JG, "_JIT_CACHE", {})
    jb, params, bundle = _models("mvae")
    model = bundle.model.double().eval()
    xs = _data(4, seed=6)
    n_data, ns = 3, 2
    rng = np.random.default_rng(7)
    noise = [rng.standard_normal((n_data, LATENT)) for _ in range(2)] + \
        [rng.standard_normal((ns * n_data, LATENT))]
    jclf, pclf = [], []
    for key, seed in (("celeba_img", 8), ("celeba_attr", 9)):
        arch, v, m, _ = _classifier_pair(key, seed)
        m.double().eval()
        jclf.append(lambda x, arch=arch, v=v: arch.apply(
            jax.tree.map(lambda a: jnp.asarray(a, "float64"), v), x))
        pclf.append(lambda x, m=m: m(x))
    attrs = xs[1].reshape(len(xs[1]), -1)
    with _jax_dtype("float64", monkeypatch):
        calls = _inject(monkeypatch, noise)
        want = JM.celeba_attribute_metrics(
            jb.model, {"params": jax.tree.map(lambda a: jnp.asarray(a, "float64"), params)},
            jclf, [jnp.asarray(x) for x in xs], attrs, jax.random.PRNGKey(0), jb.spec,
            n_data=n_data, ns=ns)
        want_acc = JC.attribute_accuracies(None, jnp.asarray(xs[1]), jnp.asarray(attrs))
    assert len(calls) == 3
    with torch.no_grad():
        got = celeba_attribute_metrics(model, pclf, [torch.tensor(x) for x in xs],
                                       torch.tensor(attrs), GivenNoise(noise, "float64"),
                                       bundle.spec, n_data=n_data, ns=ns)
    assert sorted(got) == sorted(want) == ["accuracy1", "accuracy2", "joint_coherence"]
    # the same counts of agreeing bits (JAX takes their mean in float32)
    n_bits = ns * n_data * 40
    for k in want:
        assert round(got[k] * n_bits) == round(float(want[k]) * n_bits), k
        assert got[k] == pytest.approx(float(want[k]), rel=1e-7), k
    assert 0.0 < got["joint_coherence"] < 1.0
    assert attribute_accuracies(None, torch.tensor(xs[1]), attrs) == want_acc == 1.0
    noisy = np.clip(xs[1] + rng.uniform(-0.8, 0.8, xs[1].shape), 0, 1)
    assert attribute_accuracies(None, torch.tensor(noisy), attrs) == pytest.approx(
        JC.attribute_accuracies(None, jnp.asarray(noisy), jnp.asarray(attrs)), rel=1e-7)


# ---------------------------------------------------------------------------
# the fused solve at D = 64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sign,s_bound", [(1, 0.0), (-1, 8.0)])
def test_solve_at_latent_64_matches_jax(sign, s_bound):
    """At CelebA's latent 64 (MADE widths [64, 128, 128, 128, 128]): the
    port's solve on the CPU against JAX's unrolled_solve and jax.grad, and
    the backward kernel's plain algorithm against the same gradients, for
    x, every weight and every bias (float32: values 1e-5, gradients 1e-4);
    at sign +1 the forward also against JAX's Pallas kernel in interpret
    mode."""
    ws, bs = _made_weights(13, d=LATENT)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((5, LATENT)).astype(np.float32)
    ry = rng.standard_normal((5, LATENT)).astype(np.float32)
    rld = rng.standard_normal(5).astype(np.float32)

    def loss(x_, ws_, bs_):
        y, ld = jax_ar.unrolled_solve(x_, list(ws_), list(bs_), sign, s_bound)
        return jnp.sum(y * ry) + jnp.sum(ld * rld), (y, ld)

    (_, (y_j, ld_j)), g_j = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b_) for b_ in bs])
    want = [g_j[0]] + list(g_j[1]) + list(g_j[2])
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    bt = [torch.tensor(b_, requires_grad=True) for b_ in bs]
    y, ld = ar_flow.ar_solve(xt, wt, bt, sign, s_bound)
    pairs = [(y, y_j), (ld, ld_j)]
    if sign > 0:  # the samplers' direction, once through JAX's Pallas kernel (interpret mode)
        pairs += zip((y, ld), jax_ar.ar_solve(jnp.asarray(x), ws, bs, sign, s_bound))
    for a, b in pairs:
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    g = torch.autograd.grad((y * torch.tensor(ry)).sum() + (ld * torch.tensor(rld)).sum(),
                            [xt] + wt + bt)
    with torch.no_grad():
        w0 = [w.detach() for w in wt]
        y_p, _, tape = ar_flow.plain_tape(torch.tensor(x), w0, [b_.detach() for b_ in bt], sign,
                                          s_bound)
        gx, gws, gbs = ar_flow.plain_backward(torch.tensor(x), y_p, torch.tensor(ry),
                                              torch.tensor(rld), tape, w0, sign, s_bound)
    for got in (g, [gx, *gws, *gbs]):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_relu_tie_in_the_solve(monkeypatch):
    """A hidden unit whose masked inputs are all inactive and whose bias is
    0 sits exactly at ReLU's kink. JAX's unrolled_solve (jnp.maximum)
    passes half the gradient there, and so does the port (`hidden_relu`,
    and the kernels' three ReLU slopes). At D = 64 (two hidden units per
    MADE degree) with zero biases, as initialised, every leaf agrees with
    JAX as it is (float64 1e-12). Here y_0 = x_0 > 0 and the first layer's
    degree-0 units, whose one input is y_0, carry negative weights: every
    degree-0 unit of the later layers then sits at the tie from step 1 on,
    where the head's columns past 0 read it (ties counted as exact zeros of
    the port's plain tape past step 0; at step 0 every unit is tied and no
    head column reads one). With the port's hidden ReLU taken as torch.relu
    (slope 0 at a tie) the hidden biases' gradients miss JAX's, and no
    other leaf does where the masks keep it."""
    ws, bs = _made_weights(15, d=LATENT)
    bs = [np.zeros(b_.shape) for b_ in bs]
    deg0 = np.flatnonzero((ws[0] != 0).sum(axis=0) == 1)
    assert len(deg0) and (ws[0][1:, deg0] == 0).all()
    ws[0][0, deg0] = -np.abs(ws[0][0, deg0])
    rng = np.random.default_rng(16)
    x, ry = np.abs(rng.standard_normal((5, LATENT))), rng.standard_normal((5, LATENT))

    def loss(ws_, bs_):
        y, ld = jax_ar.unrolled_solve(jnp.asarray(x), list(ws_), list(bs_), -1, 0.0)
        return jnp.sum(y * ry) + jnp.sum(ld)

    with _jax_dtype("float64", monkeypatch):
        g = jax.grad(loss, argnums=(0, 1))([jnp.asarray(w, "float64") for w in ws],
                                           [jnp.asarray(b_, "float64") for b_ in bs])
        want = [np.asarray(a) for a in g[0] + g[1]]
    wt = [torch.tensor(w, dtype=torch.float64, requires_grad=True) for w in ws]
    bt = [torch.tensor(b_, requires_grad=True) for b_ in bs]
    _, _, tape = ar_flow.plain_tape(torch.tensor(x), [w.detach() for w in wt],
                                    [b_.detach() for b_ in bt], -1, 0.0)
    tied = [int((z[1:] == 0).sum()) for z in tape.z]
    assert tied[1] > 0, tied

    def port_grads():
        y, ld = ar_flow.ar_solve(torch.tensor(x), wt, bt, -1, 0.0)
        return torch.autograd.grad((y * torch.tensor(ry)).sum() + ld.sum(), wt + bt)

    for a, b in zip(port_grads(), want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(ar_flow, "hidden_relu", torch.relu)
    # the weights' gradients where the MADE masks keep them (the models
    # apply the masks outside the solve, so no other entry reaches them)
    masks = [(w != 0).astype(np.float64) for w in ws] + [1.0] * len(bs)
    names = [f"kernel_{l}" for l in range(len(ws))] + [f"bias_{l}" for l in range(len(bs))]
    differ = {n for n, a, b, m in zip(names, port_grads(), want, masks)
              if not np.allclose(a.numpy() * m, b * m, rtol=1e-4, atol=1e-4)}
    assert differ and differ <= {f"bias_{l}" for l in range(1, len(bs) - 1)}, differ
