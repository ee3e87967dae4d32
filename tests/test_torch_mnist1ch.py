"""The single-channel MNIST datasets of the port against the JAX package,
on the CPU: the conv MNIST nets (`EncoderMNIST`, `DecoderMNIST`) with their
BatchNorms in both modes and under the bf16 policy; the Canny contour,
`random_grey` and `binarize`; the correspondence pairing, the FashionMNIST
reader and the MNIST-Fashion and MNIST-Contour loaders; and the builders
`jnf_mnist_fashion`, `jnf_mnist_contour` (m_jmvae_nf past warmup with the
unimodal reconstructions, so both `ar_solve` directions run) and
`mnist_fashion` (MMVAE, m_dreg_looser): the objective, every gradient leaf
and the BatchNorm statistics the step leaves.

Weights and BatchNorm statistics come from JAX's init through the bridge.
Noise is drawn with numpy and injected on the JAX side by replacing
`mmvae_tpu.core.distributions.sample`, in JAX's draw order. JAX's flows run
their plain solve. Tolerances: float32 values rtol 1e-5, gradients 1e-4 of
a leaf's largest entry, BatchNorm statistics 1e-5; the DReG objective
in float64 (1e-10, 1e-8); the data, pairing and contours exact. The
biases of the convs right before a BatchNorm have a gradient of 0 but for
round-off, on both sides: they are held within the gradient tolerance of
their kernel's largest gradient entry instead.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.data import loaders as jloaders
from mmvae_tpu.data import pairing as jpairing
from mmvae_tpu.data import sources as jsources
from mmvae_tpu.data import transforms as jtransforms
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.nets import encoders as jenc
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_variables, load_jax_variables
from mmvae_tpu_torch.core import precision
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import loaders, pairing, sources, transforms
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.nets import DecoderMNIST, EncoderMNIST
from mmvae_tpu_torch.objectives import objectives as pobj
from test_torch_circles import _assert_grads_close, _flat, _grads_tree, _inject, _jax_dtype

# the repo has no config of these datasets: this one, with its model swapped
BASE = "configs/mnist_svhn/jmvae_nf.json"
LATENT, B = 4, 4
SHAPE = (1, 28, 28)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# conv biases that a training-mode BatchNorm cancels: their gradient is 0
# but for round-off, held to `tol` of their layer's kernel gradient instead
BN_CANCELLED = {("encoder", "Conv2d_0"), ("encoder", "Conv2d_1"), ("encoder", "Conv2d_2"),
                ("decoder", "ConvTranspose2d_0"), ("decoder", "ConvTranspose2d_1")}


def _assert_grads(ours, theirs, tol):
    """Every leaf to `tol` of its largest entry; a BN-cancelled bias on
    both sides within `tol` of its kernel's largest gradient entry."""
    cancelled = {k for k in theirs if k[-1] == "bias" and tuple(k[-3:-1]) in BN_CANCELLED}
    assert cancelled
    _assert_grads_close({k: v for k, v in ours.items() if k not in cancelled},
                        {k: v for k, v in theirs.items() if k not in cancelled}, tol)
    for k in cancelled:
        bound = tol * np.abs(theirs[k[:-1] + ("kernel",)]).max()
        assert np.abs(ours[k]).max() <= bound and np.abs(theirs[k]).max() <= bound, k


def _images(n, seed=0):
    return [np.random.default_rng(seed + m).uniform(size=(n,) + SHAPE).astype(np.float32)
            for m in range(2)]


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_mnist_nets_match_jax(train):
    """EncoderMNIST (the 5x5 third conv) and DecoderMNIST (output_padding,
    28x28 out, leading sample axes kept) at the same weights and running
    statistics (moved off their init so that eval mode reads them): the
    outputs (float32 rtol/atol 1e-5) and, in training, the updated running
    statistics (rtol 1e-5)."""
    x = _images(5)[0]
    z = np.random.default_rng(1).standard_normal((3, 5, LATENT)).astype(np.float32)
    for jmod, pmod, inp in ((jenc.EncoderMNIST(latent_dim=LATENT), EncoderMNIST(LATENT), x),
                            (jenc.DecoderMNIST(latent_dim=LATENT), DecoderMNIST(LATENT), z)):
        v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(inp)))
        v["batch_stats"] = jax.tree.map(lambda a: a + 0.25, v["batch_stats"])
        load_jax_variables(pmod, v)
        pmod.train(train)
        if train:
            want, state = jmod.apply(v, jnp.asarray(inp), train=True, mutable=["batch_stats"])
        else:
            want, state = jmod.apply(v, jnp.asarray(inp)), v
        got = pmod(torch.tensor(inp))
        for a, b in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        stats = dict(_flat(export_jax_variables(pmod)["batch_stats"]))
        for k, s in _flat(state["batch_stats"]):
            np.testing.assert_allclose(stats[k], s, rtol=1e-5, atol=1e-7, err_msg="/".join(k))


def test_decoder_mnist_under_bf16_matches_jax():
    """DecoderMNIST under the bf16 policy against JAX's at the same
    weights: the sigmoid head stays float32 (head=True), its output within
    3 bf16 ulps (2^-7 absolute on values in [0, 1]: each of the three
    transposed convs rounds once); BatchNorm statistics in float32."""
    z = np.random.default_rng(2).standard_normal((6, LATENT)).astype(np.float32)
    jmod, pmod = jenc.DecoderMNIST(latent_dim=LATENT), DecoderMNIST(LATENT)
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3), jnp.asarray(z)))
    load_jax_variables(pmod, v)
    pmod.eval()
    with jprec.use("bfloat16", "bfloat16"):
        theirs = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(z)))
    with torch.no_grad(), precision.use("bfloat16", "bfloat16"):
        ours = pmod(torch.tensor(z))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=2 ** -7)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_transforms_match_jax():
    """canny_contour on class-structured MNIST stand-ins and on an empty
    image, random_grey from one seed, binarize: exactly JAX's."""
    imgs = sources.load_or_synthesize(
        lambda: sources.load_mnist("/nonexistent", True), SHAPE, 12, 1, proto_seed=1)[0]
    imgs = np.concatenate([imgs, np.zeros((1,) + SHAPE, np.float32)])
    got = transforms.canny_contour(imgs)
    want = jtransforms.canny_contour(imgs)
    assert got.dtype == np.float32 and 0 < got.mean() < 0.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.random_grey(imgs, np.random.default_rng(4)),
                                  jtransforms.random_grey(imgs, np.random.default_rng(4)))
    np.testing.assert_array_equal(transforms.binarize(imgs), jtransforms.binarize(imgs))


def test_correspondence_pairing_and_fashion_reader_match_jax(tmp_path):
    """rand_match_on_correspondence with MNIST_FASHION_CORRESPONDENCE, and
    load_mnist(fashion=True) reading FashionMNIST IDX files."""
    rng = np.random.default_rng(5)
    l1, l2 = rng.integers(0, 10, 300), rng.integers(0, 10, 400)
    assert pairing.MNIST_FASHION_CORRESPONDENCE == jpairing.MNIST_FASHION_CORRESPONDENCE
    for a, b in zip(pairing.rand_match_on_correspondence(
                        l1, l2, pairing.MNIST_FASHION_CORRESPONDENCE, max_d=20, dm=3, seed=2),
                    jpairing.rand_match_on_correspondence(
                        l1, l2, jpairing.MNIST_FASHION_CORRESPONDENCE, max_d=20, dm=3, seed=2)):
        np.testing.assert_array_equal(a, b)
    raw = tmp_path / "FashionMNIST" / "raw"
    raw.mkdir(parents=True)
    imgs = rng.integers(0, 256, size=(7, 28, 28), dtype=np.uint8)
    labs = rng.integers(0, 10, size=7, dtype=np.uint8)
    for name, arr in (("t10k-images-idx3-ubyte", imgs), ("t10k-labels-idx1-ubyte", labs)):
        header = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
            d.to_bytes(4, "big") for d in arr.shape)
        with gzip.open(raw / (name + ".gz"), "wb") as f:
            f.write(header + arr.tobytes())
    got = sources.load_mnist(str(tmp_path), False, fashion=True)
    want = jsources.load_mnist(str(tmp_path), False, fashion=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        sources.load_mnist(str(tmp_path), False)


@pytest.mark.parametrize("name,n", [("mnist_fashion", 128), ("mnist_contour", 64)])
def test_loaders_match_jax(name, n):
    """The synthetic stand-ins, pairing, splits and batch order, exactly."""
    kw = dict(data_path="/nonexistent", synthetic_n=n, batch_size=16)
    ours, theirs = loaders.get_dataloaders(name, **kw), jloaders.get_dataloaders(name, **kw)
    for p, j in zip(ours, theirs):
        assert p.num_examples == j.num_examples > 0
        for a, b in zip(p.dataset.modalities + p.dataset.labels,
                        j.dataset.modalities + j.dataset.labels):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        (pb, pl), (jb_, jl) = next(iter(p)), next(iter(j))
        for a, b in zip(pb + pl, jb_ + jl):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _cfgs(model, **kw):
    jcfg, cfg = JCfg.from_json(BASE), ExperimentConfig.from_json(BASE)
    for c in (jcfg, cfg):
        c.model, c.dcca, c.latent_dim = model, False, LATENT
        for k, v in kw.items():
            setattr(c, k, v)
    return jcfg, cfg


def _models(model, **kw):
    """(JAX bundle, numpy variables with batch statistics, port bundle)."""
    jcfg, cfg = _cfgs(model, **kw)
    jb = jreg.build(jcfg)
    xs = [jnp.zeros((2,) + SHAPE)] * 2
    method = "init_all" if model.startswith("jnf") else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        # op by op: compiling the init costs more than running it
        v = jb.model.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)}, xs,
                          K=1, method=method)
    v = jax.tree.map(np.asarray, dict(v))
    assert "batch_stats" in v
    bundle = registry.build(cfg)
    load_jax_variables(bundle.model, v)
    return jb, v, bundle


@pytest.mark.parametrize("model", ["jnf_mnist_fashion", "jnf_mnist_contour"])
def test_jnf_builders_match_jax(monkeypatch, model):
    """m_jmvae_nf past warmup with the unimodal reconstructions, float32:
    the value, details, every gradient leaf and the BatchNorm statistics the
    training-mode step leaves (JAX keeps compute_kld's pass's alone)."""
    jb, v, bundle = _models(model)
    assert bundle.model_name == jb.model_name and bundle.dataset == jb.dataset
    assert bundle.spec.lik_scaling == jb.spec.lik_scaling == (1.0, 1.0)
    assert bundle.classifier_keys == jb.classifier_keys
    n_hidden = sum(1 for k in v["params"]["joint_encoder"] if k.startswith("Linear_"))
    assert n_hidden == 1
    xs = _images(B, seed=3)
    rng = np.random.default_rng(6)
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(4)]
    _inject(monkeypatch, eps)
    kw = dict(epoch=101, warmup=100, beta_prior=1.0, beta_kl=0.7, past_warmup=True)
    with _jax_dtype("float32", monkeypatch):
        def objective(p):
            obj, det, state = jobj.m_jmvae_nf(
                jb.model, {"params": p, "batch_stats": v["batch_stats"]},
                [jnp.asarray(x) for x in xs], jax.random.PRNGKey(3), jb.spec, train=True, **kw)
            return obj, (det, state)

        (j_obj, (j_det, j_state)), j_grads = jax.jit(
            jax.value_and_grad(objective, has_aux=True))(v["params"])
    model_ = bundle.model.train()
    obj, det = pobj.m_jmvae_nf(model_, [torch.tensor(x) for x in xs], bundle.spec,
                               noise=[torch.tensor(e) for e in eps], **kw)
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=1e-5)
    assert sorted(det) == sorted(j_det)
    for k, val in j_det.items():
        np.testing.assert_allclose(float(det[k]), float(val), rtol=1e-5, atol=1e-5, err_msg=k)
    grads = torch.autograd.grad(obj, list(model_.parameters()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(model_.parameters(), grads)]
    _assert_grads(_grads_tree(model_, grads), dict(_flat(j_grads)), 1e-4)
    # float32 sums over B*H*W activations of order 1: 1e-5 absolute
    stats = dict(_flat(export_jax_variables(model_)["batch_stats"]))
    for k, s in _flat(j_state["batch_stats"]):
        np.testing.assert_allclose(stats[k], s, rtol=1e-5, atol=1e-5, err_msg="/".join(k))


def test_mmvae_fashion_builder_matches_jax(monkeypatch):
    """mnist_fashion (MMVAE, conv MNIST nets, normal posteriors) with
    m_dreg_looser at K=3 in float64: the value, every gradient leaf (JAX's
    DReG gradients; 1e-10, 1e-8) and the BatchNorm statistics."""
    jb, v, bundle = _models("mnist_fashion", obj="dreg", looser=True, K=3)
    assert bundle.spec.lik_scaling == jb.spec.lik_scaling == (1.0, 1.0)
    xs = [x.astype(np.float64) for x in _images(B, seed=7)]
    rng = np.random.default_rng(8)
    eps = [rng.standard_normal((3, B, LATENT)) for _ in range(2)]
    _inject(monkeypatch, eps)
    with _jax_dtype("float64", monkeypatch):
        jv = jax.tree.map(lambda a: jnp.asarray(a, "float64"), v)
        out = jax.jit(lambda v_: jobj.m_dreg_looser(jb.model, v_, [jnp.asarray(x) for x in xs],
                                                    jax.random.PRNGKey(3), jb.spec, K=3))(jv)
        j_obj, j_state, j_grads = float(out[0]), out[2], dict(_flat(out[3]))
    model_ = bundle.model.double().train()
    obj, _ = pobj.OBJECTIVES["m_dreg_looser"](model_, [torch.tensor(x) for x in xs], bundle.spec,
                                             K=3, noise=[torch.tensor(e) for e in eps])
    np.testing.assert_allclose(obj.item(), j_obj, rtol=1e-10)
    grads = torch.autograd.grad(obj, list(model_.parameters()))
    _assert_grads(_grads_tree(model_, grads), j_grads, 1e-8)
    stats = dict(_flat(export_jax_variables(model_)["batch_stats"]))
    for k, s in _flat(j_state["batch_stats"]):
        np.testing.assert_allclose(stats[k], s, rtol=1e-10, err_msg="/".join(k))
