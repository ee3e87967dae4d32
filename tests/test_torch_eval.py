"""The port's evaluation against the JAX package: generation, coherence
(per batch and over a dataset with a ragged tail), the conditional FID, every
ported importance-sampled likelihood estimator and the bis protocol for
MMVAE, MMVAE-NF and JMVAE-NF, the chunk-then-combine reduction, the
protocol's batch grouping, and the sample grids with their PNG writer.

The registry's MNIST-SVHN nets at latent 4. Noise is drawn with numpy and
injected on the JAX side by replacing the sampler
(mmvae_tpu.core.distributions.sample) in draw order; the port takes the
same arrays through a `Noise` that hands them out in turn. JAX traces each
estimator once under vmap and lax.map, so the injected noise is the same for
every datapoint: the estimators are held at one IS chunk (K = batch_size_K)
and ns = 1, and the chunked reduction is held to JAX's `_chunked_is` on its
own log-weights. Float64 with JAX's flows on `unrolled_solve` (its Pallas
kernel accumulates in float32 even under x64): values to 1e-10 relative,
labels and coherences exactly; one float32 case through the Pallas kernel
in interpret mode, to 1e-5 relative.
"""

import contextlib
import math
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import vis as jvis
from mmvae_tpu.core import distributions as JD
from mmvae_tpu.core import math as jmath
from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.eval import coherence as JC
from mmvae_tpu.eval import fid as JF
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import likelihoods as JL
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch import vis
from mmvae_tpu_torch.bridge import load_jax_params
from mmvae_tpu_torch.core import math as pmath
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import ArrayLoader, PairedDataset
from mmvae_tpu_torch.eval import coherence as C
from mmvae_tpu_torch.eval import fid as F
from mmvae_tpu_torch.eval import generation as G
from mmvae_tpu_torch.eval import likelihoods as L
from mmvae_tpu_torch.models import registry

LATENT = 4
CONFIGS = {"mmvae": "configs/mnist_svhn/mmvae_synth.json",
           "mmvae_nf": "configs/mnist_svhn/mmvae_nf_synth.json",
           "jnf": "configs/mnist_svhn/jmvae_nf.json"}
SHAPES = [(1, 28, 28), (3, 32, 32)]
RTOL = {"float64": 1e-10, "float32": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    """The JAX eval programs are cached per model: each test traces anew, so
    that its injected noise is the one baked in."""
    monkeypatch.setattr(JG, "_JIT_CACHE", {})
    monkeypatch.setattr(JC, "_ACC_CACHE", {})
    monkeypatch.setattr(JC, "_DS_CACHE", {})


@pytest.fixture(scope="module")
def jax_models():
    """{family: (JAX bundle, float32 numpy params)} at latent 4."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        for fam, path in CONFIGS.items():
            jcfg = JCfg.from_json(path)
            jcfg.latent_dim = LATENT
            jb = jreg.build(jcfg)
            method = "init_all" if fam == "jnf" else None
            xs = [jnp.zeros((2,) + s) for s in SHAPES]
            params = jax.jit(lambda k, x, jb=jb, m=method: jb.model.init(
                {"params": k, "sample": k}, x, K=1, method=m)["params"])(jax.random.PRNGKey(0), xs)
            out[fam] = (jb, jax.tree.map(np.asarray, params))
    return out


def _port(jax_models, fam, dtype):
    cfg = ExperimentConfig.from_json(CONFIGS[fam])
    cfg.latent_dim = LATENT
    bundle = registry.build(cfg)
    bundle.model.to(getattr(torch, dtype)).eval()
    load_jax_params(bundle.model, jax_models[fam][1])
    return bundle


@contextlib.contextmanager
def _jax_dtype(dtype, monkeypatch, pallas=False):
    """JAX in float64 (x64, the float64 policy) on its flows' plain solve, or float32 on the
    Pallas kernel (interpret mode on the CPU) when `pallas`."""
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


def _inject(monkeypatch, noise):
    """JAX's samplers take `noise` in turn: eps for "normal", u for "laplace"."""
    calls = []

    def sample(dist, p, key, sample_shape=()):
        e = jnp.asarray(noise[len(calls)], p.loc.dtype)
        calls.append(dist)
        if dist == "normal":
            return p.loc + e * p.scale
        tiny = jnp.finfo(e.dtype).tiny
        return p.loc - p.scale * jnp.sign(e) * jnp.log1p(-jnp.clip(jnp.abs(e), min=tiny))

    monkeypatch.setattr(JD, "sample", sample)
    return calls


class GivenNoise:
    """The port's side of the injection: the same arrays in turn, each
    broadcast to the shape of the draw."""

    def __init__(self, arrays, dtype):
        self.arrays, self.dtype, self.i = list(arrays), getattr(torch, dtype), 0

    def draw(self, dist, shape):
        a = np.broadcast_to(self.arrays[self.i], tuple(shape))
        self.i += 1
        return torch.tensor(a, dtype=self.dtype)


def _noise(rng, dist, shape):
    if dist == "laplace":
        return rng.uniform(-1 + 1e-7, 1, size=shape)
    return rng.standard_normal(shape)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(n,) + s) for s in SHAPES]


def _jparams(jax_models, fam, dtype):
    return {"params": jax.tree.map(lambda a: jnp.asarray(a, dtype), jax_models[fam][1])}


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL[dtype], atol=0, err_msg=what)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(CONFIGS))
def test_generation_matches_jax(jax_models, monkeypatch, fam):
    """generate, sample_from_conditional (ns = 1, one model call per
    modality), generate_from_conditional, sample_latents_from_mod and
    decode_all, float64."""
    dtype, b = "float64", 3
    jb = jax_models[fam][0]
    post = jb.spec.posterior
    vae_post = "laplace" if fam == "mmvae" else "normal"
    rng = np.random.default_rng(1)
    xs = _data(b)
    e_gen = _noise(rng, post, (b, LATENT))
    e_cond = [_noise(rng, vae_post, (b, LATENT)) for _ in range(2)]
    bundle = _port(jax_models, fam, dtype)
    with _jax_dtype(dtype, monkeypatch):
        v = _jparams(jax_models, fam, dtype)
        _inject(monkeypatch, [e_gen])
        jgen = JG.generate(jb.model, v, jax.random.PRNGKey(0), jb.spec, N=b)
        _inject(monkeypatch, e_cond)
        jcond = JG.sample_from_conditional(jb.model, v, [jnp.asarray(x) for x in xs],
                                           jax.random.PRNGKey(0), n=1)
        _inject(monkeypatch, [e_gen] + e_cond)
        jd, jc = JG.generate_from_conditional(jb.model, v, jax.random.PRNGKey(0), jb.spec, N=b)
        _inject(monkeypatch, e_cond[1:])
        jlat = JG.sample_latents_from_mod(jb.model, v, 1, jnp.asarray(xs[1]), jax.random.PRNGKey(0))
        jdec = JG.decode_all(jb.model, v, jlat)
    with torch.no_grad():
        gen = G.generate(bundle.model, GivenNoise([e_gen], dtype), bundle.spec, N=b)
        cond = G.sample_from_conditional(bundle.model, [torch.tensor(x) for x in xs],
                                         GivenNoise(e_cond, dtype), n=1)
        d, c = G.generate_from_conditional(bundle.model, GivenNoise([e_gen] + e_cond, dtype),
                                           bundle.spec, N=b)
        lat = G.sample_latents_from_mod(bundle.model, 1, torch.tensor(xs[1]),
                                        GivenNoise(e_cond[1:], dtype))
        dec = G.decode_all(bundle.model, lat)
    _close(lat, jlat, dtype, "sample_latents_from_mod")
    for m in range(2):
        _close(dec[m], jdec[m], dtype, f"decode_all {m}")
        _close(gen[m], jgen[m], dtype, f"generate {m}")
        _close(d[m], jd[m], dtype, f"generate_from_conditional {m}")
        for j in range(2):
            assert tuple(cond[m][j].shape) == (1, b) + SHAPES[j]
            _close(cond[m][j], jcond[m][j], dtype, f"cond {m}->{j}")
            _close(c[m][j], jc[m][j], dtype, f"chained {m}->{j}")


# ---------------------------------------------------------------------------
# coherence and FID
# ---------------------------------------------------------------------------

def _classifiers(seed=3):
    """Linear stand-ins for the eval classifiers: 10 logits from the pixels."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((int(np.prod(s)), 10)) for s in SHAPES]
    jax_fns = [lambda x, w=w: x.reshape(x.shape[0], -1) @ jnp.asarray(w, x.dtype) for w in ws]
    port_fns = [lambda x, w=w: x.reshape(x.shape[0], -1) @ torch.tensor(w, dtype=x.dtype)
                for w in ws]
    return jax_fns, port_fns


@pytest.mark.parametrize("fam", ["mmvae", "jnf"])
def test_accuracies_match_jax(jax_models, monkeypatch, fam):
    """compute_accuracies on one batch (n_data 5 of 6) and
    compute_accuracies_dataset over 10 pairs in batches of 4 (a ragged tail
    padded at weight 0; the joint coherence counts the padded rows' prior
    samples, 12, as JAX's does): every count of correct and agreeing labels
    equal to JAX's, float64."""
    dtype = "float64"
    jb = jax_models[fam][0]
    vae_post = "laplace" if fam == "mmvae" else "normal"
    rng = np.random.default_rng(2)
    xs = _data(10, seed=4)
    labels = [rng.integers(0, 10, 10)] * 2
    jclf, pclf = _classifiers()
    bundle = _port(jax_models, fam, dtype)

    n_data, b = 5, 4
    e1 = [_noise(rng, vae_post, (n_data, LATENT)) for _ in range(2)] + \
        [_noise(rng, jb.spec.posterior, (n_data, LATENT))]
    e2 = [_noise(rng, vae_post, (b, LATENT)) for _ in range(2)] + \
        [_noise(rng, jb.spec.posterior, (b, LATENT))]
    ds = PairedDataset([x.astype(np.float64) for x in xs], labels)
    loader = ArrayLoader(ds, b, shuffle=False)
    with _jax_dtype(dtype, monkeypatch):
        v = _jparams(jax_models, fam, dtype)
        _inject(monkeypatch, e1)
        j_batch = JC.compute_accuracies(jb.model, v, jclf, [jnp.asarray(x[:6]) for x in xs],
                                        [l[:6] for l in labels], jax.random.PRNGKey(0), jb.spec,
                                        n_data=n_data, ns=1)
        _inject(monkeypatch, e2)  # traced once: every batch takes the same noise
        j_ds = JC.compute_accuracies_dataset(jb.model, v, jclf, loader, jax.random.PRNGKey(0),
                                             jb.spec, ns=1)
    with torch.no_grad():
        p_batch = C.compute_accuracies(bundle.model, pclf, [torch.tensor(x[:6]) for x in xs],
                                       [l[:6] for l in labels], GivenNoise(e1, dtype),
                                       bundle.spec, n_data=n_data, ns=1)
        p_ds = C.compute_accuracies_dataset(bundle.model, pclf, loader,
                                            lambda bi: GivenNoise(e2, dtype), bundle.spec, ns=1)
    # JAX takes its means of labels in float32 even under x64: the counts
    # of correct and agreeing labels are held equal
    for got, want, n_pairs, n_joint in ((p_batch, j_batch, n_data, n_data), (p_ds, j_ds, 10, 12)):
        assert sorted(got) == sorted(want) == ["acc_0_1", "acc_1_0", "joint_coherence"]
        for k, n in (("acc_0_1", n_pairs), ("acc_1_0", n_pairs), ("joint_coherence", n_joint)):
            assert got[k] * n == pytest.approx(round(want[k] * n), abs=1e-9), k


def test_labels_and_joint_accuracy_match_jax(jax_models, monkeypatch):
    """conditional_labels (ns = 1) and compute_joint_accuracy, JMVAE-NF,
    float64: the same labels."""
    dtype, fam = "float64", "jnf"
    jb = jax_models[fam][0]
    rng = np.random.default_rng(16)
    xs = _data(5, seed=17)
    eps = [rng.standard_normal((4, LATENT)) for _ in range(2)]
    jclf, pclf = _classifiers()
    bundle = _port(jax_models, fam, dtype)
    with _jax_dtype(dtype, monkeypatch):
        _inject(monkeypatch, eps)
        want = JC.conditional_labels(jb.model, _jparams(jax_models, fam, dtype), jclf,
                                     [jnp.asarray(x) for x in xs], jax.random.PRNGKey(0),
                                     n_data=4, ns=1)
        want_joint = JC.compute_joint_accuracy(jclf, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = C.conditional_labels(bundle.model, pclf, [torch.tensor(x) for x in xs],
                                   GivenNoise(eps, dtype), n_data=4, ns=1)
        got_joint = C.compute_joint_accuracy(pclf, [torch.tensor(x) for x in xs])
    for i, j in ((0, 1), (1, 0)):
        assert tuple(got[i][j].shape) == (4, 1)
        np.testing.assert_array_equal(got[i][j].numpy(), np.asarray(want[i][j]))
    assert got_joint == pytest.approx(want_joint, abs=1e-7)  # JAX's mean in float32


def test_staged_dataset_pads_ragged_tail():
    ds = PairedDataset([np.arange(10.0).reshape(10, 1), np.arange(10.0).reshape(10, 1) + 100],
                       [np.arange(10)] * 2)
    stacks, true, w, nb = C._staged_dataset(ds, 4, "cpu", torch.float64)
    assert nb == 3 and tuple(stacks[0].shape) == (3, 4, 1)
    assert stacks[0][2, :, 0].tolist() == [8.0, 9.0, 8.0, 8.0]
    assert true[2].tolist() == [8, 9, 8, 8] and w[2].tolist() == [1, 1, 0, 0]
    assert float(w.sum()) == 10


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((50, 6)), rng.standard_normal((40, 6)) * 1.3 + 0.2
    stats = [F.activation_statistics(x) for x in (a, b)]
    jstats = [JF.activation_statistics(x) for x in (a, b)]
    for s, js in zip(stats, jstats):
        np.testing.assert_array_equal(s[0], js[0])
        np.testing.assert_array_equal(s[1], js[1])
    assert F.calculate_frechet_distance(*stats[0], *stats[1]) == \
        JF.calculate_frechet_distance(*jstats[0], *jstats[1])


def test_cross_modal_fid_matches_jax(jax_models, monkeypatch):
    """JNF's conditional FID over two test batches of 8 through fixed linear
    encoders (3 features per modality), float64: fid_0 and fid_1 to 1e-8
    relative (a matrix square root of the covariances)."""
    dtype, fam = "float64", "jnf"
    jb = jax_models[fam][0]
    rng = np.random.default_rng(6)
    xs = _data(16, seed=7)
    proj = [rng.standard_normal((int(np.prod(s)), 3)) for s in SHAPES]
    eps = [rng.standard_normal((8, LATENT)) for _ in range(2)]
    loader = ArrayLoader(PairedDataset(xs, [np.zeros(16, np.int64)] * 2), 8, shuffle=False)
    bundle = _port(jax_models, fam, dtype)
    jenc = [lambda x, p=p: np.asarray(x, np.float64).reshape(len(x), -1) @ p for p in proj]
    penc = [lambda x, p=p: x.reshape(len(x), -1).double().numpy() @ p for p in proj]
    with _jax_dtype(dtype, monkeypatch):
        _inject(monkeypatch, eps)  # traced once: both batches take the same noise
        want = JF.cross_modal_fid(jb.model, _jparams(jax_models, fam, dtype), loader, jb.spec,
                                  jax.random.PRNGKey(0), jenc)
    with torch.no_grad():
        got = F.cross_modal_fid(bundle.model, loader, lambda bi: GivenNoise(eps, dtype), penc)
    assert sorted(got) == sorted(want) == ["fid_0", "fid_1"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-8)


def test_unported_eval_options_raise():
    """Evaluation refuses nothing now: the InceptionV3 network runs at its
    random init without weights (tests/test_torch_fid.py), and raises only
    for a weights file that is not there. PRD and the fitted samplers are
    ported (tests/test_torch_gen.py), and so are CelebA's attribute
    accuracies (tests/test_torch_celeba.py): all 40 bits of equal
    attributes agree."""
    with pytest.raises(FileNotFoundError):
        F.make_inception_fn("absent_weights.pth", device="cpu")
    attrs = (np.arange(80).reshape(2, 40) % 3 == 0).astype(np.float32)
    assert C.attribute_accuracies(None, torch.tensor(attrs).reshape(2, 1, 1, 40), attrs) == 1.0


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------

K_IS, B_LL = 5, 3


def _bern_u(key, n, bk):
    """The uniform u whose u < 0.5 is each datapoint's first-chunk Bernoulli
    draw of JAX's joint_likelihood_mmvae (its keys: split per datapoint,
    fold_in the chunk, the first of split(k, 3))."""
    keys = jax.random.split(key, n)
    bern = [np.asarray(jax.random.bernoulli(jax.random.split(jax.random.fold_in(k, 0), 3)[0], 0.5,
                                            (bk, 1))) for k in keys]
    return np.where(np.stack(bern), 0.25, 0.75)


def _likelihood_cases(fam):
    """(name, JAX call, port call, the sampler families of the JAX draws)."""
    post = "laplace" if fam == "mmvae" else "normal"
    cases = [
        ("cond_likelihood_1_0",
         lambda jb, v, d, k: {"cond_likelihood_1_0": JL.compute_conditional_likelihood(
             jb.model, v, d, 1, 0, jb.spec, k, K_IS, K_IS)[1]},
         lambda b, d, n: L.compute_conditional_likelihood(b.model, d, 1, 0, b.spec, n, K_IS, K_IS),
         [post]),
        ("uni_from_prior_0",
         lambda jb, v, d, k: JL.compute_uni_ll_from_prior(jb.model, v, d, 0, jb.spec, k, K_IS,
                                                          K_IS),
         lambda b, d, n: L.compute_uni_ll_from_prior(b.model, d, 0, b.spec, n, K_IS, K_IS),
         [post]),
    ]
    if fam != "mmvae_nf":
        cases.append((
            "bis",
            lambda jb, v, d, k: JL.compute_conditional_likelihoods_bis(jb.model, v, d, jb.spec, k,
                                                                       K_IS, K_IS),
            lambda b, d, n: L.compute_conditional_likelihoods_bis(b.model, d, b.spec, n, K_IS,
                                                                  K_IS),
            [post] * 4))
    if fam == "jnf":
        cases.append((
            "likelihood",
            lambda jb, v, d, k: JL.joint_likelihood_jmvae_nf(jb.model, v, d, jb.spec, k, K_IS,
                                                             K_IS),
            lambda b, d, n: L.joint_likelihood_jmvae_nf(b.model, d, b.spec, n, K_IS, K_IS),
            [post]))
    if fam == "mmvae":
        cases.append((
            "likelihood",
            lambda jb, v, d, k: JL.joint_likelihood_mmvae(jb.model, v, d, jb.spec, k, K_IS, K_IS),
            lambda b, d, n: L.joint_likelihood_mmvae(b.model, d, b.spec, n, K_IS, K_IS),
            [post] * 2))
    return cases


LL_CASES = [(fam, name) for fam in CONFIGS for name, *_ in _likelihood_cases(fam)]


@pytest.mark.parametrize("fam,case", LL_CASES)
def test_likelihood_estimators_match_jax(jax_models, monkeypatch, fam, case):
    """Each estimator at one IS chunk of 5 samples for 3 datapoints, float64:
    JAX's per-datapoint values (the conditional likelihood) or batch means
    to 1e-10 relative. The bis case runs both ordered pairs, each the
    family's joint_ll_from_uni (the flow posterior for JMVAE-NF, the encoder
    posterior for MMVAE) less uni_from_prior."""
    dtype = "float64"
    name, jcall, pcall, dists = next(c for c in _likelihood_cases(fam) if c[0] == case)
    jb = jax_models[fam][0]
    rng = np.random.default_rng(8)
    xs = _data(B_LL, seed=9)
    eps = [_noise(rng, d, (K_IS, LATENT)) for d in dists]
    key = jax.random.PRNGKey(11)
    bundle = _port(jax_models, fam, dtype)
    with _jax_dtype(dtype, monkeypatch):
        given = list(eps)
        if fam == "mmvae" and case == "likelihood":  # JAX's Bernoulli draws, in float64 too
            given = [_bern_u(key, B_LL, K_IS)] + eps
        calls = _inject(monkeypatch, eps)
        want = jcall(jb, _jparams(jax_models, fam, dtype), [jnp.asarray(x) for x in xs], key)
    assert len(calls) == len(eps)
    with torch.no_grad():
        got = pcall(bundle, [torch.tensor(x) for x in xs], GivenNoise(given, dtype))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k] if np.ndim(w) else got[k].mean()
        _close(g, w, dtype, k)


def test_cond_likelihood_f32_through_pallas_interpret(jax_models, monkeypatch):
    """JMVAE-NF's conditional likelihood with JAX's flows on the Pallas
    kernel (interpret mode on the CPU), float32: to 1e-5 relative."""
    dtype, fam = "float32", "jnf"
    jb = jax_models[fam][0]
    xs = [x.astype(np.float32) for x in _data(2, seed=12)]
    eps = [np.random.default_rng(13).standard_normal((K_IS, LATENT)).astype(np.float32)]
    bundle = _port(jax_models, fam, dtype)
    with _jax_dtype(dtype, monkeypatch, pallas=True):
        _inject(monkeypatch, eps)
        _, want = JL.compute_conditional_likelihood(jb.model, _jparams(jax_models, fam, dtype),
                                                    [jnp.asarray(x) for x in xs], 0, 1, jb.spec,
                                                    jax.random.PRNGKey(0), K_IS, K_IS)
    with torch.no_grad():
        got = L.compute_conditional_likelihood(bundle.model, [torch.tensor(x) for x in xs], 0, 1,
                                               bundle.spec, GivenNoise(eps, dtype), K_IS, K_IS)
    _close(got["cond_likelihood_0_1"], want, dtype)


@pytest.mark.parametrize("K,bk", [(12, 4), (10, 3)])
def test_chunked_reduction_matches_jax(monkeypatch, K, bk):
    """The chunk-then-combine reduction on JAX's own log-weights (near
    -3000, where the order matters), float64: `_chunked_is` subtracts log K
    even where bk does not divide K, as JAX's does; and
    core.math.chunked_logsumexp_mean against JAX's."""
    key = jax.random.PRNGKey(3)
    with _jax_dtype("float64", monkeypatch):
        def log_w(k):
            return jax.random.normal(k, (bk,), jnp.float64) * 50 - 3000
        want = float(JL._chunked_is(log_w, key, K, bk))
        table = np.stack([np.asarray(log_w(jax.random.fold_in(key, c))) for c in range(K // bk)])
        want_mean = float(jmath.chunked_logsumexp_mean(lambda i: jnp.asarray(table)[i],
                                                       K // bk, bk))
    chunks = iter(table)
    got = L._chunked_is(lambda: (torch.tensor(next(chunks))[None],), lambda sl, w: w, 1, K, bk)
    assert got.item() == pytest.approx(want, rel=1e-14)
    got_mean = pmath.chunked_logsumexp_mean(lambda i: torch.tensor(table[i]), K // bk, bk)
    assert got_mean.item() == pytest.approx(want_mean, rel=1e-14)


def test_protocol_grouping_changes_no_value(jax_models, monkeypatch):
    """JNF's protocol (conditional, joint and bis) over three test batches
    (sizes 4, 4, 2) in one call equals three calls of one batch each, each
    batch's noise from its own generator; K = 6 in chunks of 3, and
    ROWS_PER_CALL cut so that a chunk's rows span several model calls."""
    bundle = _port(jax_models, "jnf", "float64")
    xs = [torch.tensor(x) for x in _data(10, seed=14)]
    batches = [[x[s:e] for x in xs] for s, e in ((0, 4), (4, 8), (8, 10))]

    def gens():
        return [torch.Generator().manual_seed(100 + b) for b in range(3)]

    kw = dict(K=6, batch_size_K=3, joint_fn=L.joint_likelihood_jmvae_nf, bis=True)
    monkeypatch.setattr(L, "ROWS_PER_CALL", 9)  # 3 datapoints per call
    together = L.protocol_chunked(bundle.model, bundle.spec, batches, gens(), **kw)
    alone = [L.protocol_chunked(bundle.model, bundle.spec, [b], [g], **kw)
             for b, g in zip(batches, gens())]
    assert sorted(together) == sorted(["cond_likelihood_0_1", "cond_likelihood_1_0", "likelihood",
                                       "conditional_likelihood_bis_0_1",
                                       "conditional_likelihood_bis_1_0"])
    for k, vs in together.items():
        assert len(vs) == 3 and all(math.isfinite(v) for v in vs)
        np.testing.assert_allclose(vs, [a[k][0] for a in alone], rtol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# sample grids
# ---------------------------------------------------------------------------

def _read_png(path):
    """(width, height, bit depth, color type, rows as uint8) of a PNG whose
    scanlines all use filter 0."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind, data = blob[pos + 4: pos + 8], blob[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n: pos + 12 + n])
        assert crc == zlib.crc32(kind + data) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + data
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = zlib.decompress(chunks[b"IDAT"])
    ch = 1 if color == 0 else 3
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * ch)
    assert (rows[:, 0] == 0).all()
    return w, h, depth, color, rows[:, 1:]


@pytest.mark.parametrize("channels", [1, 3])
def test_grid_and_png_round_trip(tmp_path, channels):
    """make_grid and adjust_shape equal JAX's; save_image writes a PNG whose
    pixels, decoded with zlib, are the clamped grid times 255."""
    rng = np.random.default_rng(15)
    imgs = rng.uniform(-0.2, 1.2, size=(11, channels, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(vis.make_grid(imgs, 4), jvis.make_grid(imgs, 4))
    a, b = rng.uniform(size=(2, 1, 4, 4)), rng.uniform(size=(2, 3, 6, 6))
    for got, want in zip(vis.adjust_shape(a, b), jvis.adjust_shape(a, b)):
        np.testing.assert_array_equal(got, want)
    path = tmp_path / "grid.png"
    vis.save_image(imgs, str(path), nrow=4)
    w, h, depth, color, rows = _read_png(path)
    grid = (vis.make_grid(np.clip(imgs, 0, 1), 4) * 255).astype(np.uint8)
    assert (w, h, depth, color) == (grid.shape[2], grid.shape[1], 8, 0 if channels == 1 else 2)
    np.testing.assert_array_equal(rows.reshape(h, w, channels), np.transpose(grid, (1, 2, 0)))
