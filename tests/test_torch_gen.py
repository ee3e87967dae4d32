"""The port's PRD, k-means, Gaussian-mixture EM and sampler, quality
harness, sampler-driven generation and coherence, and the Bernoulli family,
against the JAX package (which calls scikit-learn for the clustering and the
mixture) and against scikit-learn itself.

Inputs are made from numpy seeds; float64 throughout, one torch thread.
The port clusters with its own k-means where the JAX package uses
MiniBatchKMeans, so PRD is held to JAX's on well-separated blobs, where both
find the same partition (PRD does not depend on the order of the bins), and
bin for bin from the same labels. The EM is held to scikit-learn's
GaussianMixture from the same injected start; sampling is held to the
mixture's law, since scikit-learn draws through numpy's SVD-based
multivariate_normal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.cluster
import torch
from sklearn.cluster import KMeans, MiniBatchKMeans
from sklearn.mixture import GaussianMixture

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.eval import coherence as JC
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import gmm as JGMM
from mmvae_tpu.eval import prd as JP
from mmvae_tpu.eval import quality as JQ
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.objectives import objectives as JO
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch import bridge
from mmvae_tpu_torch.bridge import load_jax_params
from mmvae_tpu_torch.core import distributions as D
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.eval import cluster as CL
from mmvae_tpu_torch.eval import coherence as C
from mmvae_tpu_torch.eval import generation as G
from mmvae_tpu_torch.eval import gmm as GMM
from mmvae_tpu_torch.eval import prd as P
from mmvae_tpu_torch.eval import quality as Q
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.objectives import objectives as O
from test_torch_eval import GivenNoise, _classifiers, _data, _inject, _jax_dtype

JNF = "configs/mnist_svhn/jmvae_nf.json"
LATENT = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _blobs(n_per, n_blobs, dim, seed, spread=1.0, sep=20.0, weights=None):
    """Well-separated Gaussian blobs; `weights` skews the rows per blob."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(1000).normal(size=(n_blobs, dim)) * sep
    counts = np.full(n_blobs, n_per) if weights is None else \
        np.round(np.asarray(weights) / np.sum(weights) * n_per * n_blobs).astype(int)
    counts[-1] += n_per * n_blobs - counts.sum()
    lab = np.repeat(np.arange(n_blobs), counts)
    return centers[lab] + rng.normal(size=(len(lab), dim)) * spread, lab


def _same_partition(a, b):
    """Equal up to a permutation of the cluster ids."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


# ---------------------------------------------------------------------------
# PRD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_angles,zeros", [(1001, False), (1001, True), (7, False)])
def test_compute_prd_and_f_beta_match_jax(num_angles, zeros):
    """compute_prd, _prd_to_f_beta and prd_to_max_f_beta_pair on the same
    distributions (some bins empty on one side): rtol 1e-12."""
    rng = np.random.default_rng(num_angles + zeros)
    ev, ref = rng.dirichlet(np.ones(20)), rng.dirichlet(np.full(20, 0.5))
    if zeros:
        ev[:4] = 0
        ev /= ev.sum()
        ref[-3:] = 0
        ref /= ref.sum()
    jp, jr = JP.compute_prd(ev, ref, num_angles)
    p, r = P.compute_prd(torch.tensor(ev), torch.tensor(ref), num_angles)
    assert p.dtype == torch.float64 and tuple(p.shape) == (num_angles,)
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-12, atol=0)
    np.testing.assert_allclose(r.numpy(), jr, rtol=1e-12, atol=0)
    for beta in (1, 8, 1 / 8):
        np.testing.assert_allclose(P._prd_to_f_beta(p, r, beta).numpy(),
                                   JP._prd_to_f_beta(jp, jr, beta), rtol=1e-12, atol=0)
    np.testing.assert_allclose(P.prd_to_max_f_beta_pair(p, r), JP.prd_to_max_f_beta_pair(jp, jr),
                               rtol=1e-12, atol=0)


def test_cluster_bins_match_jax_from_the_same_labels(monkeypatch):
    """The per-side histograms from one labelling: JAX's _cluster_into_bins
    with MiniBatchKMeans replaced by a stub that hands out the labels,
    against the port's: equal bit for bit."""
    rng = np.random.default_rng(3)
    n_eval, n_ref, k = 37, 45, 20
    labels = rng.integers(0, k - 2, n_eval + n_ref)  # two bins empty on both sides

    class Stub:
        def __init__(self, n_clusters, n_init):
            assert (n_clusters, n_init) == (k, 10)

        def fit(self, data):
            assert len(data) == n_eval + n_ref
            self.labels_ = labels
            return self

    monkeypatch.setattr(sklearn.cluster, "MiniBatchKMeans", Stub)
    want = JP._cluster_into_bins(np.zeros((n_eval, 3)), np.zeros((n_ref, 3)), k)
    got = P._histogram_bins(torch.tensor(labels), n_eval, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_prd_from_embedding_matches_jax_on_blobs():
    """compute_prd_from_embedding end to end (10 clusterings) on 20 blobs
    whose shares differ between the two sets: the F8 and F1/8 pair of the
    port's k-means against JAX's MiniBatchKMeans, rtol 1e-9."""
    ev, _ = _blobs(40, 20, 8, seed=4, weights=np.linspace(1, 3, 20))
    ref, _ = _blobs(40, 20, 8, seed=5, weights=np.linspace(3, 1, 20))
    np.random.seed(0)  # MiniBatchKMeans draws from numpy's global generator
    jp, jr = JP.compute_prd_from_embedding(ev, ref)
    p, r = P.compute_prd_from_embedding(torch.tensor(ev), torch.tensor(ref),
                                        generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(P.prd_to_max_f_beta_pair(p, r), JP.prd_to_max_f_beta_pair(jp, jr),
                               rtol=1e-9, atol=0)
    with pytest.raises(ValueError, match="not equal"):
        P.compute_prd_from_embedding(ev[:10], ref[:11])


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def test_kmeans_matches_sklearn_on_blobs():
    """10 well-separated blobs in 20 dimensions, 2,000 points: the same
    partition as sklearn.cluster.KMeans up to a permutation, and the inertia
    to rtol 1e-9."""
    x, truth = _blobs(200, 10, 20, seed=6, sep=10.0)
    rng = np.random.default_rng(7)
    perm = rng.permutation(len(x))
    x, truth = x[perm], truth[perm]
    sk = KMeans(10, n_init=10, random_state=0).fit(x)
    km = CL.kmeans(torch.tensor(x), 10, generator=torch.Generator().manual_seed(0))
    assert km.labels.dtype == torch.int64 and tuple(km.centers.shape) == (10, 20)
    assert _same_partition(km.labels.numpy(), sk.labels_)
    assert _same_partition(km.labels.numpy(), truth)
    np.testing.assert_allclose(km.inertia, sk.inertia_, rtol=1e-9)


def test_kmeans_inertia_against_minibatch():
    """Unstructured normal data, 20 clusters: the port's full-batch Lloyd
    reaches no more than 1.02 times MiniBatchKMeans(n_init=10)'s inertia."""
    x = np.random.default_rng(8).normal(size=(2000, 20))
    mb = MiniBatchKMeans(20, n_init=10, random_state=0).fit(x)
    mb_inertia = ((x - mb.cluster_centers_[mb.predict(x)]) ** 2).sum()
    km = CL.kmeans(torch.tensor(x), 20, generator=torch.Generator().manual_seed(0))
    direct = ((x - km.centers.numpy()[km.labels.numpy()]) ** 2).sum()
    np.testing.assert_allclose(km.inertia, direct, rtol=1e-12)
    assert km.inertia <= 1.02 * mb_inertia


def test_kmeans_from_given_centers_is_deterministic():
    """One Lloyd run from injected centers: no generator drawn, the same
    labels and inertia each time, and an empty start cluster refilled."""
    x, _ = _blobs(50, 4, 3, seed=9)
    init = np.concatenate([x[:3], [[1e6, 1e6, 1e6]]])  # the last center attracts no point
    a = CL.kmeans(torch.tensor(x), 4, init=init)
    b = CL.kmeans(x, 4, init=torch.tensor(init))
    assert torch.equal(a.labels, b.labels) and a.inertia == b.inertia
    assert len(torch.unique(a.labels)) == 4


# ---------------------------------------------------------------------------
# Gaussian mixture
# ---------------------------------------------------------------------------

def _mixture_data(seed=10, n_per=300, k=4, d=6):
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(k):
        a = rng.normal(size=(d, d)) * 0.4
        parts.append(rng.multivariate_normal(rng.normal(size=d) * 3, a @ a.T + 0.2 * np.eye(d),
                                             n_per))
    return np.concatenate(parts)


def test_em_matches_sklearn_from_injected_init():
    """From the weights, means and precisions of one k-means labelling,
    given to scikit-learn as weights_init/means_init/precisions_init: the
    converged weights, means, covariances and precision factors to rtol
    1e-8, the same n_iter_, and lower_bound_ to rtol 1e-10."""
    x = _mixture_data()
    k = 4
    labels = CL.kmeans(torch.tensor(x), k, n_init=1,
                       generator=torch.Generator().manual_seed(2)).labels
    start = CL.init_from_labels(torch.tensor(x), labels, k)
    prec = torch.linalg.inv(start.covariances)
    sk = GaussianMixture(k, covariance_type="full", weights_init=start.weights.numpy(),
                         means_init=start.means.numpy(), precisions_init=prec.numpy()).fit(x)
    fit = CL.fit_gaussian_mixture(torch.tensor(x), k, init=(start.weights, start.means, prec))
    assert fit.converged and fit.n_iter == sk.n_iter_ > 1
    np.testing.assert_allclose(fit.lower_bound, sk.lower_bound_, rtol=1e-10)
    for got, want in ((fit.params.weights, sk.weights_), (fit.params.means, sk.means_),
                      (fit.params.covariances, sk.covariances_),
                      (fit.params.precisions_cholesky, sk.precisions_cholesky_)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12 * np.abs(want).max())


def test_em_from_kmeans_start_matches_sklearn_from_the_same_labels():
    """Without an injected start the EM begins at the one-hot
    responsibilities of its own k-means: scikit-learn's init_params="kmeans"
    path, held here through the same labels as weights/means/precisions."""
    x = _mixture_data(seed=11)
    g = torch.Generator().manual_seed(5)
    fit = CL.fit_gaussian_mixture(torch.tensor(x), 4, generator=g)
    labels = CL.kmeans(torch.tensor(x), 4, n_init=1,
                       generator=torch.Generator().manual_seed(5)).labels
    start = CL.init_from_labels(torch.tensor(x), labels, 4)
    again = CL.fit_gaussian_mixture(torch.tensor(x), 4, init=(
        start.weights, start.means, torch.linalg.inv(start.covariances)))
    assert fit.n_iter == again.n_iter
    np.testing.assert_allclose(fit.params.means.numpy(), again.params.means.numpy(), rtol=1e-10)


def test_gmm_log_prob_matches_score_samples():
    """A mixture fitted by scikit-learn on the JAX side, carried across with
    bridge.gmm_from_numpy: log_prob against score_samples, rtol 1e-10."""
    x = _mixture_data(seed=12)
    js = JGMM.GaussianMixtureSampler(n_components=4).fit(x)
    sampler = bridge.gmm_from_numpy(js.gmm.weights_, js.gmm.means_, js.gmm.covariances_)
    z = np.random.default_rng(13).normal(size=(50, 6)) * 3
    np.testing.assert_allclose(sampler.log_prob(torch.tensor(z)).numpy(),
                               js.gmm.score_samples(z), rtol=1e-10)
    np.testing.assert_allclose(sampler.params.precisions_cholesky.numpy(),
                               js.gmm.precisions_cholesky_, rtol=1e-10, atol=1e-13)


def test_gmm_sampling_follows_the_mixture():
    """200,000 draws from a fixed generator: the mixture's mean within 0.02
    and its covariance within 0.05; float32 by default, and the same draws
    from the same seed."""
    x = _mixture_data(seed=14, d=3)
    sampler = GMM.GaussianMixtureSampler(4).fit(torch.tensor(x))
    w, mu, cov = (a.numpy() for a in sampler.params[:3])
    mean = w @ mu
    second = np.einsum("k,kij->ij", w, cov + mu[:, :, None] * mu[:, None, :])
    z = sampler.sample(200_000, torch.Generator().manual_seed(0))
    assert z.dtype == torch.float32 and tuple(z.shape) == (200_000, 3)
    zz = z.double().numpy()
    np.testing.assert_allclose(zz.mean(0), mean, atol=0.02)
    np.testing.assert_allclose(np.cov(zz, rowvar=False), second - np.outer(mean, mean), atol=0.05)
    again = sampler.sample(200_000, torch.Generator().manual_seed(0), dtype=torch.float64)
    assert torch.equal(again.float(), z)


# ---------------------------------------------------------------------------
# Bernoulli
# ---------------------------------------------------------------------------

def test_bernoulli_family_matches_jax():
    """log_prob through the family dispatch, the sample's shape and law, and
    the BCE reconstruction loss, with probabilities at and beyond the
    clip: rtol 1e-12 in float64."""
    probs = np.array([[-0.1, 0.0, 1e-9, 1e-7, 0.3], [0.5, 1 - 1e-7, 1 - 1e-9, 1.0, 1.2]])
    x = np.array([[0.0, 1.0, 0.2, 1.0, 0.7], [1.0, 0.0, 0.5, 0.0, 1.0]])
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jp = JD.LocScale(jnp.asarray(probs), jnp.ones_like(jnp.asarray(probs)))
        want = np.asarray(JD.log_prob("bernoulli", jp, jnp.asarray(x)))
        want_direct = np.asarray(JD.bernoulli_log_prob(jnp.asarray(probs), jnp.asarray(x)))
        want_bce = float(JO.recon_pointwise_loss("bernoulli", jnp.asarray(probs), jnp.asarray(x)))
        jshape = JD.sample("bernoulli", jp, jax.random.PRNGKey(0), (3,)).shape
    finally:
        jax.config.update("jax_enable_x64", prev)
    p = D.LocScale(torch.tensor(probs), torch.ones(2, 5, dtype=torch.float64))
    got = D.log_prob("bernoulli", p, torch.tensor(x))
    assert got.dtype == torch.float64 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(D.bernoulli_log_prob(torch.tensor(probs), torch.tensor(x)).numpy(),
                               want_direct, rtol=1e-12, atol=0)
    np.testing.assert_allclose(float(O.recon_pointwise_loss("bernoulli", torch.tensor(probs),
                                                            torch.tensor(x))),
                               want_bce, rtol=1e-12)
    s = D.sample("bernoulli", p, (3,), generator=torch.Generator().manual_seed(0))
    assert tuple(s.shape) == tuple(jshape) == (3, 2, 5) and s.dtype == torch.float64
    u = np.random.default_rng(15).uniform(size=(3, 2, 5))
    np.testing.assert_array_equal(D.sample("bernoulli", p, (3,), noise=torch.tensor(u)).numpy(),
                                  (u < probs).astype(np.float64))
    law = D.bernoulli_sample(torch.full((200_000,), 0.3), generator=torch.Generator().manual_seed(1))
    assert abs(float(law.mean()) - 0.3) < 0.005


# ---------------------------------------------------------------------------
# the quality harness
# ---------------------------------------------------------------------------

def test_quality_assess_matches_jax(tmp_path):
    """QualityAssess with one linear encoder on 20 blobs (the generated set
    drawn with other shares): FID and the PRD pair against JAX's, rtol 1e-9;
    the cached reference activations reload (the JAX package's cache file
    included) without calling the encoder."""
    w = np.random.default_rng(16).normal(size=(8, 6))
    real, _ = _blobs(30, 20, 8, seed=17)
    fake, _ = _blobs(30, 20, 8, seed=18, weights=np.linspace(1, 2, 20))
    real_b, fake_b = np.split(real, 3), np.split(fake, 4)
    np.random.seed(0)
    jq = JQ.QualityAssess(lambda b: b @ w, cache_path=str(tmp_path / "jax" / "ref.npy"))
    want = jq.fit_reference(real_b).score(fake_b)
    q = Q.QualityAssess(lambda b: torch.as_tensor(b) @ torch.tensor(w),
                        cache_path=str(tmp_path / "port" / "ref.npy"))
    got = q.fit_reference(real_b).score(fake_b, generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want) == ["fid", "prd_f1_8", "prd_f8"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)

    def refuse(b):
        raise AssertionError("the cache was not used")

    for path in (tmp_path / "port" / "ref.npy", tmp_path / "jax" / "ref.npy"):
        cached = Q.QualityAssess(refuse, cache_path=str(path)).fit_reference(real_b)
        np.testing.assert_array_equal(cached.ref_acts, q.ref_acts)


# ---------------------------------------------------------------------------
# sampler-driven generation and coherence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jnf():
    """The JAX JMVAE-NF at latent 4 (float32 numpy params) and the port's
    model with the same weights in float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        jcfg = JCfg.from_json(JNF)
        jcfg.latent_dim = LATENT
        jb = jreg.build(jcfg)
        xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
        params = jax.jit(lambda k, x: jb.model.init({"params": k, "sample": k}, x, K=1,
                                                    method="init_all")["params"])(
            jax.random.PRNGKey(0), xs)
    params = jax.tree.map(np.asarray, params)
    cfg = ExperimentConfig.from_json(JNF)
    cfg.latent_dim = LATENT
    bundle = registry.build(cfg)
    bundle.model.to(torch.float64).eval()
    load_jax_params(bundle.model, params)
    return jb, params, bundle


class _GivenLatents:
    """A fitted sampler's stand-in that hands out the given latents."""

    def __init__(self, z):
        self.z = z

    def sample(self, n, generator=None):
        assert n == len(self.z)
        return torch.tensor(self.z)


class _JaxLatents:
    def __init__(self, z):
        self.z = z

    def sample(self, n, key=None):
        assert n == len(self.z)
        return np.asarray(self.z)


class _Noise(GivenNoise):
    """GivenNoise with the one generator a fitted sampler draws from."""
    generators = [None]


def test_sampler_generation_and_coherence_match_jax(jnf, monkeypatch):
    """generate(sampler=...) and compute_accuracies(sampler=...) with the
    same latents handed to both packages and the same conditional noise:
    the decodes to rtol 1e-10 and equal accuracies (JMVAE-NF, float64)."""
    jb, params, bundle = jnf
    monkeypatch.setattr(JG, "_JIT_CACHE", {})
    rng = np.random.default_rng(19)
    n_data, ns = 4, 1
    z = rng.normal(size=(n_data * ns, LATENT))
    eps = [rng.standard_normal((n_data, LATENT)) for _ in range(2)]
    xs = _data(6, seed=20)
    labels = [rng.integers(0, 10, 6)] * 2
    jclf, pclf = _classifiers()
    with _jax_dtype("float64", monkeypatch):
        v = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)}
        want_gen = JG.generate(jb.model, v, jax.random.PRNGKey(0), jb.spec, N=len(z),
                               sampler=_JaxLatents(z))
        _inject(monkeypatch, eps)
        want_acc = JC.compute_accuracies(jb.model, v, jclf, [jnp.asarray(x) for x in xs],
                                         labels, jax.random.PRNGKey(0), jb.spec, n_data=n_data,
                                         ns=ns, sampler=_JaxLatents(z))
    with torch.no_grad():
        gen = G.generate(bundle.model, _Noise([], "float64"), bundle.spec, N=len(z),
                         sampler=_GivenLatents(z))
        got_acc = C.compute_accuracies(bundle.model, pclf, [torch.tensor(x) for x in xs], labels,
                                       _Noise(eps, "float64"), bundle.spec, n_data=n_data, ns=ns,
                                       sampler=_GivenLatents(z))
    for m in range(2):
        np.testing.assert_allclose(gen[m].numpy(), np.asarray(want_gen[m]), rtol=1e-10, atol=0)
    assert sorted(got_acc) == sorted(want_acc) == ["acc_0_1", "acc_1_0", "joint_coherence"]
    for k in want_acc:  # JAX's means in float32
        assert got_acc[k] == pytest.approx(want_acc[k], abs=1e-7), k


def test_fit_sampler_on_train_latents():
    """Every batch's latents through the rule, the labels beside them, a
    10-component mixture fitted in float64 on them."""
    rng = np.random.default_rng(21)
    batches = [([rng.normal(size=(32, 3))], [rng.integers(0, 10, 32)]) for _ in range(4)]
    sampler, latents, labels = GMM.fit_sampler_on_train_latents(
        batches, lambda xs: torch.tensor(xs[0]) * 2, generator=torch.Generator().manual_seed(0))
    assert tuple(latents.shape) == (128, 3) and labels.shape == (128,)
    np.testing.assert_array_equal(latents.numpy(), np.concatenate([b[0][0] for b in batches]) * 2)
    assert sampler.params.means.shape == (10, 3) and sampler.params.means.dtype == torch.float64
    assert sampler.fit_result.n_iter >= 1
