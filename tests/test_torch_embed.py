"""The port's UMAP (mmvae_tpu_torch/embed.py) and its figures
(vis.reduce_latents, visualize_umap, plot_embeddings_colorbars) against the
JAX package's mmvae_tpu/embed.py and vis.py: the kNN and the fuzzy graph
equal to JAX's, the membership curve's fit, the layout equal to JAX's
jitted loop to 1e-5 with JAX's draws (its threefry keys, rebuilt here)
handed to the port; then JAX's own tests/test_embed.py checks on the port
(blobs kept apart, neighbours kept, trustworthiness, the reduce_latents
paths, the PNG), PCA against scikit-learn's (on the test side only), and
the DCCA CLI's embedding figures (test_torch_dcca.py::test_dcca_cli_cpu).
"""

import json

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu import embed as jembed
from mmvae_tpu_torch import embed
from mmvae_tpu_torch.vis import plot_embeddings_colorbars, reduce_latents, visualize_umap


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _blobs(n_per=60, d=10, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.3, (n_per, d)) + np.r_[np.ones(d // 2) * 4, np.zeros(d - d // 2)]
    b = rng.normal(0.0, 0.3, (n_per, d))
    return np.concatenate([a, b]).astype(np.float32), np.r_[
        np.zeros(n_per, np.int32), np.ones(n_per, np.int32)]


def _graph(x, k):
    idx, dists = embed._knn(x, k)
    return (idx, dists) + embed._fuzzy_graph(idx, dists, k)


@pytest.mark.parametrize("n,d,k", [(40, 8, 10), (97, 3, 15), (16, 20, 5)])
def test_knn_and_fuzzy_graph_equal_jax(n, d, k):
    x = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    ours = _graph(x, k)
    idx, dists = jembed._knn(x, k)
    theirs = (idx, dists) + jembed._fuzzy_graph(idx, dists, k)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_dist,spread", [(0.1, 1.0), (0.25, 1.5), (0.01, 0.8)])
def test_fit_ab_matches_jax(min_dist, spread):
    np.testing.assert_allclose(embed._fit_ab(min_dist, spread),
                               jembed._fit_ab(min_dist, spread), rtol=1e-9)


def _jax_draws(seed, n_epochs, n_edges, neg_rate, n):
    """The uniforms and negatives of JAX's layout loop, from its keys."""
    key = jax.random.PRNGKey(seed)
    us, negs = [], []
    for _ in range(n_epochs):
        key, k1, k2 = jax.random.split(key, 3)
        us.append(np.asarray(jax.random.uniform(k1, (n_edges,))))
        negs.append(np.asarray(jax.random.randint(k2, (n_edges, neg_rate), 0, n)))
    return np.stack(us), np.stack(negs)


@pytest.mark.parametrize("n,n_epochs,neg_rate,lr", [(40, 30, 5, 0.1), (24, 12, 3, 0.1),
                                                    (40, 1, 5, 1.0)])
def test_layout_matches_jax_with_its_draws(n, n_epochs, neg_rate, lr):
    """The port's epochs in float32 on the CPU against JAX's jitted loop,
    from the same start and with JAX's draws: within 1e-5 at every point.
    At the default learning rate of 1 an epoch moves points by up to 8 of
    the +-10 box, and the two packages' float32 round-off (XLA's pow, the
    scatter's order) grows from 1.9e-6 after one epoch to 8e-4 after five:
    the many-epoch cases run at 0.1, where 30 epochs stay within 2.4e-6."""
    x, _ = _blobs(n_per=n // 2, d=6, seed=n)
    k = 8
    _, _, heads, tails, weights = _graph(x, k)
    emb0 = embed.pca_init(x, 2, 0)
    a, b = embed._fit_ab(0.1, 1.0)
    kw = dict(a=a, b=b, n_epochs=n_epochs, neg_rate=neg_rate, lr=lr, seed=3)
    want = jembed._optimize_layout(emb0, heads, tails, weights, **kw)
    draws = _jax_draws(3, n_epochs, len(heads), neg_rate, n)
    got = embed._optimize_layout(emb0, heads, tails, weights, device="cpu", draws=draws, **kw)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the layout moved: the draws mattered
    assert np.abs(want - emb0).max() > 0.5


def test_umap_start_is_jax_pca_init():
    x, _ = _blobs(n_per=20, d=6)
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    emb0 = xc @ vt[:2].T
    emb0 = emb0 / np.abs(emb0).max() * 10.0
    emb0 += np.random.default_rng(4).normal(0, 1e-4, emb0.shape)
    np.testing.assert_array_equal(embed.pca_init(x, 2, 4), emb0)


def test_umap_separates_blobs():
    x, y = _blobs()
    emb = embed.UMAP(n_neighbors=10, n_epochs=100, device="cpu").fit_transform(x)
    assert emb.shape == (len(x), 2) and np.isfinite(emb).all()
    ca, cb = emb[y == 0].mean(0), emb[y == 1].mean(0)
    between = np.linalg.norm(ca - cb)
    within = max(np.linalg.norm(emb[y == 0] - ca, axis=1).mean(),
                 np.linalg.norm(emb[y == 1] - cb, axis=1).mean())
    assert between > 2.0 * within, (between, within)


def test_umap_preserves_neighbours():
    """Most 5-NN of each point in the embedding share its blob label."""
    x, y = _blobs(n_per=50)
    emb = embed.UMAP(n_neighbors=10, n_epochs=100, device="cpu").fit_transform(x)
    d2 = ((emb[:, None] - emb[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :5]
    assert (y[nn] == y[:, None]).mean() > 0.9


def test_umap_trustworthiness_vs_exact_knn():
    """scikit-learn's trustworthiness of the embedding of 4 well-separated
    blobs against their exact kNN, as JAX's test takes it: >= 0.9."""
    from sklearn.manifold import trustworthiness

    rng = np.random.default_rng(3)
    d, n_per = 8, 40
    centers = rng.normal(0, 4.0, (4, d))
    x = np.concatenate([rng.normal(0, 0.4, (n_per, d)) + c for c in centers]).astype(np.float32)
    emb = embed.UMAP(n_neighbors=10, n_epochs=150, device="cpu").fit_transform(x)
    assert trustworthiness(x, emb, n_neighbors=10) >= 0.9


def test_reduce_latents_paths():
    """PCA equal to scikit-learn's (its component signs: svd_flip on the
    components), UMAP's shape, and latents of 2 or fewer dimensions
    passed through."""
    from sklearn.decomposition import PCA

    x, _ = _blobs(n_per=20, d=6)
    x64 = x.astype(np.float64) * np.linspace(1, 3, 6)
    np.testing.assert_allclose(reduce_latents(x64, method="pca", device="cpu"),
                               PCA(n_components=2).fit_transform(x64), rtol=1e-9, atol=1e-9)
    assert reduce_latents(x, method="umap", device="cpu").shape == (len(x), 2)
    low = np.zeros((8, 2), np.float32)
    assert reduce_latents(low) is low


def test_visualize_umap_writes_png(tmp_path):
    x, y = _blobs(n_per=30, d=8)
    out = tmp_path / "embedding_0.png"
    emb = visualize_umap(x, y, save_file=str(out), device="cpu")
    assert emb.shape == (len(x), 2)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    spec = json.loads((tmp_path / "embedding_0.png.json").read_text())
    (panel,) = spec["panels"][0]
    assert panel["legend"] == [0, 1]
    for series, label in zip(panel["series"], (0, 1)):
        np.testing.assert_allclose(series["points"], emb[y == label])
    # 2-D points pass through unreduced
    np.testing.assert_array_equal(visualize_umap(emb, None, device="cpu"), emb)


def test_plot_embeddings_colorbars(tmp_path):
    zxy, y = _blobs(n_per=10, d=2)
    spec = plot_embeddings_colorbars(zxy, zxy[:5], y, y[:5], str(tmp_path / "emb.png"))
    assert (tmp_path / "emb.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert [p["legend"] for p in spec["panels"][0]] == [[0, 1], [0]]
