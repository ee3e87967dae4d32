"""The port's linear probes (mmvae_tpu_torch/eval/linear.py) against
scikit-learn 1.9, imported here on the test side only.

- LinearSVC: the port solves the squared-hinge problem exactly, so it is
  held to scikit-learn's LinearSVC run to convergence (primal, tol 1e-12):
  coef_ and intercept_ within 1e-6 of the largest coefficient, the same
  predictions on held-out rows but for scores within 1e-6 of the margin.
  scikit-learn at its default tol 1e-4 stops short of that minimiser (1e-3
  to 3e-2 of the largest coefficient on these data), so against it the
  coefficients are held at 5e-2 and the test accuracies at 1 row in 100.
- SGDClassifier: the shuffles of a torch.Generator cannot reproduce
  scikit-learn's, so the test accuracy is held within ACC_MARGIN of the
  mean of scikit-learn's over 5 seeds, on separable and on noisy data.
- classify_latent and analyse (eval/latent_analysis.py) against JAX's
  classify_latent on the same latents, within ACC_MARGIN.
"""

import numpy as np
import pytest
import torch
from sklearn.linear_model import SGDClassifier as SkSGD
from sklearn.svm import LinearSVC as SkSVC

from mmvae_tpu_torch.eval.linear import LinearSVC, SGDClassifier

COEF_RTOL = 1e-6
DEFAULT_COEF_RTOL = 5e-2
ACC_MARGIN = 0.03


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(k, noise, n=600, d=16, seed=0, labels=None):
    """Gaussian blobs of k classes: (X train, y train, X test, y test)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 1.5
    y = rng.integers(0, k, n)
    x = centers[y] + noise * rng.normal(size=(n, d))
    if labels is not None:
        y = np.asarray(labels)[y]
    return x[:400], y[:400], x[400:], y[400:]


CASES = {"binary": (2, 1.0), "three": (3, 1.0), "ten": (10, 1.0), "noisy_binary": (2, 4.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_svc_matches_scikit_learn(case):
    k, noise = CASES[case]
    xtr, ytr, xte, yte = _data(k, noise)
    ours = LinearSVC(device="cpu").fit(xtr, ytr)
    tight = SkSVC(tol=1e-12, max_iter=100_000).fit(xtr, ytr)
    default = SkSVC().fit(xtr, ytr)
    np.testing.assert_array_equal(ours.classes_, tight.classes_)
    scale = np.abs(tight.coef_).max()
    assert ours.coef_.shape == tight.coef_.shape == (1 if k == 2 else k, 16)
    np.testing.assert_allclose(ours.coef_, tight.coef_, rtol=0, atol=COEF_RTOL * scale)
    np.testing.assert_allclose(ours.intercept_, tight.intercept_, rtol=0, atol=COEF_RTOL * scale)
    scores = tight.decision_function(xte)
    margin = np.abs(scores) if k == 2 else np.abs(np.diff(np.sort(scores, 1)[:, -2:], axis=1))[:, 0]
    sure = margin > 1e-6
    np.testing.assert_array_equal(ours.predict(xte)[sure], tight.predict(xte)[sure])
    assert ours.n_iter_ < 50
    np.testing.assert_allclose(ours.coef_, default.coef_, rtol=0, atol=DEFAULT_COEF_RTOL * scale)
    assert abs(ours.score(xte, yte) - default.score(xte, yte)) <= 0.01


def test_linear_svc_labels_any_values():
    """Attribute bits as floats, and string classes, as scikit-learn takes
    them; a single class raises."""
    xtr, ytr, xte, _ = _data(2, 1.0, labels=[0.0, 1.0])
    ours, sk = LinearSVC(device="cpu").fit(xtr, ytr), SkSVC(tol=1e-12, max_iter=100_000).fit(xtr, ytr)
    np.testing.assert_array_equal(ours.predict(xte), sk.predict(xte))
    xtr, ytr, xte, _ = _data(3, 1.0, labels=["b", "a", "c"])
    ours, sk = LinearSVC(device="cpu").fit(xtr, ytr), SkSVC(tol=1e-12, max_iter=100_000).fit(xtr, ytr)
    np.testing.assert_array_equal(ours.classes_, sk.classes_)
    np.testing.assert_array_equal(ours.predict(xte), sk.predict(xte))
    with pytest.raises(ValueError, match="one class"):
        LinearSVC(device="cpu").fit(xtr, np.zeros(len(xtr)))


@pytest.mark.parametrize("case", ["binary", "ten", "noisy_binary"])
def test_sgd_accuracy_within_margin_of_scikit_learn(case):
    k, noise = CASES[case]
    xtr, ytr, xte, yte = _data(k, noise, seed=1)
    ours = SGDClassifier(device="cpu", generator=torch.Generator().manual_seed(0)).fit(xtr, ytr)
    theirs = [SkSGD(loss="hinge", penalty="l2", random_state=s).fit(xtr, ytr) for s in range(5)]
    assert ours.coef_.shape == theirs[0].coef_.shape
    assert 1 < ours.n_iter_ < 1000
    acc = ours.score(xte, yte)
    ref = np.mean([t.score(xte, yte) for t in theirs])
    assert abs(acc - ref) <= ACC_MARGIN, (acc, ref)


def test_classify_latent_matches_jax():
    """The probe of eval/latent_analysis.py: the port's accuracy within
    ACC_MARGIN of JAX's (scikit-learn's SGD) on the same latents."""
    from mmvae_tpu.eval.latent_analysis import classify_latent as jax_classify
    from mmvae_tpu_torch.eval.latent_analysis import classify_latent

    xtr, ytr, xte, yte = _data(10, 1.5, seed=2)
    np.random.seed(0)
    want = np.mean([jax_classify(xtr, ytr, xte, yte) for _ in range(3)])
    got = classify_latent(xtr, ytr, xte, yte, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert abs(got - want) <= ACC_MARGIN, (got, want)


def test_analyse_draws_the_joint_embedding(tmp_path):
    """`analyse` on a small flagship MMVAE: joint_embedding_{epoch}.png with
    its .json (two panels), and latent_acc from the probe."""
    import json

    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.eval.generation import Noise
    from mmvae_tpu_torch.eval.latent_analysis import analyse
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.nets import init_parameters

    cfg = ExperimentConfig(model="mnist_svhn", obj="dreg", looser=True, K=2, dist="laplace",
                           recon_losses=("normal", "normal"), latent_dim=4, no_nf=True)
    model = registry.build(cfg).model
    init_parameters(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    data = [torch.tensor(rng.uniform(size=(40,) + s), dtype=torch.float32)
            for s in [(1, 28, 28), (3, 32, 32)]]
    classes = [rng.integers(0, 3, 40)] * 2
    train = (rng.normal(size=(60, 4)), rng.integers(0, 3, 60))
    with torch.no_grad():
        metrics = analyse(model, data, classes, Noise([torch.Generator().manual_seed(1)]),
                          str(tmp_path), 7, train_latents=train)
    assert 0.0 <= metrics["latent_acc"] <= 1.0
    png = tmp_path / "joint_embedding_007.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    spec = json.loads((tmp_path / "joint_embedding_007.png.json").read_text())
    assert len(spec["panels"][0]) == 2


def test_dcca_svm_probe_protocol(capsys):
    """dcca_train's probe (mmvae_tpu/cli/dcca_train.py:101-127): each target
    column fitted on the first half of the rows and scored on the second,
    a column with one value in the first half skipped, JAX's lines printed;
    each accuracy that of scikit-learn's LinearSVC run to convergence on
    the same half."""
    from mmvae_tpu_torch.cli.dcca_train import svm_probe

    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(80, 5)) for _ in range(2)]
    attrs = np.stack([feats[0][:, 0] > 0, np.zeros(80), feats[0][:, 1] > 0.5], 1).astype(np.float32)
    attrs[60, 1] = 1.0  # one value in the first half: skipped
    got = svm_probe(feats, attrs, "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "SVM probe view 0 attribute 0", "SVM probe view 0 attribute 2", "SVM probe view 0",
        "SVM probe view 1 attribute 0", "SVM probe view 1 attribute 2", "SVM probe view 1"]
    for v, h in enumerate(feats):
        want = [SkSVC(tol=1e-12, max_iter=100_000).fit(h[:40], attrs[:40, c]).score(h[40:], attrs[40:, c])
                for c in (0, 2)]
        assert got[v] == pytest.approx(want, abs=1 / 40 + 1e-12)
        assert lines[3 * v + 2] == f"SVM probe view {v}: acc {np.mean(got[v]):.4f}"
