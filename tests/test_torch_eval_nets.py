"""The port's eval networks against the JAX package: BatchNorm2d and the
feature-axis BatchNorm of the SVHN classifier's head in training and eval
mode, with their running statistics after steps (flax updates the running
variance with the BIASED batch variance, torch.nn.BatchNorm* with the
unbiased one); MnistClassifier and SVHNClassifier logits and penultimate
features at the same variables (params and batch_stats, through
bridge.py); and train_classifier's steps, with the same dropout masks on
both sides, against JAX's train_classifier in float64. Float32 otherwise;
the SVHN classifier (69 M parameters) only at batch 3 and never trained
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.eval import classifiers as JCl
from mmvae_tpu.nets import conv as jconv
from mmvae_tpu_torch.bridge import export_jax_variables, load_jax_variables
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.nets import BatchNorm, BatchNorm2d, Dropout

TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("kind", ["2d", "features"])
def test_batchnorm_matches_flax(kind):
    """Three training steps on different batches (outputs and running
    statistics after each), then eval mode on the running statistics."""
    rng = np.random.default_rng(0)
    if kind == "2d":
        jmod, port, shape = jconv.BatchNorm2d(6), BatchNorm2d(6), (5, 6, 3, 4)
    else:
        jmod, port = nn.BatchNorm(use_running_average=None, momentum=0.9), BatchNorm(6)
        shape = (5, 6)
    xs = [rng.normal(1.5, 2.0, size=shape).astype(np.float32) for _ in range(4)]
    train_kw = {"train": True} if kind == "2d" else {"use_running_average": False}
    eval_kw = {"train": False} if kind == "2d" else {"use_running_average": True}
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), **train_kw)
    shifted = jax.tree.map(lambda a: a + rng.normal(0, 0.3, a.shape).astype(np.float32),
                           variables["params"])  # scale and bias away from 1 and 0
    variables = {"params": shifted, "batch_stats": variables["batch_stats"]}
    load_jax_variables(port, variables)
    port.train()
    for x in xs[:3]:
        want, upd = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"], **train_kw)
        variables = {**variables, **upd}
        got = port(torch.tensor(x))
        torch.testing.assert_close(got, torch.tensor(np.asarray(want)), **TOL)
        stats = dict(_flat(export_jax_variables(port)["batch_stats"]))
        for path, v in _flat(jax.tree.map(np.asarray, variables["batch_stats"])):
            np.testing.assert_allclose(stats[path], v, rtol=1e-6, atol=1e-6, err_msg=str(path))
    port.eval()
    want = jmod.apply(variables, jnp.asarray(xs[3]), **eval_kw)
    torch.testing.assert_close(port(torch.tensor(xs[3])), torch.tensor(np.asarray(want)), **TOL)

    # torch's own module takes the unbiased batch variance into the running one
    fresh, ref = type(port)(6), (torch.nn.BatchNorm2d if kind == "2d" else torch.nn.BatchNorm1d)(6)
    fresh.train()(torch.tensor(xs[0]))
    ref.train()(torch.tensor(xs[0]))
    torch.testing.assert_close(fresh.mean, ref.running_mean)
    assert not torch.allclose(fresh.var, ref.running_var, rtol=1e-3, atol=0)


def _jax_classifier(key):
    arch = JCl.ARCHS[key]()
    shape = (1, 28, 28) if key == "mnist" else (3, 32, 32)
    variables = jax.jit(lambda k: arch.init({"params": k, "dropout": k}, jnp.zeros((2,) + shape),
                                            train=True))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    # running statistics away from their initial 0 / 1, so eval mode reads them
    stats = jax.tree.map(lambda a: np.abs(rng.normal(0.5, 0.3, a.shape)).astype(np.float32),
                         variables["batch_stats"])
    return arch, shape, {"params": jax.tree.map(np.asarray, variables["params"]),
                         "batch_stats": stats}


@pytest.mark.parametrize("key", ["mnist", "svhn"])
def test_classifier_matches_jax(key):
    """Eval-mode logits and features=True at the same variables; the port's
    tree of params and batch_stats maps onto JAX's one to one."""
    arch, shape, variables = _jax_classifier(key)
    port = Cl.ARCHS[key](in_shape=shape)
    load_jax_variables(port, variables)
    port.eval()
    back = export_jax_variables(port)
    for coll in ("params", "batch_stats"):
        ours, theirs = dict(_flat(back[coll])), dict(_flat(variables[coll]))
        assert sorted(ours) == sorted(theirs)
        for path, v in theirs.items():
            np.testing.assert_array_equal(ours[path], v)
    x = np.random.default_rng(3).uniform(size=(3,) + shape).astype(np.float32)
    with torch.no_grad():
        for features in (False, True):
            want = arch.apply(variables, jnp.asarray(x), train=False, features=features)
            got = port(torch.tensor(x), features=features)
            assert tuple(got.shape) == (3, 10 if not features else 512)
            torch.testing.assert_close(got, torch.tensor(np.asarray(want)), **TOL)
    fn = Cl.make_apply(port)
    assert fn.model is port and fn(torch.tensor(x)).shape == (3, 10)
    assert Cl.make_feature_fn(port)(torch.tensor(x)).dtype == np.float64


def test_unported_classifiers_raise():
    """Every classifier of the pool builds now, the circles-squares one
    (empty_full) and MedMNIST's and CelebA's among them: pneumonia is the
    MNIST classifier, blood the SVHN one at 3x28x28 (Linear_0 128*19*19
    wide), celeba_img and celeba_attr give 40 logits."""
    assert isinstance(Cl.ARCHS["empty_full"](), Cl.CirclesClassifier)
    assert isinstance(Cl.ARCHS["pneumonia"](), Cl.MnistClassifier)
    blood = Cl.ARCHS["blood"](in_shape=(3, 28, 28))
    assert isinstance(blood, Cl.SVHNClassifier) and blood.Linear_0.weight.shape[1] == 128 * 19 * 19
    for key, shape in (("celeba_img", (3, 64, 64)), ("celeba_attr", (1, 1, 40))):
        model = Cl.ARCHS[key](in_shape=shape).eval()
        with torch.no_grad():
            assert model(torch.zeros((2,) + shape)).shape == (2, 40)


def test_train_classifier_matches_jax(monkeypatch):
    """train_classifier of the MNIST classifier, 2 epochs of 3 steps on 14
    rows at batch 4 (the one-time shuffle, the strided epoch offsets, BN in
    training mode, Adam), from the same variables and with the same dropout
    mask on both sides, float64 (JAX under x64 takes optax's bias
    corrections in float64; in float32 Adam's first steps turn round-off in
    near-zero gradients into steps of up to lr): parameters to 1e-9 of each
    leaf's largest entry and the running statistics to 1e-7 after the 6
    steps (they see the conv biases). The conv biases are held only to
    their Adam bound: BN right after a conv cancels its bias, so its
    gradient is round-off, which Adam scales to steps of +-lr."""
    arch, shape, variables = _jax_classifier("mnist")
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(14,) + shape).astype(np.float32)
    labels = rng.integers(0, 10, 14)
    mask = rng.uniform(size=(4, 512)) < 0.5

    class FixedDropout(nn.Module):
        rate: float
        deterministic: bool = False

        @nn.compact
        def __call__(self, x):
            return x if self.deterministic else jnp.where(mask, x / (1 - self.rate), 0.0)

    class Fixed:
        """JAX's architecture, initialised to the test's variables."""

        def init(self, *args, **kwargs):
            return variables

        def apply(self, *args, **kwargs):
            return arch.apply(*args, **kwargs)

    monkeypatch.setattr(nn, "Dropout", FixedDropout)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jprec.use("float64"):
            variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
            want = JCl.train_classifier(Fixed(), images.astype(np.float64), labels,
                                        jax.random.PRNGKey(5), epochs=2, batch_size=4)
            want = jax.tree.map(np.asarray, want)
    finally:
        jax.config.update("jax_enable_x64", prev)
    monkeypatch.setattr(Dropout, "forward", lambda self, x, generator=None: torch.where(
        torch.tensor(mask), x / (1 - self.rate), torch.zeros_like(x)) if self.training else x)
    port = Cl.MnistClassifier().double()
    load_jax_variables(port, variables)
    monkeypatch.setattr(Cl, "init_parameters", lambda model, gen: None)  # keep the variables
    Cl.train_classifier(port, images.astype(np.float64), labels, seed=5, epochs=2, batch_size=4,
                        device="cpu")
    assert not port.training
    got = export_jax_variables(port)
    for path, w in _flat(jax.tree.map(np.asarray, want["params"])):
        g = dict(_flat(got["params"]))[path]
        if path[0].startswith("Conv2d") and path[1] == "bias":
            init = dict(_flat(variables["params"]))[path]
            assert np.abs(g - init).max() <= 6e-3 + 1e-6 and np.abs(w - init).max() <= 6e-3 + 1e-6
            continue
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * scale, err_msg=str(path))
        assert not np.array_equal(g, dict(_flat(variables["params"]))[path]), path  # it trained
    for path, w in _flat(jax.tree.map(np.asarray, want["batch_stats"])):
        np.testing.assert_allclose(dict(_flat(got["batch_stats"]))[path], w, rtol=1e-7,
                                   atol=1e-9, err_msg=str(path))
