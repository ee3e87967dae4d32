"""The port's DCCA pretraining against the JAX package: the eigh and
Cholesky CCA losses and their gradients (float64), the singular-value
Function against JAX's custom VJP, LinearCCA, the RMSprop update against
optax, one Solver epoch against JAX's Solver from the same weights, the
artifact round trip into the JNF-DCCA model, the refusal of a JAX artifact
and its conversion, and the DCCA CLI on the CPU.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.data import get_dataloaders as jax_dataloaders
from mmvae_tpu.dcca import objectives as JO
from mmvae_tpu.dcca.linear_cca import LinearCCA as JLinearCCA
from mmvae_tpu.dcca.nets import dcca_encoders_mnist_svhn as j_trunks
from mmvae_tpu.dcca.train import Solver as JSolver
from mmvae_tpu_torch.bridge import export_jax_params
from mmvae_tpu_torch.cli import dcca_train
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import get_dataloaders
from mmvae_tpu_torch.dcca import objectives as O
from mmvae_tpu_torch.dcca.linear_cca import LinearCCA
from mmvae_tpu_torch.dcca.nets import DCCA_BUILDERS, dcca_encoders_mnist_svhn
from mmvae_tpu_torch.dcca.train import Solver, load_trunk_params
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.train.optim import RMSprop

OUTDIM, BATCH, SYNTH_N = 8, 48, 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jprec.use("float64"):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _correlated_views(n=100, d=5, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 3))
    h1 = z @ rng.normal(size=(3, d)) + 0.3 * rng.normal(size=(n, d))
    h2 = z @ rng.normal(size=(3, d)) + 0.3 * rng.normal(size=(n, d))
    return h1, h2


@pytest.mark.parametrize("use_all", [False, True])
@pytest.mark.parametrize("form", ["eigh", "chol"])
def test_cca_corr_matches_jax(form, use_all):
    """Value and the gradient for both views, float64 on both sides: value
    to rtol 1e-10, gradients to 1e-8 of their largest entry."""
    h1, h2 = _correlated_views()
    jfn = JO.cca_corr if form == "eigh" else JO.cca_corr_chol
    fn = O.cca_corr if form == "eigh" else O.cca_corr_chol
    with _x64():
        j_val, j_grads = jax.value_and_grad(lambda a, b: jfn(a, b, 3, use_all), argnums=(0, 1))(
            jnp.asarray(h1), jnp.asarray(h2))
        j_val, j_grads = float(j_val), [np.asarray(g) for g in j_grads]
    t1, t2 = (torch.tensor(h, requires_grad=True) for h in (h1, h2))
    val = fn(t1, t2, 3, use_all)
    grads = torch.autograd.grad(val, (t1, t2))
    np.testing.assert_allclose(val.item(), j_val, rtol=1e-10)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())


def test_sum_topk_sv_matches_jax_custom_vjp():
    """The Function's value and backward equal JAX's `_sum_topk_sv` and its
    custom VJP (float64), and the backward is the true derivative where the
    singular values are distinct (gradcheck)."""
    rng = np.random.default_rng(3)
    T = rng.normal(size=(6, 6))
    k, r = 3, 1e-3
    with _x64():
        j_val, j_grad = jax.value_and_grad(lambda t: JO._sum_topk_sv(t, k, r))(jnp.asarray(T))
    t = torch.tensor(T, requires_grad=True)
    val = O.sum_topk_sv(t, k, r)
    (grad,) = torch.autograd.grad(val * 1.7, t)
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), 1.7 * np.asarray(j_grad), rtol=1e-10, atol=1e-12)
    assert torch.autograd.gradcheck(lambda x: O.sum_topk_sv(x, k, r), (t,))


def test_mcca_losses_match_jax():
    h1, h2 = _correlated_views(n=200, d=8)
    h3, _ = _correlated_views(n=200, d=8, seed=1)
    with _x64():
        hs = [jnp.asarray(h) for h in (h1, h2, h3)]
        ref = [float(JO.mcca_loss(hs, 4)), float(JO.mcca_loss_chol(hs, 4))]
    ts = [torch.tensor(h) for h in (h1, h2, h3)]
    got = [O.mcca_loss(ts, 4).item(), O.mcca_loss_chol(ts, 4).item()]
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_linear_cca_matches_jax():
    h1, h2 = _correlated_views(n=300, d=8)
    ours, theirs = LinearCCA(), JLinearCCA()
    ours.fit(h1, h2, 6)
    theirs.fit(h1, h2, 6)
    for a, b in zip(ours.m + ours.w + [ours.D], theirs.m + theirs.w + [theirs.D]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.transform(h1, 0), theirs.transform(h1, 0))


def test_rmsprop_matches_optax():
    """optax.chain(add_decayed_weights(1e-5), rmsprop(1e-3)) over 5 steps,
    float32: parameters to rtol 1e-6. torch.optim.RMSprop with its own
    defaults (alpha 0.99, eps outside the root) drifts from it."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * (3.0 if t == 0 else 0.2)).astype(np.float32)
              for s in shapes] for t in range(5)]
    tx = optax.chain(optax.add_decayed_weights(1e-5), optax.rmsprop(1e-3))
    jp = [jnp.asarray(p) for p in init]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.tensor(p)) for p in init]
    opt = RMSprop(params, lr=1e-3, weight_decay=1e-5)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(x) for x in g])
        for ours, theirs in zip(params, jp):
            np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                       rtol=1e-6, atol=1e-8)

    tp = [torch.nn.Parameter(torch.tensor(p)) for p in init]
    topt = torch.optim.RMSprop(tp, lr=1e-3, weight_decay=1e-5)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        topt.step()
    drift = max(np.abs(a.detach().numpy() - np.asarray(b)).max() for a, b in zip(tp, jp))
    assert drift > 1e-4


@pytest.fixture(scope="module")
def solvers(tmp_path_factory):
    """One epoch of JAX's Solver and of the port's (the chol loss, float32,
    CPU) from the same weights on the same synthetic data; and the batch
    they are both scored on after it. (Float32, as the JAX CLI trains: XLA
    takes about a minute on the CPU to compile each float64 conv gradient.)"""
    data = str(tmp_path_factory.mktemp("data"))
    kw = dict(batch_size=BATCH, synthetic_n=SYNTH_N, data_path=data)
    j_train, _, j_val = jax_dataloaders("mnist_svhn", **kw)
    train, _, val = get_dataloaders("mnist_svhn", **kw)
    xs, _ = next(iter(train))

    jsolver = JSolver(j_trunks(OUTDIM), OUTDIM, backend="chol")
    key = jax.random.PRNGKey(0)
    start, _ = jsolver.init(xs, key)  # what fit() draws from the same key
    logs = []
    jsolver.fit(j_train, j_val, epochs=1, key=key, log=logs.append)
    j_scored = float(JO.cca_loss_chol(*jsolver.model.apply(
        jsolver.variables, [jnp.asarray(x) for x in xs]), OUTDIM))

    solver = Solver(dcca_encoders_mnist_svhn(OUTDIM), OUTDIM, backend="chol", device="cpu")
    solver.fit(train, val, epochs=1, params=jax.tree.map(np.asarray, start["params"]),
               log=lambda s: None)
    with torch.no_grad():
        scored = O.cca_loss_chol(*solver.model([torch.tensor(x) for x in xs]), OUTDIM).item()
    return dict(jsolver=jsolver, logs=logs, j_scored=j_scored, solver=solver, scored=scored,
                xs=xs, data=data)


def test_solver_epoch_matches_jax(solvers):
    """After one epoch (10 steps) from the same weights, float32 on both
    sides: the train and val losses to JAX's printed 4 decimals, the loss
    of the trained trunks on one batch to rtol 1e-4, every trunk parameter
    to 1e-2 of its leaf's largest entry, and the linear CCA's means and
    correlations to 5e-3 of their largest entry. (RMSprop's step is about lr * sign(g) wherever
    the second moment is young, so float32 round-off in a small gradient
    moves a parameter by up to 3 lr: 0.5 % of a leaf here. The losses and
    the optimizer are held tightly by the float64 and optax tests above.)"""
    jsolver, solver = solvers["jsolver"], solvers["solver"]
    (line,) = solvers["logs"]
    words = line.split()
    j_train, j_val = float(words[words.index("train") + 1]), float(words[words.index("val") + 1])
    assert abs(solver.history["train_loss"][0] - j_train) <= 1.5e-4
    assert abs(solver.history["val_loss"][0] - j_val) <= 1.5e-4
    np.testing.assert_allclose(solvers["scored"], solvers["j_scored"], rtol=1e-4)
    ours = dict(_flat(export_jax_params(solver.model)))
    theirs = dict(_flat(jax.tree.map(np.asarray, jsolver.variables["params"])))
    assert sorted(ours) == sorted(theirs)
    for path, v in theirs.items():
        np.testing.assert_allclose(ours[path], v, rtol=0, atol=1e-2 * np.abs(v).max(),
                                   err_msg="/".join(path))
    for a, b in zip(solver.lcca.m + [solver.lcca.D], jsolver.lcca.m + [jsolver.lcca.D]):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3 * np.abs(b).max())
        assert a.shape == b.shape


def _jnf_dcca_model(path, dim_dcca=5):
    cfg = ExperimentConfig.from_json("configs/mnist_svhn/jnf_dcca_synth.json")
    cfg.latent_dim, cfg.dim_dcca = 4, dim_dcca
    cfg.extra["dcca_path"] = path
    bundle = registry.build(cfg)
    registry.graft_dcca_params(bundle.model, path)
    return bundle.model


def test_artifact_round_trip_into_jnf_dcca(solvers, tmp_path):
    """Solver.save -> registry build + graft: the model's DCCA embeddings
    equal the Solver's linear-CCA projection of its trunks' outputs, and
    the trunks sit in every first_encoder site."""
    solver = solvers["solver"]
    path = str(tmp_path / "dcca.npz")
    solver.save(path)
    with np.load(path) as npz:
        assert {"m0", "m1", "w0", "w1", "D"} <= set(npz.files)
        assert "params/encoders_1/c1/kernel" in npz.files
        assert npz["params/encoders_0/Linear_0/kernel"].dtype == np.float32
    model = _jnf_dcca_model(path).double()
    xs = [torch.tensor(x[:8], dtype=torch.float64) for x in solvers["xs"]]
    with torch.no_grad():
        got = model.dcca_embeddings(xs)
        trunk = solver.model(xs)
    for m in range(2):
        want = solver.lcca.transform(trunk[m].numpy(), m)[:, :5]
        np.testing.assert_allclose(got[m].numpy(), want, rtol=1e-6, atol=1e-6)
        assert model.vaes[m].encoder.first_encoder is model.dcca_encoders[m]


def _convert_jax_artifact(src, dst):
    """Rewrite a JAX-package artifact (flax msgpack trunks) in the port's
    layout: one array per leaf under params/<JAX path>."""
    from flax import serialization

    with np.load(src) as npz:
        arrays = {k: npz[k] for k in ("m0", "m1", "w0", "w1", "D")}
        tree = serialization.msgpack_restore(bytearray(npz["params"].tobytes()))["params"]
    arrays.update({"params/" + "/".join(k): v.astype(np.float32) for k, v in _flat(tree)})
    np.savez(dst, **arrays)


def test_jax_artifact_is_refused_then_converted(solvers, tmp_path):
    """The port refuses a JAX artifact's msgpack trunks with an error that
    says so; converted, it grafts and gives JAX's embeddings."""
    jsolver = solvers["jsolver"]
    jpath, path = str(tmp_path / "jax_dcca.npz"), str(tmp_path / "dcca.npz")
    jsolver.save(jpath)
    with pytest.raises(ValueError, match="JAX-package DCCA artifact"):
        load_trunk_params(jpath)
    _convert_jax_artifact(jpath, path)
    model = _jnf_dcca_model(path)
    xs = [x[:8] for x in solvers["xs"]]
    with torch.no_grad():
        got = model.dcca_embeddings([torch.tensor(x) for x in xs])
    trunk = jsolver.model.apply(jsolver.variables, [jnp.asarray(x) for x in xs])
    for m in range(2):
        want = jsolver.lcca.transform(np.asarray(trunk[m]), m)[:, :5]
        np.testing.assert_allclose(got[m].numpy(), want, rtol=1e-4, atol=1e-4)


def test_other_datasets_wait_for_slice_6():
    """The trunks of MNIST-SVHN-Fashion (three views), MedMNIST, chest-SVHN
    and CelebA build at their default widths, each trunk giving the
    outdim-wide embedding of its modality."""
    shapes = {"medmnist": ((1, 28, 28), (3, 28, 28)), "chest_svhn": ((1, 28, 28), (3, 32, 32)),
              "celeba": ((3, 64, 64), (1, 1, 40)),
              "mnist_svhn_fashion": ((1, 28, 28), (3, 32, 32), (1, 28, 28))}
    for dataset, mods in shapes.items():
        builder, outdim = DCCA_BUILDERS[dataset]
        assert outdim == (40 if dataset == "celeba" else 16)
        trunks = builder(outdim)
        assert len(trunks) == len(mods)
        with torch.no_grad():
            for trunk, shape in zip(trunks, mods):
                out = trunk(torch.zeros((2,) + shape))
                assert (out[0] if isinstance(out, tuple) else out).shape == (2, outdim)


def test_dcca_cli_cpu(solvers, tmp_path, capsys):
    """The DCCA CLI on the CPU: the eigh loss in float64, the artifact, the
    SVM probe's lines of each view, as JAX prints them (test_torch_linear.py
    holds the probe to scikit-learn's), and the embedding figure of each
    view (test_torch_embed.py holds their UMAP to JAX's)."""
    out = dcca_train.main(["--device", "cpu", "--epochs", "1", "--batch-size", str(BATCH),
                           "--synthetic-n", str(SYNTH_N), "--outdim", str(OUTDIM),
                           "--data-path", solvers["data"], "--out", str(tmp_path / "dcca")])
    text = capsys.readouterr().out
    assert out == str(tmp_path / "dcca" / "mnist_svhn" / "dcca.npz")
    assert "eigh loss in float64 on cpu" in text and "DCCA epoch 1/1 train" in text
    for v in (0, 1):
        line, = [ln for ln in text.splitlines() if ln.startswith(f"SVM probe view {v}: acc ")]
        assert 0.0 <= float(line.split()[-1]) <= 1.0
    for v in (0, 1):
        png = tmp_path / "dcca" / "mnist_svhn" / f"embedding_{v}.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        spec = json.loads((tmp_path / "dcca" / "mnist_svhn" / f"embedding_{v}.png.json")
                          .read_text())
        assert 0 < sum(len(s["points"]) for s in spec["panels"][0][0]["series"]) <= 300
    trunks = load_trunk_params(out)
    assert sorted(trunks) == ["encoders_0", "encoders_1"]
    with np.load(out) as npz:
        assert npz["w0"].shape == (OUTDIM, OUTDIM) and np.isfinite(npz["D"]).all()


def test_dcca_cli_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcca_train.main(["--epochs", "1"])
