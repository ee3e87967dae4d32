"""The JMVAE-NF(-DCCA) slice of the port against the JAX package: the
m_jmvae_nf objective and every gradient leaf in warmup, past warmup (with
and without the unimodal reconstructions, and with the frozen joint fast
path) and with DCCA trunks behind a linear-CCA projection, in float64 and
float32; the port's frozen fast path, the phase freezing, the train CLI
over the warmup/post-warmup boundary, and the skip_warmup pool.

The registry's nets at latent 4 and B=4 (the joint heads stay 20 wide, as
the JAX registry builds them). Noise is drawn with numpy and injected on
the JAX side by monkeypatching the sampler (mmvae_tpu.models.vae.D.sample),
in JAX's draw order: the joint forward, compute_kld's joint sample, then
each unimodal VAE forward. The JAX flows run their own plain solve
(`unrolled_solve`, which JAX's tests hold its Pallas kernel to): the
kernel accumulates in float32 even under x64, and its interpret mode
triples the compile time of each case.
"""

import contextlib
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.models import vae as jvae
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.cli import train as cli_train
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.models import JMVAE_NF, registry
from mmvae_tpu_torch.objectives import ModelSpec, m_jmvae_nf
from mmvae_tpu_torch.train import Trainer, checkpoints, freezing

JNF = "configs/mnist_svhn/jmvae_nf.json"
JNF_DCCA = "configs/mnist_svhn/jnf_dcca_synth.json"
LATENT, B, DIM_DCCA = 4, 4, 3


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _fake_artifact(path):
    """A linear-CCA projection of a 16-wide trunk, far from the identity."""
    rng = np.random.default_rng(7)
    arrays = {f"m{i}": rng.normal(size=16).astype(np.float32) for i in range(2)}
    arrays.update({f"w{i}": (rng.normal(size=(16, 16)) / 4).astype(np.float32) for i in range(2)})
    np.savez(path, **arrays)
    return arrays


def _cfgs(dcca, dcca_path):
    jcfg, cfg = JCfg.from_json(JNF), ExperimentConfig.from_json(JNF)
    for c in (jcfg, cfg):
        c.latent_dim, c.dcca, c.dim_dcca = LATENT, dcca, DIM_DCCA
        c.extra["dcca_path"] = dcca_path
    return jcfg, cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """B=4 needs no intra-op threads; under several test workers they only
    oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jnf_models(tmp_path_factory):
    """{dcca: (JAX bundle, float32 numpy params, artifact path)}, the JAX
    JNF and JNF-DCCA at latent 4, initialised through init_all."""
    path = str(tmp_path_factory.mktemp("dcca") / "dcca.npz")
    _fake_artifact(path)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        for dcca in (False, True):
            jb = jreg.build(_cfgs(dcca, path)[0])
            xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
            key = jax.random.PRNGKey(0)
            params = jax.jit(lambda k, x, jb=jb: jb.model.init(
                {"params": k, "sample": k}, x, K=1, method="init_all")["params"])(key, xs)
            out[dcca] = (jb, jax.tree.map(np.asarray, params), path)
    return out


def _port(jnf_models, dcca, dtype=torch.float32, no_recon=None):
    jb, params, path = jnf_models[dcca]
    cfg = _cfgs(dcca, path)[1]
    if no_recon is not None:
        cfg.no_recon = no_recon
    bundle = registry.build(cfg)
    bundle.model.to(dtype)
    load_jax_params(bundle.model, params)
    return cfg, bundle


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(B, 1, 28, 28)), rng.uniform(size=(B, 3, 32, 32))]
    eps = [rng.standard_normal((B, LATENT)) for _ in range(4)]
    return [x.astype(dtype) for x in xs], [e.astype(dtype) for e in eps]


def _inject_normal(monkeypatch, eps):
    """The JAX package's samplers draw `eps` in turn."""
    calls = []

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal" and tuple(sample_shape) == ()
        e = eps[len(calls)]
        calls.append(dist)
        return p.loc + jnp.asarray(e) * p.scale

    monkeypatch.setattr(jvae.D, "sample", sample)
    return calls


@contextlib.contextmanager
def _jax_dtype(dtype, monkeypatch):
    """JAX's flows on their plain solve, in float64 (x64 on, the float64
    policy) or as they are."""
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


def _grads_tree(model, grads):
    """The JAX-layout tree of `grads` (one per model parameter)."""
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(model)))
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


# case -> (dcca, past_warmup, no_recon, frozen_joint)
CASES = {
    "warmup": (False, False, False, False),
    "post_no_recon": (False, True, True, False),
    "post_recon": (False, True, False, False),
    "post_frozen_joint": (False, True, False, True),
    "dcca_post_recon": (True, True, False, False),
    "dcca_post_no_recon_frozen": (True, True, True, True),
}
# (value rtol, gradient tolerance as a share of each leaf's largest entry);
# float32: two summation orders through the 20-step flow solves and the
# batch sums of the objective
TOLERANCES = {"float64": (1e-10, 1e-8), "float32": (1e-5, 1e-4)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_m_jmvae_nf_matches_jax(jnf_models, monkeypatch, case, dtype):
    """The objective's value, its details and every parameter's gradient
    (jax.grad on the JAX side), both packages in `dtype` at the same
    weights and noise; tolerances in TOLERANCES."""
    dcca, past_warmup, no_recon, frozen = CASES[case]
    jb, params, _ = jnf_models[dcca]
    xs, eps = _inputs(dtype)
    calls = _inject_normal(monkeypatch, eps)
    kw = dict(epoch=2 if past_warmup else 1, warmup=2, beta_prior=1.0, beta_kl=0.7,
              past_warmup=past_warmup, frozen_joint=frozen)
    spec = dataclasses.replace(jb.spec, no_recon=no_recon)
    with _jax_dtype(dtype, monkeypatch):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        jx = [jnp.asarray(x) for x in xs]

        def objective(p):
            obj, details, _ = jobj.m_jmvae_nf(jb.model, {"params": p}, jx, jax.random.PRNGKey(3),
                                              spec, train=True, **kw)
            return obj, details

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))
        j_det = {k: float(v) for k, v in j_det.items()}
    # the joint forward; past warmup compute_kld's joint sample, and without
    # no_recon one unimodal VAE forward per modality
    assert len(calls) == (1 if not past_warmup else 2 if no_recon else 4)

    _, bundle = _port(jnf_models, dcca, getattr(torch, dtype), no_recon=no_recon)
    model = bundle.model
    obj, details = m_jmvae_nf(model, [torch.tensor(x) for x in xs], bundle.spec,
                              noise=[torch.tensor(e) for e in eps], **kw)
    assert obj.dtype == getattr(torch, dtype)
    value_rtol, grad_tol = TOLERANCES[dtype]
    np.testing.assert_allclose(obj.item(), j_obj, rtol=value_rtol)
    assert sorted(details) == sorted(j_det)
    for k, v in j_det.items():
        np.testing.assert_allclose(float(details[k]), v, rtol=value_rtol,
                                   atol=value_rtol * abs(j_obj), err_msg=k)
    params_ = list(model.parameters())
    grads = torch.autograd.grad(obj, params_, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params_, grads)]
    ours = _grads_tree(model, grads)
    assert sorted(ours) == sorted(j_grads)
    for path, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(ours[path], g, rtol=grad_tol, atol=grad_tol * scale,
                                   err_msg="/".join(path))


def test_bridge_maps_jax_jnf_trees(jnf_models):
    """Every leaf of the JAX JNF and JNF-DCCA trees lands on one port
    parameter and comes back unchanged. The DCCA trunk, shared in JAX by the
    TwoStepsEncoder and the model's dcca_encoders, is one module in the port
    too, named vaes.i.encoder.first_encoder...; the linear-CCA arrays are
    buffers, not parameters."""
    for dcca in (False, True):
        _, params, _ = jnf_models[dcca]
        _, bundle = _port(jnf_models, dcca)
        back = dict(_flat(export_jax_params(bundle.model)))
        ref = dict(_flat(params))
        assert sorted(back) == sorted(ref)
        for path, v in ref.items():
            np.testing.assert_array_equal(back[path], v)
        names = [n for n, _ in bundle.model.named_parameters()]
        assert not [n for n in names if n.startswith("dcca_encoders")]
        trunk = [n for n in names if "first_encoder" in n]
        assert len(trunk) == (6 + 10 if dcca else 0)  # MLP and conv trunks
        if dcca:
            model = bundle.model
            assert model.dcca_encoders[0] is model.vaes[0].encoder.first_encoder
            assert {n for n, _ in model.named_buffers() if "first_encoder" in n} == {
                f"vaes.{i}.encoder.first_encoder.{b}" for i in (0, 1) for b in "mw"}


def _split(model, no_recon):
    """m_jmvae_nf's value, details and gradients with and without the frozen
    fast path, past warmup (float32)."""
    xs, eps = _inputs("float32", seed=1)
    xs, eps = [torch.tensor(x) for x in xs], [torch.tensor(e) for e in eps]
    spec = ModelSpec(latent_dim=LATENT, lik_scaling=(3 * 32 * 32 / 784, 1.0),
                              no_recon=no_recon)
    out = {}
    for frozen in (False, True):
        obj, det = m_jmvae_nf(model, xs, spec, epoch=20, warmup=10, beta_kl=0.7,
                              past_warmup=True, frozen_joint=frozen, noise=eps)
        params = list(model.parameters())
        grads = torch.autograd.grad(obj, params, allow_unused=True)
        out[frozen] = (obj.item(), det, [torch.zeros_like(p) if g is None else g
                                         for p, g in zip(params, grads)])
    return out


@pytest.mark.parametrize("dcca", [False, True])
@pytest.mark.parametrize("no_recon", [True, False])
def test_frozen_fast_path_is_exact(jnf_models, dcca, no_recon):
    """The port's frozen-joint fast path changes no observable quantity:
    the same loss and details, bit-identical gradients of every trainable
    leaf, and zero gradients on the joint encoder (and, without the
    unimodal reconstructions, on the decoders), which the optimizer drops
    anyway (tests/test_jnf_frozen_fastpath.py for the JAX package)."""
    _, bundle = _port(jnf_models, dcca, no_recon=no_recon)
    out = _split(bundle.model, no_recon)
    (slow, det_s, g_slow), (fast, det_f, g_fast) = out[False], out[True]
    assert slow == fast
    for k in det_s:
        assert torch.equal(det_s[k], det_f[k]), k
    frozen = freezing.frozen_prefixes_for_phase("m_jmvae_nf", True, True, True)
    trainable = freezing.trainable_parameters(bundle.model, frozen)
    n_train = n_frozen = 0
    for (name, _), gs, gf in zip(bundle.model.named_parameters(), g_slow, g_fast):
        if name in trainable:
            assert torch.equal(gs, gf), name
            n_train += 1
        else:
            if "joint_encoder" in name or (no_recon and "decoder" in name):
                assert not torch.any(gf), name
            n_frozen += 1
    assert n_train > 0 and n_frozen > 0


def test_freezing_on_jnf_dcca(jnf_models):
    """The DCCA trunk is frozen in every phase; past warmup the joint
    encoder and decoders are frozen too; the unimodal encoders' MLPs and
    the flows train in both phases."""
    _, bundle = _port(jnf_models, True)
    names = [n for n, _ in bundle.model.named_parameters()]
    for past in (False, True):
        frozen = freezing.frozen_prefixes_for_phase("m_jmvae_nf", past, True, True)
        trainable = set(freezing.trainable_parameters(bundle.model, frozen))
        for n in names:
            expect_frozen = ("first_encoder" in n
                             or (past and ("joint_encoder" in n or "decoder" in n)))
            assert (n not in trainable) == expect_frozen, (past, n)
        assert any(n.startswith("vaes.0.encoder.Linear_") for n in trainable)
        assert any(".flow." in n for n in trainable)


def _write_config(tmp_path, config=JNF, **kw):
    with open(config) as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(latent_dim=LATENT, synthetic_n=64, batch_size=16, epochs=2, warmup=2,
               skip_warmup=False, no_analytics=True, data_path=str(tmp_path / "data"))
    raw.update(kw)
    path = tmp_path / f"cfg_{len(os.listdir(tmp_path))}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_jnf_two_epochs_cpu(tmp_path, capsys):
    """jmvae_nf.json through the port's CLI on the CPU at a tiny size, over
    the warmup boundary: epoch 1 trains the joint encoder and decoders,
    epoch 2 resets the optimizer and adds the KL and unimodal terms."""
    run_path = cli_train.main(["--config-path", _write_config(tmp_path),
                               "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "objective: m_jmvae_nf on cpu" in out
    assert "Epoch 2: optimizer reset (post-warmup)" in out
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert len(losses["train_loss"]) == 2
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        m1, m2 = [json.loads(line) for line in f]
    assert m1["train_reg"] == 0.0 and "train_kld_0" not in m1
    assert m2["train_kld_0"] != 0.0 and "train_recon_loss_1" in m2
    assert m1["train_nan_skipped"] == m2["train_nan_skipped"] == 0.0


def test_cli_dcca_without_artifact_warns(tmp_path, capsys):
    """JNF-DCCA with no DCCA artifact trains with random frozen trunks and
    says so, as the JAX CLI does."""
    cfg = _write_config(tmp_path, JNF_DCCA, dcca_path=str(tmp_path / "none.npz"), epochs=1)
    cli_train.main(["--config-path", cfg, "--experiments-dir", str(tmp_path / "exp"),
                    "--device", "cpu"])
    assert "WARNING: dcca=true but no artifacts at" in capsys.readouterr().out


def test_cli_refuses_cpu_fallback(tmp_path):
    """Without a card, the default device raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--config-path", _write_config(tmp_path),
                        "--experiments-dir", str(tmp_path / "exp")])


def _tiny_trainer(tmp_path, **kw):
    cfg = ExperimentConfig.from_json(_write_config(tmp_path, JNF_DCCA, **kw))
    bundle = registry.build(cfg)
    run_path = str(tmp_path / "exp" / "run")
    os.makedirs(run_path, exist_ok=True)
    trainer = Trainer(bundle.model, bundle.spec, cfg, run_path=run_path, device="cpu",
                      experiments_dir=str(tmp_path / "exp"), log_fn=lambda s: None)
    return cfg, trainer


def test_post_warmup_epoch_keeps_frozen_params(tmp_path):
    """A JNF-DCCA run over the warmup boundary (Trainer.fit on the CPU): in
    epoch 2 the joint encoder, the decoders and the DCCA trunk keep their
    bits; the unimodal encoders and flows move."""
    cfg, trainer = _tiny_trainer(tmp_path, dcca_path=str(tmp_path / "none.npz"))
    from mmvae_tpu_torch.data import get_dataloaders

    train_l, _, val_l = get_dataloaders("mnist_svhn", batch_size=16, synthetic_n=64,
                                        data_path=cfg.data_path)
    snaps = {}

    def snap(trainer_, epoch, *a, **k):
        snaps[epoch] = {n: p.detach().clone() for n, p in trainer_.model.named_parameters()}

    trainer.fit(train_l, val_l, callbacks=[snap])
    for n, p in snaps[2].items():
        if "joint_encoder" in n or "decoder" in n or "first_encoder" in n:
            assert torch.equal(p, snaps[1][n]), n
    moved = [n for n, p in snaps[2].items() if not torch.equal(p, snaps[1][n])]
    assert any(".flow." in n for n in moved) and any("encoder.Linear_" in n for n in moved)


def test_skip_warmup_round_trip_through_pool(tmp_path):
    """save_joint publishes the joint encoder and decoders during warmup; a
    skip_warmup run loads them, starts at epoch `warmup` and trains the
    post-warmup phase only; with no pool it trains from scratch."""
    from mmvae_tpu_torch.data import get_dataloaders

    cfg, first = _tiny_trainer(tmp_path, save_joint=True, epochs=1,
                               dcca_path=str(tmp_path / "none.npz"))
    loaders = get_dataloaders("mnist_svhn", batch_size=16, synthetic_n=64,
                              data_path=cfg.data_path)
    first.fit(loaders[0], loaders[2])
    pool = first._joint_pool_path()
    assert pool == str(tmp_path / "exp" / "joint_encoders" / "mnist_svhn_synth")
    assert sorted(os.listdir(pool)) == ["model_joint_encoder.pt", "model_vaes_0_decoder.pt",
                                        "model_vaes_1_decoder.pt", "old"]
    published = {n: p.detach().clone() for n, p in first.model.named_parameters()
                 if "joint_encoder" in n or "decoder" in n}

    _, second = _tiny_trainer(tmp_path, skip_warmup=True, seed=5,
                              dcca_path=str(tmp_path / "none.npz"))
    logs = []
    second.log = logs.append
    assert second.fit(loaders[0], loaders[2]) == 3
    assert any(s.startswith("Loaded joint encoder/decoders from") for s in logs)
    assert len(second._history["train_loss"]) == 1  # epoch 2 only
    for n, p in second.model.named_parameters():
        if n in published:
            assert torch.equal(p, published[n]), n  # loaded, then frozen

    for f in sorted((tmp_path / "exp" / "joint_encoders").rglob("*.pt")):
        f.unlink()
    _, third = _tiny_trainer(tmp_path, skip_warmup=True, dcca_path=str(tmp_path / "none.npz"))
    logs = []
    third.log = logs.append
    third.fit(loaders[0], loaders[2])
    assert any("no pool at" in s for s in logs) and len(third._history["train_loss"]) == 2
    with pytest.raises(FileNotFoundError):
        checkpoints.load_joint_vae(torch.nn.Linear(2, 2), pool)
    assert isinstance(third.model, JMVAE_NF)
