"""TELBO-NF of the port against the JAX package: the m_telbo_nf objective
and every gradient leaf in warmup and past warmup, with the unimodal VAEs'
reconstruction loss `mse` and `bce`, in float64 and float32, and once in
float32 through JAX's Pallas solve in interpret mode; the frozen joint
encoder and decoders after a post-warmup Trainer step; the train CLI over
the warmup boundary; and the skip_warmup configs with an empty joint pool.

`configs/mnist_svhn/telbo_nf.json` (the JMVAE-NF model with MAF flows)
at latent 4 and B=4 (the joint heads stay 20 wide, as the JAX registry
builds them). Noise is drawn with numpy and injected on the JAX side by
monkeypatching the sampler (mmvae_tpu.models.vae.D.sample), in JAX's draw
order: the joint forward, then each unimodal VAE forward (past warmup).
Elsewhere the JAX flows run their plain solve (`unrolled_solve`): the
Pallas kernel accumulates in float32 even under x64, and its interpret mode
triples a case's compile time.
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
from mmvae_tpu_torch.objectives import m_telbo_nf, resolve
from mmvae_tpu_torch.train import Trainer

TELBO_NF = "configs/mnist_svhn/telbo_nf.json"
TELBO_SYNTH = "configs/mnist_svhn/telbo_synth.json"
LATENT, B = 4, 4
# case -> (past_warmup, the unimodal VAEs' reconstruction loss)
CASES = {"warmup": (False, "mse"), "post_mse": (True, "mse"), "post_bce": (True, "bce")}
# (value rtol, gradient tolerance as a share of each leaf's largest entry);
# float32: two summation orders through the 20-step flow solves and the
# batch sums of the objective
TOLERANCES = {"float64": (1e-10, 1e-8), "float32": (1e-5, 1e-4)}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def telbo():
    """(JAX bundle, float32 numpy params) of telbo_nf.json at latent 4,
    initialised through init_all (the unimodal encoders and flows too)."""
    jcfg = JCfg.from_json(TELBO_NF)
    jcfg.latent_dim = LATENT
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        jb = jreg.build(jcfg)
        xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
        params = jax.jit(lambda k, x: jb.model.init({"params": k, "sample": k}, x, K=1,
                                                    method="init_all")["params"])(
            jax.random.PRNGKey(0), xs)
    return jb, jax.tree.map(np.asarray, params)


def _port(telbo, dtype=torch.float32):
    cfg = ExperimentConfig.from_json(TELBO_NF)
    cfg.latent_dim = LATENT
    bundle = registry.build(cfg)
    bundle.model.to(dtype)
    load_jax_params(bundle.model, telbo[1])
    return cfg, bundle


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(B, 1, 28, 28)), rng.uniform(size=(B, 3, 32, 32))]
    eps = [rng.standard_normal((B, LATENT)) for _ in range(3)]
    return [x.astype(dtype) for x in xs], [e.astype(dtype) for e in eps]


def _inject_normal(monkeypatch, eps):
    calls = []

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal" and tuple(sample_shape) == ()
        e = eps[len(calls)]
        calls.append(dist)
        return p.loc + jnp.asarray(e) * p.scale

    monkeypatch.setattr(jvae.D, "sample", sample)
    return calls


@contextlib.contextmanager
def _jax_dtype(dtype, monkeypatch, pallas=False):
    """JAX in float64 (x64 on, the float64 policy) on its flows' plain
    solve, or float32 on the plain solve or, with `pallas`, on the Pallas
    kernel (interpret mode on the CPU)."""
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


def _grads_tree(model, grads):
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(model)))
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


PARITY_CASES = [(c, d, False) for c in CASES for d in ("float64", "float32")] + \
    [("post_mse", "float32", True)]


@pytest.mark.parametrize("case,dtype,pallas", PARITY_CASES)
def test_m_telbo_nf_matches_jax(telbo, monkeypatch, case, dtype, pallas):
    """The objective's value, its details and every parameter's gradient
    (jax.grad on the JAX side), both packages in `dtype` at the same
    weights and noise; tolerances in TOLERANCES. Past warmup the unimodal
    VAE forwards run both packages' sequential solves under autograd (the
    port's plain solve on the CPU)."""
    past_warmup, vae_loss = CASES[case]
    jb, params = telbo
    xs, eps = _inputs(dtype)
    calls = _inject_normal(monkeypatch, eps)
    kw = dict(epoch=3 if past_warmup else 1, warmup=3, beta_prior=0.8, past_warmup=past_warmup)
    with _jax_dtype(dtype, monkeypatch, pallas):
        spec = dataclasses.replace(jb.spec, vae_recon_losses=(vae_loss, vae_loss))
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        jx = [jnp.asarray(x) for x in xs]

        def objective(p):
            obj, details, _ = jobj.m_telbo_nf(jb.model, {"params": p}, jx, jax.random.PRNGKey(3),
                                              spec, train=True, **kw)
            return obj, details

        (j_obj, j_det), j_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jparams)
        j_obj, j_grads = float(j_obj), dict(_flat(j_grads))
        j_det = {k: float(v) for k, v in j_det.items()}
    assert len(calls) == (3 if past_warmup else 1)

    _, bundle = _port(telbo, getattr(torch, dtype))
    pspec = dataclasses.replace(bundle.spec, vae_recon_losses=(vae_loss, vae_loss))
    obj, details = m_telbo_nf(bundle.model, [torch.tensor(x) for x in xs], pspec,
                              noise=[torch.tensor(e) for e in eps], frozen_joint=True, **kw)
    assert obj.dtype == getattr(torch, dtype)
    value_rtol, grad_tol = TOLERANCES[dtype]
    np.testing.assert_allclose(obj.item(), j_obj, rtol=value_rtol)
    assert sorted(details) == sorted(j_det)
    assert ("neg_elbo_0" in details) == past_warmup
    for k, v in j_det.items():
        np.testing.assert_allclose(float(details[k]), v, rtol=value_rtol,
                                   atol=value_rtol * abs(j_obj), err_msg=k)
    params_ = list(bundle.model.parameters())
    grads = torch.autograd.grad(obj, params_, allow_unused=True)
    ours = _grads_tree(bundle.model, [torch.zeros_like(p) if g is None else g
                                      for p, g in zip(params_, grads)])
    assert sorted(ours) == sorted(j_grads)
    for path, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(ours[path], g, rtol=grad_tol, atol=grad_tol * scale,
                                   err_msg="/".join(path))
    flow_grads = [v for p, v in ours.items() if "flow" in p]
    assert flow_grads and all(np.any(v) for v in flow_grads) == past_warmup


def test_post_warmup_step_keeps_frozen_params(telbo):
    """One post-warmup Trainer step (the optimizer the Trainer resets to at
    the boundary, fix_jencoder and fix_decoders): every joint_encoder and
    decoder parameter keeps its bits; the unimodal encoders and the MADE
    blocks move; no step is skipped."""
    cfg, bundle = _port(telbo)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu", log_fn=lambda s: None)
    assert trainer.obj_name == "m_telbo_nf" and resolve("telbo_nf", True, False)[0] == "m_telbo_nf"
    trainer.init_opt_state(past_warmup=True, amsgrad=False)
    xs, _ = _inputs("float32", seed=1)
    before = {n: p.detach().clone() for n, p in bundle.model.named_parameters()}
    loss, details = trainer.train_step([torch.tensor(x) for x in xs], cfg.learning_rate,
                                       epoch=cfg.warmup)
    assert torch.isfinite(loss) and details["nan_skipped"].item() == 0.0
    assert details["neg_elbo_1"].item() > 0
    moved = {n for n, p in bundle.model.named_parameters() if not torch.equal(p, before[n])}
    frozen = [n for n in before if "joint_encoder" in n or "decoder" in n]
    assert frozen and not moved.intersection(frozen)
    assert any(".flow.made." in n for n in moved)
    assert any(n.startswith("vaes.0.encoder.") for n in moved)
    assert any(n.startswith("vaes.1.encoder.") for n in moved)


def _write_config(tmp_path, config, **kw):
    with open(config) as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(latent_dim=LATENT, synthetic_n=64, batch_size=16, epochs=2, warmup=2,
               no_analytics=True, data_path=str(tmp_path / "data"))
    raw.update(kw)
    path = tmp_path / f"cfg_{len(os.listdir(tmp_path))}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _metrics(run_path):
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_telbo_nf_two_epochs_cpu(tmp_path, capsys):
    """telbo_nf.json through the port's CLI on the CPU at a tiny size, over
    the warmup boundary: epoch 1 trains the joint ELBO alone; epoch 2
    resets the optimizer and adds the unimodal VAEs' ELBOs."""
    run_path = cli_train.main(["--config-path", _write_config(tmp_path, TELBO_NF),
                               "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "objective: m_telbo_nf on cpu" in out
    assert "Epoch 2: optimizer reset (post-warmup)" in out
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert len(losses["train_loss"]) == 2
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    m1, m2 = _metrics(run_path)
    assert "train_neg_elbo_0" not in m1 and "val_neg_elbo_1" not in m1
    assert m2["train_neg_elbo_0"] > 0 and m2["val_neg_elbo_1"] > 0
    assert m1["train_nan_skipped"] == m2["train_nan_skipped"] == 0.0


def test_cli_skip_warmup_with_empty_pool(tmp_path, capsys):
    """telbo_synth.json (skip_warmup, no flow) with no joint-encoder pool:
    the CLI says so and trains from scratch, warmup epoch included."""
    cfg = _write_config(tmp_path, TELBO_SYNTH)
    exp = tmp_path / "exp"
    run_path = cli_train.main(["--config-path", cfg, "--experiments-dir", str(exp),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    pool = os.path.join(str(exp), "joint_encoders", "mnist_svhn_synth")
    assert f"skip_warmup: no pool at {pool}; training from scratch" in out
    m1, m2 = _metrics(run_path)
    assert "train_neg_elbo_0" not in m1 and m2["train_neg_elbo_0"] > 0
    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    assert not any(".flow." in k for k in state)
    assert isinstance(registry.build(ExperimentConfig.from_json(cfg)).model, JMVAE_NF)
