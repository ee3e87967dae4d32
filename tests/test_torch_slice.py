"""The MMVAE-NF training slice of the port against the JAX package:

- the m_elbo_nf objective and every parameter's gradient at the same
  weights and noise (latent 4, B=4, the registry's full-width nets);
- the hand-written AMSGrad/Adam update against optax over 5 steps;
- nan_guard on an injected NaN;
- data loaders and the device-pipeline gather, identical to JAX's at
  synthetic_n=64;
- a 1-epoch `--device cpu` run of the port's CLI.

Noise is drawn with numpy and injected on the JAX side by monkeypatching
the sampler its VAE calls (mmvae_tpu.models.vae.D.sample).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.data import get_dataloaders as jax_dataloaders
from mmvae_tpu.data.device_pipeline import from_array_loader as jax_pipeline
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.models import vae as jvae
from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.cli import train as cli_train
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import get_dataloaders
from mmvae_tpu_torch.data.device_pipeline import from_array_loader
from mmvae_tpu_torch.data.loaders import LazyGather
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.objectives import m_elbo_nf
from mmvae_tpu_torch.train import Trainer
from mmvae_tpu_torch.train.optim import Adam

CONFIG = "configs/mnist_svhn/mmvae_nf_synth.json"
LATENT, B = 4, 4


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_m_elbo_nf_value_and_grads_match_jax(monkeypatch):
    """Objective to rtol 1e-5; each gradient leaf to 1e-4 of its largest
    entry (float32 on both sides, different summation order through a
    20-step exp chain and two flows)."""
    rng = np.random.default_rng(0)
    xs = [rng.uniform(size=(B, 1, 28, 28)).astype(np.float32),
          rng.uniform(size=(B, 3, 32, 32)).astype(np.float32)]
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(2)]

    jcfg = JCfg.from_json(CONFIG)
    jcfg.latent_dim = LATENT
    jb = jreg.build(jcfg)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    params = jax.jit(lambda k, x: jb.model.init(k, x)["params"])(keys, [jnp.asarray(x) for x in xs])

    calls = []

    def injected_sample(dist, p, key, sample_shape=()):
        e = eps[len(calls) % 2]  # vaes_0 (MNIST) samples first, then vaes_1
        calls.append(dist)
        return p.loc + jnp.asarray(e) * p.scale

    monkeypatch.setattr(jvae.D, "sample", injected_sample)

    def objective(p):
        obj, _, _ = jobj.m_elbo_nf(jb.model, {"params": p}, [jnp.asarray(x) for x in xs],
                                   jax.random.PRNGKey(2), jb.spec)
        return obj

    j_obj, j_grads = jax.jit(jax.value_and_grad(objective))(params)
    assert calls[:2] == ["normal", "normal"]

    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.latent_dim = LATENT
    bundle = registry.build(cfg)
    model = bundle.model
    load_jax_params(model, jax.tree.map(np.asarray, params))
    assert bundle.spec.lik_scaling == jb.spec.lik_scaling == (3 * 32 * 32 / 784, 1.0)
    obj, _ = m_elbo_nf(model, [torch.tensor(x) for x in xs], bundle.spec,
                       K=30, noise=[torch.tensor(e) for e in eps])
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=1e-5)
    obj.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    ours, theirs = dict(_flat(export_jax_params(model))), dict(_flat(j_grads))
    assert sorted(ours) == sorted(theirs)
    for path, g in theirs.items():
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(ours[path], g, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg="/".join(path))


def _grad_stream(rng, shapes, steps=5):
    # a large first gradient then small ones: AMSGrad's running max matters
    return [[(rng.standard_normal(s) * (4.0 if t == 0 else 0.3)).astype(np.float32)
             for s in shapes] for t in range(steps)]


@pytest.mark.parametrize("amsgrad,clip", [(True, 0.0), (False, 0.0), (True, 0.5)])
def test_optimizer_matches_optax(amsgrad, clip):
    """Parameters after each of 5 steps equal optax's to float32 round-off
    (rtol 1e-6, atol 1e-7)."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = _grad_stream(rng, shapes)
    lr = 1e-2

    tx = optax.amsgrad(1.0) if amsgrad else optax.adam(1.0)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = [jnp.asarray(p) for p in init]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.tensor(p)) for p in init]
    opt = Adam(params, amsgrad=amsgrad, clip_grad_norm=clip)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, upd))
        opt.step([torch.tensor(x) for x in g], lr)
        for ours, theirs in zip(params, jp):
            np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                       rtol=1e-6, atol=1e-7)

    if amsgrad and not clip:
        # torch's own AMSGrad keeps the max of the raw moment: it drifts
        tp = [torch.nn.Parameter(torch.tensor(p)) for p in init]
        topt = torch.optim.Adam(tp, lr=lr, amsgrad=True, eps=1e-8)
        for g in grads:
            for p, x in zip(tp, g):
                p.grad = torch.tensor(x)
            topt.step()
        drift = max(np.abs(a.detach().numpy() - np.asarray(b)).max() for a, b in zip(tp, jp))
        assert drift > 1e-4


def _tiny_cfg(**kw):
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.latent_dim = LATENT
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_nan_guard_skips_step():
    cfg = _tiny_cfg()
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu")
    trainer.init_parameters()
    trainer.init_opt_state()
    g = torch.Generator().manual_seed(0)
    xs = [torch.rand(B, 1, 28, 28, generator=g), torch.rand(B, 3, 32, 32, generator=g)]
    bad = [x.clone() for x in xs]
    bad[1][0, 0, 0, 0] = float("nan")
    before = {n: p.detach().clone() for n, p in bundle.model.named_parameters()}

    loss, details = trainer.train_step(bad, lr=1e-3)
    assert not torch.isfinite(loss) and details["nan_skipped"].item() == 1.0
    for n, p in bundle.model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert trainer.opt.count.item() == 0
    assert all(torch.count_nonzero(m) == 0 for m in trainer.opt.mu + trainer.opt.nu)

    loss, details = trainer.train_step(xs, lr=1e-3)
    assert torch.isfinite(loss) and details["nan_skipped"].item() == 0.0
    assert trainer.opt.count.item() == 1
    assert any(not torch.equal(p, before[n]) for n, p in bundle.model.named_parameters())


def test_loaders_and_pipeline_match_jax(tmp_path):
    kw = dict(batch_size=16, synthetic_n=64, data_path=str(tmp_path))
    theirs, ours = jax_dataloaders("mnist_svhn", **kw), get_dataloaders("mnist_svhn", **kw)
    for jl, pl in zip(theirs, ours):
        assert jl.num_examples == pl.num_examples and len(jl) == len(pl)
        for jm, pm in zip(jl.dataset.modalities, pl.dataset.modalities):
            assert isinstance(pm, LazyGather)
            np.testing.assert_array_equal(pm.base, jm.base)
            np.testing.assert_array_equal(pm.idx, jm.idx)
        for a, b in zip(jl.dataset.labels, pl.dataset.labels):
            np.testing.assert_array_equal(a, b)
        for (jx, jy), (px, py) in zip(jl, pl):
            for a, b in zip(jx + jy, px + py):
                np.testing.assert_array_equal(a, b)

    jp, pp = jax_pipeline(theirs[0]), from_array_loader(ours[0], device="cpu")
    assert jp.is_uint8 == pp.is_uint8 == [True, True]
    j_rows, p_rows = list(jp.epoch_index_batches()), list(pp.epoch_index_batches())
    assert len(p_rows) == ours[0].num_examples // 16
    gather = jp.gather_fn()
    for jr, pr in zip(j_rows[:3], p_rows[:3]):
        np.testing.assert_array_equal(jr, pr)
        for a, b in zip(gather(jnp.asarray(jr), jp.data_state), pp.gather(torch.from_numpy(pr))):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _write_config(tmp_path, **kw):
    with open(CONFIG) as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(latent_dim=LATENT, synthetic_n=64, batch_size=16, epochs=1, no_analytics=True,
               data_path=str(tmp_path / "data"))
    raw.update(kw)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_one_epoch_cpu(tmp_path):
    run_path = cli_train.main(["--config-path", _write_config(tmp_path),
                               "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"])
    assert run_path.startswith(str(tmp_path / "exp" / "mmvae_nf" / "mnist_svhn_synth"))
    for name in ("args.json", "losses.json", "metrics.jsonl", "model.pt"):
        assert os.path.exists(os.path.join(run_path, name)), name
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert len(losses["train_loss"]) == len(losses["test_loss"]) == 1
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        metrics = json.loads(f.readline())
    assert metrics["train_nan_skipped"] == 0.0 and metrics["epoch"] == 1
    with open(os.path.join(run_path, "args.json")) as f:
        assert json.load(f)["synthetic_n"] == 64


def test_cli_refuses_analytics(tmp_path):
    with pytest.raises(NotImplementedError, match="analytics not yet ported"):
        cli_train.main(["--config-path", _write_config(tmp_path, no_analytics=False),
                        "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"])
