"""The trimodal MNIST-SVHN-Fashion path through the port's CLIs on the CPU,
at synthetic_n 64 and latent 4: dcca_train on three views, then
jmvae_nf.json over its warmup boundary, validate with --mcmc-steps (the
PoE-subset accuracies by HMC) and compute_likelihoods --bis, with the
metric names the JAX CLIs give; jmvae_nf_dcca.json grafting the three
trunks without a linear CCA; mvae.json's subsampling through the Trainer.
The classifier pool is seeded with randomly initialised classifiers, so
that none trains here (as in test_torch_eval_cli.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from mmvae_tpu_torch.bridge import export_jax_params
from mmvae_tpu_torch.cli import compute_likelihoods, dcca_train, train, validate
from mmvae_tpu_torch.cli.common import reload_model
from mmvae_tpu_torch.dcca.train import load_trunk_params
from mmvae_tpu_torch.eval import classifiers as Cl


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_pool(exp):
    torch.manual_seed(0)
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32)), ("fashion", (1, 28, 28))):
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), str(exp / "classifiers" / f"{key}.pt"))
    return str(exp)


def _config(tmp, name, **kw):
    with open(f"configs/msf/{name}.json") as f:
        raw = json.load(f)
    # an empty data dir inside tmp: the synthetic stand-in, nothing read outside
    raw.update(latent_dim=4, synthetic_n=64, batch_size=16, epochs=2, warmup=1,
               data_path=str(tmp / "data"))
    raw.update(kw)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(raw))
    return str(path)


ACC = sorted([f"acc_{i}_{j}" for i in range(3) for j in range(3) if i != j]
             + ["joint_coherence"])
POE = sorted([f"cond_acc_{m}" for m in range(3)] + [f"hmc_acc_rate_{m}" for m in range(3)])
LL = sorted([f"cond_likelihood_{i}_{j}" for i in range(3) for j in range(3) if i != j]
            + [f"conditional_likelihood_bis_{i}_{j}" for i in range(3) for j in range(3)
               if i != j]
            + [f"cond_lw_subset_{i}" for i in range(3)] + ["likelihood"])


def test_jnf_msf_cli_cpu(tmp_path, capsys):
    """jmvae_nf.json 2 epochs over warmup 1 with its analytics (the 3x3
    cond_samples grids and generate_001.png), validate --mcmc-steps 2 (6
    cross-coherences, the three-way joint coherence, cond_acc_m and
    hmc_acc_rate_m on the first test batch, no two-modality grids) and
    compute_likelihoods --bis (cond_lw_subset_m among JAX's names), all
    finite."""
    exp = _random_pool(tmp_path / "exp")
    run = train.main(["--config-path", _config(tmp_path, "jmvae_nf"), "--experiments-dir", exp,
                      "--device", "cpu"])
    files = os.listdir(run)
    assert {f"cond_samples_{r}x{o}_001.png" for r in range(3) for o in range(3)} <= set(files)
    assert "generate_001.png" in files
    m = validate.main(["--run-path", run, "--experiments-dir", exp, "--device", "cpu",
                       "--repeats", "1", "--skip-fid", "--mcmc-steps", "2"])
    assert sorted(m) == sorted(ACC + POE)
    assert all(np.isfinite(v["mean"]) and 0 <= v["mean"] <= 1 for v in m.values())
    assert not {"generate_val.png", "gen_from_cond_0.png"} & set(os.listdir(run))
    ll = compute_likelihoods.main(["--run-path", run, "--device", "cpu", "--repeats", "1",
                                   "--k", "20", "--batch-size-k", "10", "--max-batches", "1",
                                   "--bis"])
    assert sorted(ll) == LL
    assert all(np.isfinite(v["mean"]) for v in ll.values())


def test_dcca_then_jnf_dcca_and_mvae_cli_cpu(tmp_path):
    """dcca_train on the three views writes the three trunks and the first
    two views' linear CCA; jmvae_nf_dcca.json grafts the trunks into every
    first_encoder site and keeps the identity projection; mvae.json trains
    with subsampling and validates with its analytic PoE-subset accuracies."""
    exp = tmp_path / "exp"
    _random_pool(exp)
    art = dcca_train.main(["--dataset", "mnist_svhn_fashion", "--epochs", "1",
                           "--batch-size", "48", "--synthetic-n", "128", "--device", "cpu",
                           "--out", str(exp / "dcca"), "--data-path", str(tmp_path / "data")])
    assert art == str(exp / "dcca" / "mnist_svhn_fashion" / "dcca.npz")
    trunks = load_trunk_params(art)
    assert sorted(trunks) == ["encoders_0", "encoders_1", "encoders_2"]
    run = train.main(["--config-path", _config(tmp_path, "jmvae_nf_dcca", epochs=1,
                                               no_analytics=True),
                      "--experiments-dir", str(exp), "--device", "cpu"])
    model = reload_model(run, 16, "cpu")[1].model
    for i, d in enumerate(model.dcca_encoders):
        assert d is model.vaes[i].encoder.first_encoder
        np.testing.assert_array_equal(d.w.numpy(), np.eye(16, dtype=np.float32))
        got = dict(_leaves(export_jax_params(d.encoder)))
        for path, v in _leaves(trunks[f"encoders_{i}"]):
            np.testing.assert_array_equal(got[path], v)
    run = train.main(["--config-path", _config(tmp_path, "mvae", epochs=1, no_analytics=True),
                      "--experiments-dir", str(exp), "--device", "cpu"])
    m = validate.main(["--run-path", run, "--experiments-dir", str(exp), "--device", "cpu",
                       "--repeats", "1", "--skip-fid"])
    assert sorted(m) == sorted(ACC + [f"cond_acc_{i}" for i in range(3)])


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)
