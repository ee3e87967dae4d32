"""The ResNet datasets through the port's CLIs on the CPU, at the configs'
published widths and small synthetic data (batch 16): the train CLI on
MedMNIST's jnf_sbound.json (latent 16, s_bound 8; 2 epochs over the warmup
boundary), chest-SVHN's jmvae_exact_synth.json (its linear warmup, 1 epoch)
and CelebA's jmvae_nf.json (latent 64, the Bernoulli attributes; 2
epochs), each with its epoch-1 grids; `validate` on the three (CelebA's
attribute metrics, the others' coherences, classifier-feature FID);
`compute_likelihoods --bis` on MedMNIST and CelebA; and `dcca_train` on
the three datasets, MedMNIST's JMVAE-NF-DCCA grafting its artifact.

The classifier pool is random nets, so that none trains. The metric names
are the JAX CLIs': MedMNIST's and chest-SVHN's as MNIST-SVHN's, CelebA's
those of JAX's `celeba_attribute_metrics`.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from mmvae_tpu_torch.cli import compute_likelihoods, dcca_train, train, validate
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.models import registry

RUNS = {"medmnist": ("configs/medmnist/jnf_sbound.json", dict(epochs=2, warmup=1, synthetic_n=40)),
        "chest_svhn": ("configs/chest_svhn/jmvae_exact_synth.json", dict(epochs=1, synthetic_n=40)),
        "celeba": ("configs/celeba/jmvae_nf.json", dict(epochs=2, warmup=1, synthetic_n=64))}
POOL = {"pneumonia": (1, 28, 28), "blood": (3, 28, 28), "svhn": (3, 32, 32),
        "celeba_img": (3, 64, 64), "celeba_attr": (1, 1, 40)}
COHERENCE = ["acc_0_1", "acc_1_0", "joint_coherence"]
ATTRIBUTES = ["accuracy1", "accuracy2", "joint_coherence"]
LL_KEYS = ["cond_likelihood_0_1", "cond_likelihood_1_0", "conditional_likelihood_bis_0_1",
           "conditional_likelihood_bis_1_0", "likelihood"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(experiments dir, data dir, {dataset: run dir}) of the three configs
    through the train CLI."""
    tmp = tmp_path_factory.mktemp("resnet_cli")
    exp = tmp / "exp"
    torch.manual_seed(0)
    for key, shape in POOL.items():
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), str(exp / "classifiers" / f"{key}.pt"))
    out = {}
    for ds, (path, kw) in RUNS.items():
        with open(path) as f:
            raw = json.load(f)
        assert raw["no_analytics"] is False
        raw.update(kw, batch_size=16, data_path=str(tmp / "data"))
        cfg = tmp / f"{ds}.json"
        cfg.write_text(json.dumps(raw))
        out[ds] = train.main(["--config-path", str(cfg), "--experiments-dir", str(exp),
                              "--device", "cpu"])
    return str(exp), str(tmp / "data"), out


@pytest.mark.parametrize("ds", list(RUNS))
def test_train_cli(runs, ds):
    """Finite losses over every epoch, the epoch-1 grids and the checkpoint,
    and the run's args: the model and dataset of the config."""
    _, _, out = runs
    run = out[ds]
    with open(os.path.join(run, "losses.json")) as f:
        losses = json.load(f)
    assert len(losses["train_loss"]) == RUNS[ds][1]["epochs"]
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    grids = {f"cond_samples_{r}x{o}_001.png" for r in (0, 1) for o in (0, 1)}
    assert grids | {"generate_001.png", "model.pt"} <= set(os.listdir(run))
    cfg = ExperimentConfig.from_json(os.path.join(run, "args.json"))
    assert registry.build(cfg).dataset == ds


@pytest.mark.parametrize("ds", list(RUNS))
def test_validate_cli(runs, ds):
    """CelebA's attribute metrics (the per-batch loop at --n-data all) or
    the coherences, each in [0, 1], and finite FIDs on the classifiers'
    features; the grids."""
    exp, _, out = runs
    summary = validate.main(["--run-path", out[ds], "--experiments-dir", exp, "--repeats", "1",
                             "--fid-encoder", "classifier", "--device", "cpu"])
    names = ATTRIBUTES if ds == "celeba" else COHERENCE
    assert sorted(summary) == sorted(names + ["fid_0", "fid_1"])
    assert all(0.0 <= summary[k]["mean"] <= 1.0 for k in names)
    assert all(math.isfinite(v["mean"]) for v in summary.values())
    assert {"metrics.json", "generate_val.png", "gen_from_cond_0.png"} <= set(os.listdir(out[ds]))


@pytest.mark.parametrize("ds", ["medmnist", "celeba"])
def test_compute_likelihoods_cli(runs, ds):
    """--bis on one test batch: finite values under JAX's metric names, the
    attributes' Bernoulli log-density on CelebA."""
    _, _, out = runs
    summary = compute_likelihoods.main(["--run-path", out[ds], "--k", "6", "--batch-size-k", "3",
                                        "--repeats", "1", "--batch-size", "16", "--max-batches",
                                        "1", "--bis", "--device", "cpu"])
    assert sorted(summary) == LL_KEYS
    assert all(math.isfinite(v["mean"]) for v in summary.values())


@pytest.mark.parametrize("ds,outdim", [("medmnist", 16), ("chest_svhn", 16), ("celeba", 40)])
def test_dcca_train_cli(runs, tmp_path, ds, outdim):
    """dcca_train --dataset: the ResNet (and SVHN or MLP) trunks, one epoch,
    the artifact at the dataset's trunk width; MedMNIST's
    jmvae_nf_dcca.json builds on it and grafts its projections."""
    _, data, _ = runs
    path = dcca_train.main(["--dataset", ds, "--epochs", "1", "--batch-size", "32",
                            "--synthetic-n", "64", "--data-path", data, "--out",
                            str(tmp_path / "dcca"), "--device", "cpu"])
    with np.load(path) as npz:
        assert npz["m0"].shape == (outdim,) and npz["w1"].shape == (outdim, outdim)
        assert all(np.isfinite(npz[k]).all() for k in ("m0", "m1", "w0", "w1"))
        m1 = npz["m1"]
    if ds != "medmnist":
        return
    cfg = ExperimentConfig.from_json("configs/medmnist/jmvae_nf_dcca.json")
    assert cfg.dcca
    cfg.extra["dcca_path"] = path
    bundle = registry.build(cfg)
    registry.graft_dcca_params(bundle.model, path)
    enc = bundle.model.vaes[1].encoder
    assert enc.first_encoder is bundle.model.dcca_encoders[1]
    np.testing.assert_array_equal(enc.first_encoder.m.numpy(), m1.astype(np.float32))
