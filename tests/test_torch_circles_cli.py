"""The circles-squares pipeline through the port's CLIs on the CPU, at the
JAX package's own small data (dataset_size 60, n_repeat 4, as JAX
tests/test_cli.py) and batch 16, at the configs' published widths
(latent 2, K=10): the train CLI on mmvae.json and jmvae_nf.json with their
epoch-1 analytics (grids and the radius analytics), `validate` on both
(coherence, classifier-feature FID, `neg_entropy` with its histogram, and
for JMVAE-NF the product-of-posteriors figure from HMC),
`compute_likelihoods --bis` on JMVAE-NF, and `dcca_train --dataset
circles_squares` with the DCCA-built model grafting its artifact.

The empty/full classifier pool is one random net, so that none trains. The
metric names are the JAX CLIs': validate's are those of the MNIST-SVHN
runs (held to the JAX CLI in test_torch_eval_cli.py) plus `neg_entropy`,
and the analytics print `rayon_corr_01`/`_10`, the names of JAX's
`conditional_rdist_metrics` and `analyse_rayons`, which
test_torch_circles_eval.py holds to the port's.
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

DATA = dict(dataset_size=60, n_repeat=4, batch_size=16)
VALIDATE_KEYS = ["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence", "neg_entropy"]
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
    """(experiments dir, {name: run dir}): mmvae.json for one
    epoch, jmvae_nf.json for 2 with warmup 1, through the train CLI."""
    tmp = tmp_path_factory.mktemp("circles_cli")
    exp = tmp / "exp"
    torch.manual_seed(0)
    Cl.save_classifier(Cl.ARCHS["empty_full"](in_shape=(1, 32, 32)),
                       str(exp / "classifiers" / "empty_full.pt"))
    out = {}
    for name, epochs in (("mmvae", 1), ("jmvae_nf", 2)):
        with open(f"configs/circles/{name}.json") as f:
            raw = json.load(f)
        assert raw["no_analytics"] is False and raw["latent_dim"] == 2
        raw.update(DATA, epochs=epochs, data_path=str(tmp / "data"))
        if name == "jmvae_nf":
            raw.update(warmup=1)
        cfg = tmp / f"{name}.json"
        cfg.write_text(json.dumps(raw))
        out[name] = train.main(["--config-path", str(cfg), "--experiments-dir", str(exp),
                                "--device", "cpu"])
    return str(exp), out


def test_train_cli_with_radius_analytics(runs):
    """Finite losses, the epoch-1 grids and the radius histograms (with
    their JSON) of the first 64 val rows, here all 36."""
    _, out = runs
    for name, run in out.items():
        with open(os.path.join(run, "losses.json")) as f:
            losses = json.load(f)
        assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
        files = set(os.listdir(run))
        grids = {f"cond_samples_{r}x{o}_001.png" for r in (0, 1) for o in (0, 1)}
        hists = {f"hist_rayon_{ij}_001.png{ext}" for ij in ("01", "10") for ext in ("", ".json")}
        assert grids | hists | {"generate_001.png", "model.pt"} <= files, sorted(files)
        with open(os.path.join(run, "hist_rayon_01_001.png.json")) as f:
            assert json.load(f)["n"] == 36  # min(64, the 36 val pairs)


def test_train_cli_prints_the_rayon_metrics(tmp_path, capsys):
    """The analytics print rayon_corr_01 and rayon_corr_10, as the JAX CLI."""
    with open("configs/circles/mmvae.json") as f:
        raw = json.load(f)
    raw.update(DATA, epochs=1, K=2, data_path=str(tmp_path / "data"))
    (tmp_path / "c.json").write_text(json.dumps(raw))
    train.main(["--config-path", str(tmp_path / "c.json"), "--experiments-dir",
                str(tmp_path / "exp"), "--device", "cpu"])
    line = [l for l in capsys.readouterr().out.splitlines() if "rayon metrics epoch 1" in l]
    assert len(line) == 1
    assert "'rayon_corr_01'" in line[0] and "'rayon_corr_10'" in line[0]


@pytest.mark.parametrize("name", ["mmvae", "jmvae_nf"])
def test_validate_cli(runs, name):
    """Coherence, FID and neg_entropy (negative, as sum p log p), its
    histogram on repeat 0, and for JMVAE-NF the PoE figure."""
    exp, out = runs
    summary = validate.main(["--run-path", out[name], "--experiments-dir", exp, "--repeats", "1",
                             "--fid-encoder", "classifier", "--device", "cpu"])
    assert sorted(summary) == VALIDATE_KEYS
    assert all(math.isfinite(v["mean"]) for v in summary.values())
    assert summary["neg_entropy"]["mean"] <= 0
    files = set(os.listdir(out[name]))
    assert {"metrics.json", "hist_000.png", "hist_000.png.json", "generate_val.png"} <= files
    poe = {"product_of_posteriors.png", "product_of_posteriors.png.json"}
    assert (poe <= files) == (name == "jmvae_nf")
    if name == "jmvae_nf":
        with open(os.path.join(out[name], "product_of_posteriors.png.json")) as f:
            spec = json.load(f)
        assert len(spec["panels"]) == 2 and len(spec["panels"][0]) == 4
        assert all(len(s["points"]) == 30 for s in spec["panels"][1][0]["series"])


def test_validate_per_batch_neg_entropy(runs):
    """--n-data: the per-batch loop scores neg_entropy on the first batch
    alone (its value, not a share of the rows of all batches)."""
    exp, out = runs
    summary = validate.main(["--run-path", out["mmvae"], "--experiments-dir", exp,
                             "--repeats", "1", "--skip-fid", "--n-data", "8", "--batch-size", "16",
                             "--device", "cpu"])
    assert sorted(summary) == ["acc_0_1", "acc_1_0", "joint_coherence", "neg_entropy"]
    assert -math.log(10) <= summary["neg_entropy"]["mean"] <= 0


def test_compute_likelihoods_cli(runs):
    _, out = runs
    summary = compute_likelihoods.main(["--run-path", out["jmvae_nf"], "--k", "6",
                                        "--batch-size-k", "3", "--repeats", "1", "--batch-size",
                                        "16", "--max-batches", "1", "--bis", "--device", "cpu"])
    assert sorted(summary) == LL_KEYS
    assert all(math.isfinite(v["mean"]) for v in summary.values())
    assert os.path.exists(os.path.join(out["jmvae_nf"], "likelihoods.json"))


def test_dcca_train_and_graft(tmp_path):
    """dcca_train --dataset circles_squares (two one-channel SVHN trunks,
    outdim 16) writes the artifact, and jmvae_nf_dcca.json with dcca on
    builds TwoStepsEncoders of it."""
    out = dcca_train.main(["--dataset", "circles_squares", "--epochs", "1", "--batch-size", "800",
                           "--out", str(tmp_path / "dcca"), "--device", "cpu"])
    with np.load(out) as npz:
        assert npz["m0"].shape == (16,) and npz["w1"].shape == (16, 16)
    cfg = ExperimentConfig.from_json("configs/circles/jmvae_nf_dcca.json")
    assert cfg.dcca is False  # the reference's quirk: this config builds no trunks
    cfg.dcca, cfg.extra["dcca_path"] = True, out
    bundle = registry.build(cfg)
    registry.graft_dcca_params(bundle.model, out)
    enc = bundle.model.vaes[0].encoder
    assert enc.num_hidden == 3 and enc.first_encoder is bundle.model.dcca_encoders[0]
    with np.load(out) as npz:
        np.testing.assert_array_equal(enc.first_encoder.m.numpy(), npz["m0"].astype(np.float32))
