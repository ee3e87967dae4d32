"""The port's evaluation pipeline through its CLIs on the CPU, at a tiny
size (synthetic_n=64, batch 16, latent 4): the train CLI on the published
MNIST-SVHN configs with their own "no_analytics": false (grids written),
then `validate` (coherence and classifier-feature FID) and
`compute_likelihoods --bis`, for MMVAE-NF, the flagship MMVAE and JMVAE-NF.

The classifier pool is seeded with randomly initialised classifiers, so
that no classifier trains here. The metric names are held to the JAX
CLIs' on the same JMVAE-NF run (its weights and classifiers exported to
the JAX package's checkpoint format).
"""

import json
import math
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from mmvae_tpu.cli import compute_likelihoods as jax_ll
from mmvae_tpu.cli import validate as jax_validate
from mmvae_tpu.eval import classifiers as JCl
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu.train import checkpoints as jckpt
from mmvae_tpu_torch.bridge import export_jax_params, export_jax_variables
from mmvae_tpu_torch.cli import compute_likelihoods, train, validate
from mmvae_tpu_torch.cli.common import reload_model
from mmvae_tpu_torch.eval import classifiers as Cl

FAMILIES = {"mmvae_nf": "configs/mnist_svhn/mmvae_nf_synth.json",
            "mmvae": "configs/mnist_svhn/mmvae_synth.json",
            "jnf": "configs/mnist_svhn/jmvae_nf.json"}
VALIDATE = ["--repeats", "1", "--fid-encoder", "classifier", "--batch-size", "16"]
LIKELIHOODS = ["--k", "6", "--batch-size-k", "3", "--repeats", "2", "--batch-size", "16", "--bis"]
VALIDATE_KEYS = ["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence"]
COND_KEYS = ["cond_likelihood_0_1", "cond_likelihood_1_0"]
LL_KEYS = {"mmvae_nf": COND_KEYS,
           "mmvae": sorted(COND_KEYS + ["likelihood", "conditional_likelihood_bis_0_1",
                                        "conditional_likelihood_bis_1_0"])}
LL_KEYS["jnf"] = LL_KEYS["mmvae"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(experiments dir, {family: run dir}): one epoch of each family
    through the port's train CLI, and a classifier pool of random nets."""
    tmp = tmp_path_factory.mktemp("eval_cli")
    exp = tmp / "exp"
    torch.manual_seed(0)
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32))):
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), str(exp / "classifiers" / f"{key}.pt"))
    out = {}
    for fam, path in FAMILIES.items():
        with open(path) as f:
            raw = json.load(f)
        assert raw["no_analytics"] is False
        # an empty data dir inside tmp: the synthetic stand-in, nothing read outside
        raw.update(latent_dim=4, synthetic_n=64, batch_size=16, epochs=1, K=3,
                   data_path=str(tmp / "data"))
        if fam == "jnf":  # the post-warmup phase, where the flows train
            raw.update(warmup=1, skip_warmup=False)
        cfg = tmp / f"{fam}.json"
        cfg.write_text(json.dumps(raw))
        out[fam] = train.main(["--config-path", str(cfg), "--experiments-dir", str(exp),
                               "--device", "cpu"])
    return str(exp), out


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return struct.unpack(">II", head[16:24])


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_train_cli_writes_analytics_grids(runs, fam):
    """Epoch 1's grids: per ordered pair 8 val rows and their 64
    conditional samples (9 grid rows of 8, padding 2), and 32 prior samples
    per modality (8 grid rows)."""
    run = runs[1][fam]
    for r in (0, 1):
        for o in (0, 1):
            side = 28 if r == o == 0 else 32  # MNIST's 28x28, or padded to SVHN's 32x32
            size = (8 * (side + 2) + 2, 9 * (side + 2) + 2)
            assert _png_size(os.path.join(run, f"cond_samples_{r}x{o}_001.png")) == size
    assert _png_size(os.path.join(run, "generate_001.png")) == (274, 274)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_validate_cli(runs, fam):
    exp, run = runs[0], runs[1][fam]
    summary = validate.main(["--run-path", run, "--experiments-dir", exp, "--device", "cpu",
                             *VALIDATE])
    assert sorted(summary) == VALIDATE_KEYS
    for k in ("acc_0_1", "acc_1_0", "joint_coherence"):
        assert 0.0 <= summary[k]["mean"] <= 1.0
    assert all(math.isfinite(summary[k]["mean"]) and summary[k]["mean"] > 0
               for k in ("fid_0", "fid_1"))
    with open(os.path.join(run, "metrics.json")) as f:
        assert json.load(f) == summary
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert sum("val/acc_0_1" in json.loads(line) for line in f) == 1
    for name in ("generate_val.png", "gen_from_cond_0.png", "gen_from_cond_1.png"):
        assert _png_size(os.path.join(run, name))[0] == 274
    assert sorted(os.listdir(os.path.join(exp, "classifiers"))) == ["mnist.pt", "svhn.pt"]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_compute_likelihoods_cli(runs, fam, capsys):
    run = runs[1][fam]
    summary = compute_likelihoods.main(["--run-path", run, "--device", "cpu", *LIKELIHOODS])
    assert sorted(summary) == LL_KEYS[fam]
    assert all(math.isfinite(v["mean"]) and v["mean"] < 0 for v in summary.values())
    assert ("bis protocol unavailable" in capsys.readouterr().out) == (fam == "mmvae_nf")
    with open(os.path.join(run, "likelihoods.json")) as f:
        assert json.load(f) == summary


def test_likelihood_chunk_matches_per_batch(runs):
    """Test batches grouped 2 at a time (and the ragged last one alone) give
    the values of one call per batch: every batch draws from its own
    generator. Float32, so to 1e-6 (other matrix shapes per call)."""
    run = runs[1]["jnf"]
    common = ["--run-path", run, "--device", "cpu", *LIKELIHOODS]
    _, test_l, _ = reload_model(run, 16, "cpu")[2]
    assert len(test_l) >= 3 and len(test_l.dataset) % 16  # two full batches and a ragged one
    per_batch = compute_likelihoods.main(common + ["--steps-per-dispatch", "1"])
    chunked = compute_likelihoods.main(common + ["--steps-per-dispatch", "2"])
    for k in per_batch:
        assert chunked[k]["mean"] == pytest.approx(per_batch[k]["mean"], rel=1e-6), k
        assert chunked[k]["std"] == pytest.approx(per_batch[k]["std"], rel=1e-3, abs=1e-4), k


def test_metric_names_match_the_jax_clis(runs, tmp_path, monkeypatch):
    """The JAX CLIs on the JMVAE-NF run (its weights as model.msgpack, the
    classifier pool as msgpack) report the metrics that the port's report
    in test_validate_cli and test_compute_likelihoods_cli."""
    exp, run = runs[0], runs[1]["jnf"]
    jrun, jexp = tmp_path / "run", tmp_path / "exp"
    os.makedirs(jrun)
    shutil.copy(os.path.join(run, "args.json"), jrun / "args.json")
    model = reload_model(run, 16, "cpu")[1].model
    jckpt.save_bytes({"params": export_jax_params(model)}, str(jrun / "model.msgpack"))
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32))):
        clf = Cl.load_classifier(Cl.ARCHS[key](in_shape=shape), os.path.join(exp, "classifiers",
                                                                            f"{key}.pt"), "cpu")
        JCl.save_classifier(export_jax_variables(clf), str(jexp / "classifiers" / f"{key}.msgpack"))
    monkeypatch.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # names only: the plain solve
    want_v = jax_validate.main(["--run-path", str(jrun), "--experiments-dir", str(jexp),
                                *VALIDATE])
    want_l = jax_ll.main(["--run-path", str(jrun), *LIKELIHOODS, "--repeats", "1",
                          "--max-batches", "1"])
    assert sorted(want_v) == VALIDATE_KEYS and sorted(want_l) == LL_KEYS["jnf"]
    assert all(np.isfinite(v["mean"]) for v in want_l.values())


def test_unported_options_and_missing_card_raise(runs, monkeypatch, tmp_path):
    """validate's default encoder, the InceptionV3 at its seeded random init,
    gives a finite FID per direction (to keep the CPU run short, the net
    is fed at 75 px, not 299, and the distance reads the first 64 of the
    2048 features, whose 2048 x 2048 sqrtm takes 40 s a direction here:
    tests/test_torch_fid.py holds the net at 75 px to JAX's, and
    test_torch_eval.py the distance); --fid-weights refuses a missing file and a file whose name's
    hash its bytes do not match; --mcmc-steps is taken (read by the
    trimodal PoE models only); and without a card the CLIs refuse cuda."""
    from mmvae_tpu_torch.eval import fid

    exp, run = runs[0], runs[1]["jnf"]
    base = ["--run-path", run, "--experiments-dir", exp, "--device", "cpu"]
    monkeypatch.setattr(fid, "fid_preprocess", lambda x: torch.nn.functional.interpolate(
        torch.cat([x] * (3 // x.shape[1]), 1), size=(75, 75), mode="bilinear"))
    frechet = fid.calculate_frechet_distance
    monkeypatch.setattr(fid, "calculate_frechet_distance", lambda m1, s1, m2, s2: frechet(
        m1[:64], s1[:64, :64], m2[:64], s2[:64, :64]))
    got = validate.main(base + ["--repeats", "1", "--batch-size", "16", "--mcmc-steps", "10"])
    assert sorted(got) == VALIDATE_KEYS
    assert all(math.isfinite(got[k]["mean"]) for k in ("fid_0", "fid_1"))
    with pytest.raises(FileNotFoundError):
        validate.main(base + ["--fid-weights", str(tmp_path / "absent.pth")])
    bad = tmp_path / "pt_inception-2015-12-05-deadbeef.pth"
    bad.write_bytes(b"not the weights")
    with pytest.raises(ValueError, match="hash mismatch"):
        validate.main(base + ["--fid-weights", str(bad)])
    if torch.cuda.is_available():
        return
    for cli in (validate, compute_likelihoods):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--run-path", run, "--skip-fid"] if cli is validate else ["--run-path", run])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_eval_library_defaults_to_the_card(runs):
    """The library's reload and classifier functions run on cuda unless the
    caller asks for the CPU, and raise where there is no card."""
    from mmvae_tpu_torch.cli.common import get_or_train_classifiers

    exp, run = runs[0], runs[1]["jnf"]
    _, bundle, loaders = reload_model(run, 16, "cpu")
    pool = os.path.join(exp, "classifiers", "mnist.pt")
    calls = [lambda: reload_model(run, 16),
             lambda: Cl.load_classifier(Cl.MnistClassifier(), pool),
             lambda: Cl.train_classifier(Cl.MnistClassifier(), np.zeros((4, 1, 28, 28), np.float32),
                                         np.zeros(4, np.int64), seed=0),
             lambda: get_or_train_classifiers(bundle, loaders, exp, 0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
