"""The flows that no config of the repo selects, through the port's train
CLI on the CPU at a tiny size (latent 4, synthetic_n 64, B=16): a config
with "flow": "iaf" or "lin_nf" builds that flow for every unimodal VAE,
and trains: jmvae_nf.json for 2 epochs over the warmup boundary with IAF
(past warmup its density direction, the sequential solve at sign -1, runs
in every train and val step, and nothing else calls the solve) and with
LinearNF (no solve at all), each followed by compute_likelihoods --bis,
which calls no solve on either (it samples through the flows' sampling
direction); and mmvae_nf_synth.json with LinearNF for one epoch.
"""

import json
import math
import os

import pytest
import torch

from mmvae_tpu_torch.cli import compute_likelihoods
from mmvae_tpu_torch.cli import train as cli_train
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.flows import IAF, LinearNF
from mmvae_tpu_torch.flows import autoregressive
from mmvae_tpu_torch.models import registry

CASES = [("jmvae_nf.json", "iaf", 2), ("jmvae_nf.json", "lin_nf", 2),
         ("mmvae_nf_synth.json", "lin_nf", 1)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("config,flow,epochs", CASES, ids=[f"{c[:-5]}-{f}" for c, f, _ in CASES])
def test_cli_epoch_with_flow(tmp_path, monkeypatch, config, flow, epochs):
    with open(os.path.join("configs", "mnist_svhn", config)) as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(flow=flow, latent_dim=4, synthetic_n=64, batch_size=16, epochs=epochs,
               warmup=epochs, skip_warmup=False, no_analytics=True,
               data_path=str(tmp_path / "data"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))

    bundle = registry.build(ExperimentConfig.from_json(str(path)))
    assert all(isinstance(v.flow, IAF if flow == "iaf" else LinearNF)
               for v in bundle.model.vaes)
    signs = []
    solve = autoregressive.ar_solve

    def counting(x, ws, bs, sign, s_bound=0.0):
        signs.append(sign)
        return solve(x, ws, bs, sign, s_bound)

    monkeypatch.setattr(autoregressive, "ar_solve", counting)
    run_path = cli_train.main(["--config-path", str(path), "--experiments-dir",
                               str(tmp_path / "exp"), "--device", "cpu"])
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert len(losses["train_loss"]) == epochs
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        assert all(json.loads(line)["train_nan_skipped"] == 0.0 for line in f)
    if flow == "iaf":
        # 2 modalities x 2 blocks per train step and val batch of epoch 2
        assert signs and set(signs) == {-1} and len(signs) % 4 == 0
    else:
        assert signs == []
    if config == "jmvae_nf.json":
        # the likelihoods sample through the flows' sampling direction
        # (IAF's parallel pass, LinearNF's map): no solve
        del signs[:]
        summary = compute_likelihoods.main(["--run-path", run_path, "--device", "cpu", "--k", "6",
                                            "--batch-size-k", "3", "--repeats", "1",
                                            "--batch-size", "16", "--max-batches", "1", "--bis"])
        assert len(summary) == 5 and all(math.isfinite(v["mean"]) for v in summary.values())
        assert signs == []
