"""The flagship MMVAE-DReG train CLI of the port on the CPU:
mmvae_synth.json and its bf16 twin for one epoch at a tiny size. Split
from test_torch_mmvae.py so that the test workers, which take whole files,
run these CLI runs beside its parity tests.
"""

import json
import math
import os

import pytest
import torch

from mmvae_tpu_torch.cli import train as cli_train

CONFIG = "configs/mnist_svhn/mmvae_synth.json"
CONFIG_BF16 = "configs/mnist_svhn/mmvae_synth_bf16.json"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores (a CLI epoch here took 50 times as long
    beside five other workers as alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("config", [CONFIG, CONFIG_BF16])
def test_cli_one_epoch_cpu(tmp_path, capsys, config):
    """mmvae_synth.json (and its bf16 twin) through the port's CLI on the
    CPU at a tiny size: finite losses, no skipped step, the policy in the
    startup line."""
    with open(config) as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(synthetic_n=64, batch_size=16, K=3, epochs=1, no_analytics=True,
               data_path=str(tmp_path / "data"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    run_path = cli_train.main(["--config-path", str(path), "--experiments-dir",
                               str(tmp_path / "exp"), "--device", "cpu"])
    out = capsys.readouterr().out
    dtype = raw.get("compute_dtype", "float32")
    assert f"objective: m_dreg_looser on cpu (compute {dtype}" in out
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["train_nan_skipped"] == 0.0
    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    assert all(t.dtype == torch.float32 for t in state.values())
