"""The MMVAE-NF train CLI of the port on the CPU: a 1-epoch `--device cpu`
run, the epoch-1 analytics grids of the published setting
("no_analytics": false), and what happens when writing a grid or sampling
fails. Split from test_torch_slice.py so that the test workers, which take
whole files, run these CLI runs beside its parity tests.
"""

import json
import math
import os

import pytest
import torch

from mmvae_tpu_torch.cli import train as cli_train

CONFIG = "configs/mnist_svhn/mmvae_nf_synth.json"
LATENT = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores (a CLI epoch here took 50 times as long
    beside five other workers as alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


def test_cli_refuses_analytics(tmp_path, capsys):
    """The CLI no longer refuses "no_analytics": false, the published
    configs' setting: it trains and writes the epoch-1 grids."""
    run_path = cli_train.main(["--config-path", _write_config(tmp_path, no_analytics=False),
                               "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"])
    assert "[analytics] skipped" not in capsys.readouterr().out
    grids = sorted(f for f in os.listdir(run_path) if f.endswith(".png"))
    assert grids == [f"cond_samples_{r}x{o}_001.png" for r in (0, 1) for o in (0, 1)] + \
        ["generate_001.png"]


@pytest.mark.parametrize("where", ["writing", "sampling"])
def test_cli_analytics_failures(tmp_path, capsys, monkeypatch, where):
    """A grid that cannot be written is reported and training goes on; a
    failure of the sampling (a kernel launch among them) stops the run."""
    import mmvae_tpu_torch.eval.generation as G
    import mmvae_tpu_torch.vis as V

    def fail(*args, **kwargs):
        raise (OSError if where == "writing" else RuntimeError)(f"injected {where} failure")

    monkeypatch.setattr(*((V, "save_image") if where == "writing" else
                          (G, "sample_from_conditional")), fail)
    argv = ["--config-path", _write_config(tmp_path, no_analytics=False),
            "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"]
    if where == "sampling":
        with pytest.raises(RuntimeError, match="injected sampling failure"):
            cli_train.main(argv)
        return
    run_path = cli_train.main(argv)
    assert "[analytics] skipped at epoch 1: OSError('injected writing failure')" in \
        capsys.readouterr().out
    assert os.path.exists(os.path.join(run_path, "model.pt"))
