"""Tests of the port that need a CUDA card (marker `cuda`; each skips with a
reason where there is none). This file imports no JAX, so it runs on a
machine that has PyTorch with CUDA and nothing of the JAX stack:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The Hopper ar_solve kernel is held against the plain PyTorch version on the
card at the main path's widths (D=20, three hidden layers of 128, real MADE
masks), float32 with TF32 off: the same arithmetic in another summation
order, so rtol/atol 1e-4.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from mmvae_tpu_torch.cli import train as cli_train
from mmvae_tpu_torch.data import get_dataloaders
from mmvae_tpu_torch.flows import MAF, build_masks
from mmvae_tpu_torch.ops import ar_flow

D, H, N_HIDDEN = 20, 128, 3
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(dev, seed=5, d=D, h=H, n_hidden=N_HIDDEN):
    rng = np.random.default_rng(seed)
    masks, out_mask = build_masks(d, (h,) * n_hidden)
    masks = masks + [np.concatenate([out_mask, out_mask], axis=1)]
    ws = [torch.tensor(rng.standard_normal(m.shape) / np.sqrt(m.shape[0]) * m,
                       dtype=torch.float32, device=dev) for m in masks]
    bs = [torch.tensor(rng.standard_normal(m.shape[1]) * 0.1, dtype=torch.float32, device=dev)
          for m in masks]
    return ws, bs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 37])  # the main path's rows; a ragged last tile
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_kernel_matches_plain(card, n, sign, s_bound):
    ws, bs = _weights(card)
    x = torch.randn(n, D, generator=torch.Generator().manual_seed(6)).to(card)
    before = ar_flow.ar_solve.launches
    y, ld = ar_flow.kernel_forward(x, ws, bs, sign, s_bound)
    assert ar_flow.ar_solve.launches == before + 1
    y_ref, ld_ref = ar_flow.unrolled_solve(x, ws, bs, sign, s_bound)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(ld, ld_ref, **TOL)


@pytest.mark.cuda
def test_function_on_card_grads_match_plain(card):
    """The autograd Function launches the kernel forward once and its
    backward (autograd through the plain solve) gives the plain version's
    gradients for x, every weight and every bias; leading dims (K, B, D)."""
    ws, bs = _weights(card, seed=7)
    x = torch.randn(2, 64, D, generator=torch.Generator().manual_seed(8)).to(card)
    runs = {}
    for name in ("fused", "plain"):
        xi = x.clone().requires_grad_(True)
        params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
        solve = ar_flow.ar_solve if name == "fused" else ar_flow.unrolled_solve
        before = ar_flow.ar_solve.launches
        y, ld = solve(xi, params[:len(ws)], params[len(ws):], 1, 0.0)
        assert ar_flow.ar_solve.launches == before + (name == "fused")
        (y.square().sum() + ld.sum()).backward()
        runs[name] = [y, ld, xi.grad, *(p.grad for p in params)]
    for a, b in zip(runs["fused"], runs["plain"]):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_maf_inverse_on_card_uses_kernel(card):
    """MAF's sequential direction goes through the kernel once per block."""
    fused = MAF(features=D, n_made_blocks=2).to(card)
    plain = MAF(features=D, n_made_blocks=2, use_fused=False).to(card)
    plain.load_state_dict(fused.state_dict())
    z0 = torch.randn(128, D, generator=torch.Generator().manual_seed(9)).to(card)
    before = ar_flow.ar_solve.launches
    with torch.no_grad():
        got, want = fused.inverse(z0), plain.inverse(z0)
    assert ar_flow.ar_solve.launches == before + 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(card):
    ws, bs = _weights(card)
    x = torch.randn(16, D, device=card)
    with pytest.raises(ValueError, match="float32"):
        ar_flow.kernel_forward(x.double(), ws, bs, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ar_flow.kernel_forward(torch.randn(D, 16, device=card).t(), ws, bs, 1)
    big_ws, big_bs = _weights(card, h=512, n_hidden=2)  # 512x512 weights overflow shared memory
    with pytest.raises(ValueError, match="shared memory"):
        ar_flow.kernel_forward(x, big_ws, big_bs, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.kernel_forward(x.cpu(), [w.cpu() for w in ws], [b.cpu() for b in bs], 1)


@pytest.mark.cuda
def test_cli_epoch_on_card(card, tmp_path):
    """One small MMVAE-NF epoch through the CLI on cuda: TF32 is switched
    off for matmuls and cuDNN, every parameter lies on the card, and the
    kernel runs 4 times (2 modalities x 2 MAF blocks) per train step and
    per val batch."""
    with open("configs/mnist_svhn/mmvae_nf_synth.json") as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(latent_dim=4, synthetic_n=64, batch_size=16, epochs=1, no_analytics=True,
               data_path=str(tmp_path / "data"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    train, _, val = get_dataloaders("mnist_svhn", batch_size=16, synthetic_n=64,
                                    data_path=raw["data_path"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    ar_flow.ar_solve.launches = 0
    run_path = cli_train.main(["--config-path", str(cfg_path), "--experiments-dir",
                               str(tmp_path / "exp"), "--device", "cuda"])
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert ar_flow.ar_solve.launches == 4 * (train.num_examples // 16 + val.num_examples // 16)
    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    assert all(t.is_cuda for t in state.values())
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
