"""Tests of the port that need a CUDA card (marker `cuda`; each skips with a
reason where there is none). This file imports no JAX, so it runs on a
machine that has PyTorch with CUDA and nothing of the JAX stack:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The Hopper ar_solve kernels are held against the plain PyTorch versions on
the card at the main path's widths (D=20, three hidden layers of 128, real
MADE masks), and the general pair at widths the 128-wide pair refuses,
float32 with TF32 off: the forward against `unrolled_solve`,
the backward (the gradients of x, every weight and every bias) against
autograd through `unrolled_solve`. The same arithmetic in another summation
order, so rtol/atol 1e-4. At MADE's zero initial biases the tape holds the
ReLU ties' exact zeros, where the backward takes JAX's slope 1/2, and two
backward calls give bitwise equal gradients.

The flagship MMVAE-DReG path, which launches no kernel of the port: a
DReG-looser step on the card against the float64 CPU step, the bf16
policy's CUDA forms of Linear and the convs against their CPU forms, and
one small epoch of the flagship through the CLI.

JMVAE-NF and its DCCA pretraining: a post-warmup JNF step on the card and
its kernel launches, the Cholesky CCA loss and the singular-value
Function's backward on the card against float64 on the CPU, and the DCCA
Solver's RMSprop step on the card against the CPU.

JMVAE-NF with "flow": "iaf": a post-warmup step, whose density direction
runs both kernels at sign -1, against the float64 CPU step on the card
step's ReLU branches.

TELBO-NF, MVAE and MoE-PoE: a post-warmup TELBO-NF step, whose unimodal
VAE forwards run both kernels under autograd, against the same step through
the plain solve on the card; an MVAE and a MoE-PoE step, which launch no
kernel.

Evaluation: the forward kernel under no_grad at eval's row counts (no
tape, one launch per call), and a tiny validate and compute_likelihoods on
cuda with their launch counts.

The k-means, the mixture EM, PRD and the Bernoulli family on the card in
float64 against the CPU in float64 from the same inputs and starts, and the
ms_small augmentation pipeline (train, generate_joint, use_gen retrain,
validate --prd) at a tiny size on cuda with its launch counts.

The last slice: the InceptionV3 FID net on the card in float32 against
float64 on the CPU at randomised BatchNorm statistics (rtol 1e-3, atol
1e-4, tests/test_fid_parity.py's), the linear probes on the card against
the CPU (LinearSVC's minimiser to 1e-9 of the largest coefficient, the SGD
probe's accuracy exactly: the same shuffles, float64 on both), and the K
split over two gloo ranks on the card (chip_smoke's ksplit_parity at B=8).
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.cli import compute_likelihoods, generate_joint, validate
from mmvae_tpu_torch.cli import train as cli_train
from mmvae_tpu_torch.cli.common import reload_model
from mmvae_tpu_torch.core import distributions as Dist
from mmvae_tpu_torch.core import precision
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data import get_dataloaders
from mmvae_tpu_torch.dcca import objectives as cca
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.eval import cluster as CL
from mmvae_tpu_torch.eval import prd as PRD
from mmvae_tpu_torch.eval.gmm import GaussianMixtureSampler
from mmvae_tpu_torch.flows import MAF, build_masks
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.nets import Conv2d, ConvTranspose2d, Linear
from mmvae_tpu_torch.objectives import m_dreg_looser
from mmvae_tpu_torch.ops import ar_flow
from mmvae_tpu_torch.train import Trainer
from mmvae_tpu_torch.train.optim import RMSprop

D, H, N_HIDDEN = 20, 128, 3
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def card():
    """The card, with TF32 off for matmuls and cuDNN convolutions while the
    test runs (float32 parity needs both) and restored after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


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
@pytest.mark.parametrize("n", [128, 37])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_backward_kernel_matches_autograd(card, n, sign, s_bound):
    """One backward call (the chain and the sum of its blocks' partial
    sums) gives autograd's gradients through the plain solve, for x, every
    weight and every bias."""
    ws, bs = _weights(card, seed=10)
    gen = torch.Generator().manual_seed(11)
    x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                  for shape in ((n, D), (n, D), (n,)))
    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.kernel_forward(x, ws, bs, sign, s_bound, tape=tape)
    before = ar_flow.ar_solve.backward_launches
    gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    assert ar_flow.ar_solve.backward_launches == before + 1
    inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
    outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):],
                                  sign, s_bound)
    want = torch.autograd.grad(outs, inputs, (gy, gld))
    for got, ref in zip([gx, *gws, *gbs], want):
        torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_hidden", [1, 2])
def test_kernels_at_other_depths(card, n_hidden):
    """Both kernels at one and two hidden layers (the main path has three)."""
    ws, bs = _weights(card, seed=12, n_hidden=n_hidden)
    gen = torch.Generator().manual_seed(13)
    x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                  for shape in ((37, D), (37, D), (37,)))
    tape = ar_flow.new_tape(x, ws)
    y, ld = ar_flow.kernel_forward(x, ws, bs, 1, 8.0, tape=tape)
    gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, 1, 8.0)
    inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
    outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):], 1, 8.0)
    want = torch.autograd.grad(outs, inputs, (gy, gld))
    for got, ref in zip([y, ld, gx, *gws, *gbs], [*outs, *want]):
        torch.testing.assert_close(got, ref.detach(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
def test_backward_at_zero_made_biases(card, sign):
    """CelebA's latent 64 at MADE's initial zero biases, where hidden units
    whose masked inputs are all still 0 sit exactly at the ReLU's tie: the
    forward's tape holds those exact zeros, and the backward takes the slope
    1/2 there, as autograd through `unrolled_solve` (jnp.maximum's
    subgradient) does. The inputs are chip_smoke's `_tie_inputs`, at which
    units sit at the tie past step 0, where the head reads them. The
    reference replays the kernel's branches (chip_smoke's `_ReluBranches`),
    each element on another branch than its own within 1e-5 of 0; replayed
    at slope 0 at the ties, it misses the kernel."""
    smoke = _chip_smoke()
    d = 64
    ws, bs = _weights(card, seed=40, d=d)
    bs = [torch.zeros_like(b) for b in bs]
    gen = torch.Generator().manual_seed(41)
    x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                  for shape in ((256, d), (256, d), (256,)))
    x, ws = smoke._tie_inputs(x, ws)
    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.kernel_forward(x, ws, bs, sign, 0.0, tape=tape)
    gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, 0.0)
    assert sum(int((z[1:] == 0).sum()) for z in tape.z) > 0
    branches = smoke._kernel_branches(tape)

    def reference(codes):
        inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
        with smoke._ReluBranches(replay=codes) as rb:
            outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)],
                                          inputs[1 + len(ws):], sign, 0.0)
            return torch.autograd.grad(outs, inputs, (gy, gld)), rb

    want, rb = reference(branches)
    assert rb.flip_max_abs <= 1e-5
    for got, ref in zip([gx, *gws, *gbs], want):
        torch.testing.assert_close(got, ref, **TOL)
    slope0, _ = reference([c.masked_fill(c == 1, 0) for c in branches])
    assert not all(torch.allclose(got, ref, rtol=TOL["rtol"], atol=TOL["atol"])
                   for got, ref in zip([gx, *gws, *gbs], slope0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 7_680])
def test_backward_is_bitwise_repeatable(card, n):
    """The backward sums in a fixed order (each block its own tiles, then
    the blocks in order; no floating-point atomics): two calls on the same
    inputs give bitwise equal gradients."""
    d = 64
    ws, bs = _weights(card, seed=42, d=d)
    gen = torch.Generator().manual_seed(43)
    x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                  for shape in ((n, d), (n, d), (n,)))
    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.kernel_forward(x, ws, bs, -1, 0.0, tape=tape)
    first = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, -1, 0.0)
    second = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, -1, 0.0)
    for a, b in zip([first[0], *first[1], *first[2]], [second[0], *second[1], *second[2]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_biases", [False, True])
def test_forward_tape_holds_pre_activations(card, zero_biases):
    """The recording forward's tape holds each hidden layer's pre-activation
    z (not its ReLU) at every step, as `plain_tape` records it, and the
    head's raw log-scale; at zero biases the exact zeros of the ties."""
    ws, bs = _weights(card, seed=44)
    if zero_biases:
        bs = [torch.zeros_like(b) for b in bs]
    x = torch.randn(37, D, generator=torch.Generator().manual_seed(45)).to(card)
    tape = ar_flow.new_tape(x, ws)
    y, ld = ar_flow.kernel_forward(x, ws, bs, 1, 8.0, tape=tape)
    y_p, ld_p, tape_p = ar_flow.plain_tape(x, ws, bs, 1, 8.0)
    assert len(tape.z) == len(ws) - 1
    for got, ref in zip([y, ld, tape.s, *tape.z], [y_p, ld_p, tape_p.s, *tape_p.z]):
        torch.testing.assert_close(got, ref, **TOL)
    assert any(bool((z < 0).any()) for z in tape.z)
    if zero_biases:
        assert sum(int((z == 0).sum()) for z in tape.z) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
def test_function_on_card_grads_match_plain(card, sign):
    """The autograd Function launches the forward kernel once and the
    backward kernel once per backward call, and gives the plain version's
    values and gradients for x, every weight and every bias; leading dims
    (K, B, D)."""
    ws, bs = _weights(card, seed=7)
    x = torch.randn(2, 64, D, generator=torch.Generator().manual_seed(8)).to(card)
    runs = {}
    for name in ("fused", "plain"):
        xi = x.clone().requires_grad_(True)
        params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
        solve = ar_flow.ar_solve if name == "fused" else ar_flow.unrolled_solve
        before = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
        y, ld = solve(xi, params[:len(ws)], params[len(ws):], sign, 0.0)
        assert ar_flow.ar_solve.launches == before[0] + (name == "fused")
        (y.square().sum() + ld.sum()).backward()
        assert ar_flow.ar_solve.backward_launches == before[1] + (name == "fused")
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
    wide_ws, wide_bs = _weights(card, h=256)  # the kernels take hidden layers of 128 only
    with pytest.raises(ValueError, match="width 128"):
        ar_flow.kernel_forward(x, wide_ws, wide_bs, 1)
    # six hidden layers: the five staged 128x128 ones (5 x 66 KB) overflow shared memory
    deep_ws, deep_bs = _weights(card, n_hidden=6)
    with pytest.raises(ValueError, match="shared memory"):
        ar_flow.kernel_forward(x, deep_ws, deep_bs, 1)
    tape = ar_flow.new_tape(x, deep_ws)
    with pytest.raises(ValueError, match="shared memory"):
        ar_flow.kernel_backward(x, x, x, x[:, 0].contiguous(), tape, deep_ws, 1)
    # four hidden layers: the forward takes them, the backward's three staged
    # layers and its step buffers do not fit
    ws4, bs4 = _weights(card, n_hidden=4)
    tape = ar_flow.new_tape(x, ws4)
    y, _ = ar_flow.kernel_forward(x, ws4, bs4, 1, tape=tape)
    with pytest.raises(ValueError, match="shared memory"):
        ar_flow.kernel_backward(x, y, x, x[:, 0].contiguous(), tape, ws4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.kernel_forward(x.cpu(), [w.cpu() for w in ws], [b.cpu() for b in bs], 1)


def _made_weights(dev, seed, d, hidden):
    """Masked MADE weights and biases at hidden widths `hidden`."""
    rng = np.random.default_rng(seed)
    masks, out_mask = build_masks(d, hidden)
    masks = masks + [np.concatenate([out_mask, out_mask], axis=1)]
    ws = [torch.tensor(rng.standard_normal(m.shape) / np.sqrt(m.shape[0]) * m,
                       dtype=torch.float32, device=dev) for m in masks]
    bs = [torch.tensor(rng.standard_normal(m.shape[1]) * 0.1, dtype=torch.float32, device=dev)
          for m in masks]
    return ws, bs


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,d", [((64,) * 3, 20), ((128,) * 4, 20), ((256,) * 2, 64)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_general_kernels_match_plain(card, hidden, d, sign):
    """The general pair (csrc/ar_flow_general.cu) at widths the 128-wide
    pair refuses or no config has: the forward against `unrolled_solve`, its
    tape against `plain_tape`, the backward (one launch, then `sum_grads`)
    against autograd through `unrolled_solve` for x, every weight and every
    bias, and a second backward call bitwise equal."""
    ws, bs = _made_weights(card, 60 + d, d, hidden)
    gen = torch.Generator().manual_seed(61)
    x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                  for shape in ((37, d), (37, d), (37,)))
    before = (ar_flow.ar_solve.general_launches, ar_flow.ar_solve.general_backward_launches)
    tape = ar_flow.new_tape(x, ws)
    y, ld = ar_flow.general_forward(x, ws, bs, sign, 8.0, tape=tape)
    gx, gws, gbs = ar_flow.general_backward(x, y, gy, gld, tape, ws, sign, 8.0)
    again = ar_flow.general_backward(x, y, gy, gld, tape, ws, sign, 8.0)
    assert (ar_flow.ar_solve.general_launches,
            ar_flow.ar_solve.general_backward_launches) == (before[0] + 1, before[1] + 2)
    y_p, ld_p, tape_p = ar_flow.plain_tape(x, ws, bs, sign, 8.0)
    inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
    outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):], sign,
                                  8.0)
    want = torch.autograd.grad(outs, inputs, (gy, gld))
    for got, ref in zip([y, ld, tape.s, *tape.z, gx, *gws, *gbs],
                        [y_p, ld_p, tape_p.s, *tape_p.z, *want]):
        torch.testing.assert_close(got, ref.detach(), **TOL)
    for a, b in zip([gx, *gws, *gbs], [again[0], *again[1], *again[2]]):
        assert torch.equal(a, b)


# chip_smoke.py's ar_solve_shapes: the general pair's shapes (hidden widths,
# D, rows), then those that take its kernels' other paths on an H100 (50 x 3:
# widths not a multiple of 4, so 4-byte staging and tape copies; 100 x 6:
# slices of 52 and 48 over 2 CTAs forward, 28 and 16 over 4 backward; 202 x
# 4: 8 CTAs backward, the last CTA's slice 6 wide, at a ragged row tile; 510,
# 22, 510: a 4-CTA cluster where one CTA holds none of the 22-wide layer),
# the last the general pair forced at every config's MADE
GENERAL_SHAPES = [((64,) * 4, 20, 128), ((64,) * 3, 20, 128), ((128,) * 4, 20, 128),
                  ((128,) * 6, 20, 128), ((256,) * 2, 64, 256), ((100,) * 3, 16, 37),
                  ((96, 160, 64), 30, 256), ((32,), 2, 128), ((64,) * 4, 64, 7_680),
                  ((50,) * 3, 20, 128), ((100,) * 6, 20, 128), ((202,) * 4, 20, 37),
                  ((510, 22, 510), 64, 128), ((128,) * 3, 20, 128)]


def _general_reference(x, ws, y, gy, gld, tape, sign, s_bound):
    """The general backward's plain version on its tape: `plain_general_backward`
    on the kernel's grid and tiles, or past 1,024 rows (where its Python loop
    over tiles takes minutes on a card) `plain_backward`, the same chain over
    all rows at once, whose sums differ only in order."""
    n, d = x.shape
    if n > 1024:
        return ar_flow.plain_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    widths = (d, *[w.shape[1] for w in ws])
    plan = ar_flow.general_plan(widths, True, n, ar_flow._sm_count(0), ar_flow._smem_limit(0))
    grid = ar_flow._general_clusters(widths, True, n, 0)
    return ar_flow.plain_general_backward(x, y, gy, gld, tape, ws, sign, s_bound, grid, plan[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GENERAL_SHAPES,
                         ids=["-".join(map(str, h)) + f"_d{d}_n{n}" for h, d, n in GENERAL_SHAPES])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_general_pair_at_every_shape(card, shape, sign, s_bound):
    """The general pair at every shape of chip_smoke.py's ar_solve_shapes:
    the forward against `unrolled_solve` and its tape against `plain_tape`;
    the whole backward (the chain and the sum of the clusters' partial sums)
    against its plain version on the forward kernel's own tape (its ReLU
    branches; `_general_reference`), rtol/atol 1e-4; a second backward
    bitwise equal; one launch counted each way."""
    hidden, d, n = shape
    ws, bs = _made_weights(card, 90 + d + len(hidden), d, hidden)
    gen = torch.Generator().manual_seed(91)
    x, gy = (torch.randn(n, d, generator=gen).to(card) for _ in range(2))
    gld = torch.randn(n, generator=gen).to(card)
    a = ar_flow.ar_solve
    before = (a.general_launches, a.general_backward_launches, a.streamed_launches)
    tape = ar_flow.new_tape(x, ws)
    y, ld = ar_flow.general_forward(x, ws, bs, sign, s_bound, tape=tape)
    got = ar_flow.general_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    again = ar_flow.general_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    assert (a.general_launches, a.general_backward_launches, a.streamed_launches) == (
        before[0] + 1, before[1] + 2, before[2])
    y_p, ld_p, tape_p = ar_flow.plain_tape(x, ws, bs, sign, s_bound)
    for g, want in zip([y, ld, tape.s, *tape.z], [y_p, ld_p, tape_p.s, *tape_p.z]):
        torch.testing.assert_close(g, want, **TOL)
    want = _general_reference(x, ws, y, gy, gld, tape, sign, s_bound)
    flat = [got[0], *got[1], *got[2]]
    for g, w in zip(flat, [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(g, w, **TOL)
    assert all(torch.equal(g, h) for g, h in zip(flat, [again[0], *again[1], *again[2]]))


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
def test_general_backward_at_ties_past_step_0(card, sign):
    """MADE's zero biases with y_0 > 0 and the first layer's degree-0 units
    on negative weights: the later layers' degree-0 units sit exactly at the
    ReLU's tie past step 0, where the head reads them (64 x 4, D = 64). The
    general backward takes JAX's slope 1/2 there: it meets
    `plain_general_backward` on its tape (rtol/atol 1e-4), and misses the
    same with the tied pre-activations moved just below 0 (slope 0)."""
    d, hidden, n = 64, (64,) * 4, 512
    ws, bs = _made_weights(card, 95, d, hidden)
    bs = [torch.zeros_like(b) for b in bs]
    w0 = ws[0].clone()
    deg0 = ((w0 != 0).sum(0) == 1).nonzero().flatten()
    assert len(deg0) and bool((w0[1:, deg0] == 0).all())
    w0[0, deg0] = -w0[0, deg0].abs()
    ws = [w0, *ws[1:]]
    gen = torch.Generator().manual_seed(96)
    x, gy = (torch.randn(n, d, generator=gen).to(card) for _ in range(2))
    x[:, 0] = x[:, 0].abs()
    gld = torch.randn(n, generator=gen).to(card)
    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.general_forward(x, ws, bs, sign, 0.0, tape=tape)
    assert sum(int((z[1:] == 0).sum()) for z in tape.z) > 0
    got = ar_flow.general_backward(x, y, gy, gld, tape, ws, sign, 0.0)
    flat = [got[0], *got[1], *got[2]]
    want = _general_reference(x, ws, y, gy, gld, tape, sign, 0.0)
    for g, w in zip(flat, [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(g, w, **TOL)
    below = ar_flow.Tape([torch.where(z == 0, torch.full_like(z, -1e-30), z) for z in tape.z],
                         tape.s)
    slope0 = _general_reference(x, ws, y, gy, gld, below, sign, 0.0)
    assert not all(torch.allclose(g, w, **TOL)
                   for g, w in zip(flat, [slope0[0], *slope0[1], *slope0[2]]))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,d,routes,clusters", [
    ((128,) * 6, 20, ("general", "general"), (2, 4)),
    ((1024,) * 2, 16, ("streamed", "streamed"), (None, None)),
    ((512,) * 2, 64, ("general", "streamed"), (8, None))])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cluster_and_third_routes_launch_and_count(card, hidden, d, routes, clusters, sign):
    """Through `ar_solve` under autograd: 6 hidden layers of 128 take the
    general pair on clusters (2 CTAs forward, 4 backward); two of 1,024 the
    streamed pair (no cluster of 8 holds them); two of 512 at D = 64 the
    general forward on clusters of 8 and the streamed backward, on one tape.
    Each direction launches once, counted as its pair's (and at sign -1 as
    its pair's sign -1 launch) and in the totals, with the plain version's
    values and gradients."""
    widths = [d, *hidden, 2 * d]
    limit = ar_flow._smem_limit(0)
    assert tuple(ar_flow.route(widths, b, limit) for b in (False, True)) == routes
    plans = [ar_flow.general_plan(widths, b, 64, ar_flow._sm_count(0), limit)
             for b in (False, True)]
    assert tuple(None if p is None else p[0] for p in plans) == clusters
    ws, bs = _made_weights(card, 97, d, hidden)
    x = torch.randn(64, d, generator=torch.Generator().manual_seed(98)).to(card)
    a = ar_flow.ar_solve
    runs = {}
    for name in ("fused", "plain"):
        xi = x.clone().requires_grad_(True)
        params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
        solve = ar_flow.ar_solve if name == "fused" else ar_flow.unrolled_solve
        before = {k: getattr(a, k) for k in ar_flow.COUNTS}
        y, ld = solve(xi, params[:len(ws)], params[len(ws):], sign, 0.0)
        (y.square().sum() + ld.sum()).backward()
        got = {k: getattr(a, k) - before[k] for k in ar_flow.COUNTS}
        want = dict.fromkeys(ar_flow.COUNTS, 0)
        if name == "fused":
            for pair, what in zip(routes, ("launches", "backward_launches")):
                for key in (what, f"{pair}_{what}"):
                    want[key] = 1
                    want[key.replace(what, f"sign_minus_{what}")] = int(sign < 0)
        assert got == want
        runs[name] = [y, ld, xi.grad, *(p.grad for p in params)]
    for g, w in zip(runs["fused"], runs["plain"]):
        torch.testing.assert_close(g, w, **TOL)


# the streamed pair's shapes: two hidden layers of 1,024 at 128, 37 (a
# ragged tile) and 3 rows (one tile, fewer rows than row groups), two of 512
# at D = 64, twelve of 1,024 (the weights streamed: past the card's shared
# memory); one hidden layer of 4,000 at D = 64 (no hidden-to-hidden link: one
# group barrier a step); two of 1,002 (widths not a multiple of 4, the
# weights streamed, the last CTA's slices 42 and 10 wide); 2,048 then 1,024
# (mixed widths, the forward on 15 CTAs a group)
STREAMED_SHAPES = [((1024,) * 2, 16, 128), ((1024,) * 2, 16, 37), ((1024,) * 2, 16, 3),
                   ((512,) * 2, 64, 128), ((1024,) * 12, 16, 64), ((4000,), 64, 128),
                   ((1002,) * 2, 16, 128), ((2048, 1024), 16, 128)]


def _streamed_reference(x, ws, y, gy, gld, tape, sign, s_bound):
    """The streamed backward's plain version on its tape: `plain_chain`, then
    `sum_grads`."""
    gx, deltas, head = ar_flow.plain_chain(x, y, gy, gld, tape, ws, sign, s_bound)
    gws, gbs = ar_flow.sum_grads(y, tape, deltas, head)
    return [gx, *gws, *gbs]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STREAMED_SHAPES)
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_streamed_pair_at_every_shape(card, shape, sign, s_bound):
    """The streamed pair's direct entries on their plans (resident or
    streamed weights, as `streamed_plan` decides on this card): the forward
    with its tape against `plain_tape`, without one bitwise the same; the
    whole backward (the chain, then `sum_grads`) against `plain_chain` and
    `sum_grads` on the kernel's own tape, rtol/atol 1e-4; a second backward
    bitwise equal; one launch counted each way."""
    hidden, d, n = shape
    ws, bs = _made_weights(card, 120 + d + len(hidden) + n, d, hidden)
    gen = torch.Generator().manual_seed(121)
    x, gy = (torch.randn(n, d, generator=gen).to(card) for _ in range(2))
    gld = torch.randn(n, generator=gen).to(card)
    a = ar_flow.ar_solve
    before = (a.streamed_launches, a.streamed_backward_launches, a.general_launches)
    tape = ar_flow.new_tape(x, ws)
    y, ld = ar_flow.streamed_forward(x, ws, bs, sign, s_bound, tape=tape)
    y2, ld2 = ar_flow.streamed_forward(x, ws, bs, sign, s_bound)
    got = ar_flow.streamed_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    again = ar_flow.streamed_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    assert (a.streamed_launches, a.streamed_backward_launches, a.general_launches) == (
        before[0] + 2, before[1] + 2, before[2])
    assert torch.equal(y, y2) and torch.equal(ld, ld2)
    y_p, ld_p, tape_p = ar_flow.plain_tape(x, ws, bs, sign, s_bound)
    for g, want in zip([y, ld, tape.s, *tape.z], [y_p, ld_p, tape_p.s, *tape_p.z]):
        torch.testing.assert_close(g, want, **TOL)
    flat = [got[0], *got[1], *got[2]]
    for g, w in zip(flat, _streamed_reference(x, ws, y, gy, gld, tape, sign, s_bound)):
        torch.testing.assert_close(g, w, **TOL)
    assert all(torch.equal(g, h) for g, h in zip(flat, [again[0], *again[1], *again[2]]))


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
def test_streamed_backward_at_ties_past_step_0(card, sign):
    """MADE's zero biases with y_0 > 0 and the first layer's degree-0 units
    on negative weights (two hidden layers of 1,024, D = 16): the last
    layer's degree-0 units sit exactly at the ReLU's tie past step 0, where
    the head reads them. The streamed backward takes JAX's slope 1/2 there:
    it meets its plain version on its tape (rtol/atol 1e-4), and misses the
    same with the tied pre-activations moved just below 0 (slope 0)."""
    d, hidden, n = 16, (1024,) * 2, 128
    ws, bs = _made_weights(card, 122, d, hidden)
    bs = [torch.zeros_like(b) for b in bs]
    w0 = ws[0].clone()
    deg0 = ((w0 != 0).sum(0) == 1).nonzero().flatten()
    assert len(deg0) and bool((w0[1:, deg0] == 0).all())
    w0[0, deg0] = -w0[0, deg0].abs()
    ws = [w0, *ws[1:]]
    gen = torch.Generator().manual_seed(123)
    x, gy = (torch.randn(n, d, generator=gen).to(card) for _ in range(2))
    x[:, 0] = x[:, 0].abs()
    gld = torch.randn(n, generator=gen).to(card)
    tape = ar_flow.new_tape(x, ws)
    y, _ = ar_flow.streamed_forward(x, ws, bs, sign, 0.0, tape=tape)
    assert sum(int((z[1:] == 0).sum()) for z in tape.z) > 0
    got = ar_flow.streamed_backward(x, y, gy, gld, tape, ws, sign, 0.0)
    flat = [got[0], *got[1], *got[2]]
    for g, w in zip(flat, _streamed_reference(x, ws, y, gy, gld, tape, sign, 0.0)):
        torch.testing.assert_close(g, w, **TOL)
    below = ar_flow.Tape([torch.where(z == 0, torch.full_like(z, -1e-30), z) for z in tape.z],
                         tape.s)
    slope0 = _streamed_reference(x, ws, y, gy, gld, below, sign, 0.0)
    assert not all(torch.allclose(g, w, **TOL) for g, w in zip(flat, slope0))


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
def test_streamed_forward_on_a_narrowed_ring(card, sign):
    """Four hidden layers of 4,700 units (265 MB of weights): only streamed
    plans whose ring slots are narrowed below 8,192 floats fit, and `route`
    takes the widths as it did before the redesign. The forward on that
    plan against `unrolled_solve`, rtol/atol 1e-4, and bitwise again."""
    d, hidden, n = 16, (4700,) * 4, 8
    widths = (d, *hidden, 2 * d)
    assert ar_flow.route(widths, False, ar_flow._smem_limit(0)) == "streamed"
    assert 0 < ar_flow._streamed_plan_on(widths, False, n, 0).cap < ar_flow.STREAMED_SLOT_FLOATS
    ws, bs = _made_weights(card, 124, d, hidden)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(125)).to(card)
    y, ld = ar_flow.streamed_forward(x, ws, bs, sign, 0.0)
    y2, ld2 = ar_flow.streamed_forward(x, ws, bs, sign, 0.0)
    y_p, ld_p = ar_flow.unrolled_solve(x, ws, bs, sign, 0.0)
    torch.testing.assert_close(y, y_p, **TOL)
    torch.testing.assert_close(ld, ld_p, **TOL)
    assert torch.equal(y, y2) and torch.equal(ld, ld2)


@pytest.mark.cuda
def test_ar_solve_at_four_hidden_layers_of_128(card):
    """A MADE of 4 x 128 under autograd: `ar_solve` routes its forward to the
    128-wide kernel and its backward, which that kernel's shared memory
    refuses, to the general kernel (no ValueError), and gives the plain
    version's values and gradients."""
    ws, bs = _made_weights(card, 62, D, (128,) * 4)
    x = torch.randn(64, D, generator=torch.Generator().manual_seed(63)).to(card)
    runs = {}
    for name in ("fused", "plain"):
        xi = x.clone().requires_grad_(True)
        params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
        solve = ar_flow.ar_solve if name == "fused" else ar_flow.unrolled_solve
        a = ar_flow.ar_solve
        before = (a.launches, a.general_launches, a.backward_launches, a.general_backward_launches)
        y, ld = solve(xi, params[:len(ws)], params[len(ws):], 1, 0.0)
        (y.square().sum() + ld.sum()).backward()
        after = (a.launches, a.general_launches, a.backward_launches, a.general_backward_launches)
        assert [b - c for b, c in zip(after, before)] == ([1, 0, 1, 1] if name == "fused"
                                                          else [0, 0, 0, 0])
        runs[name] = [y, ld, xi.grad, *(p.grad for p in params)]
    for a, b in zip(runs["fused"], runs["plain"]):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,d", [((128,) * 3, 20), ((128,) * 4, 64), ((128,) * 6, 2),
                                      ((64,) * 4, 20), ((96, 160, 64), 30), ((32,), 2),
                                      ((1024,) * 2, 16), ((4000,), 64), ((1002,) * 2, 16),
                                      ((2048, 1024), 16), ((4700,) * 4, 16)])
def test_shared_memory_copies_match_the_kernels(card, hidden, d):
    """`route` decides from the Python copies of the kernels' shared-memory
    sizes and plans (`fast_smem_bytes`, `general_plan`, `streamed_plan`):
    they equal what the built libraries compute, at several row counts on
    this card's SM count, co-resident CTAs and limit."""
    import ctypes

    widths = [d, *hidden, 2 * d]
    arr = (ctypes.c_int * len(widths))(*widths)
    limit, sms = ar_flow._smem_limit(0), ar_flow._sm_count(0)
    for backward in (0, 1):
        fast = ar_flow._lib().ar_solve_smem_bytes(arr, len(widths) - 1, backward)
        assert fast == (ar_flow.fast_smem_bytes(widths, backward) or -1)
        ctas = ar_flow._streamed_ctas(0, bool(backward))
        for n in (1, 37, 128, 256, 7_680, 10_000):
            assert tuple(ar_flow._streamed_plan_on(tuple(widths), bool(backward), n, 0)) == tuple(
                ar_flow.streamed_plan(tuple(widths), bool(backward), n, ctas, limit))
            out = (ctypes.c_int * 3)()
            rc = ar_flow._general_lib().ar_solve_general_plan(arr, len(widths) - 1, backward, n,
                                                              sms, limit, out)
            assert (None if rc else tuple(out)) == ar_flow.general_plan(widths, backward, n, sms,
                                                                        limit)


@pytest.mark.cuda
def test_cli_epoch_on_card(card, tmp_path):
    """One small MMVAE-NF epoch through the CLI on cuda: TF32 is switched
    off for matmuls and cuDNN, every parameter lies on the card, the
    forward kernel runs 4 times (2 modalities x 2 MAF blocks) per train step
    and per val batch, and the backward kernel 4 times per train step."""
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
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    run_path = cli_train.main(["--config-path", str(cfg_path), "--experiments-dir",
                               str(tmp_path / "exp"), "--device", "cuda"])
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert ar_flow.ar_solve.launches == 4 * (train.num_examples // 16 + val.num_examples // 16)
    assert ar_flow.ar_solve.backward_launches == 4 * (train.num_examples // 16)
    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    assert all(t.is_cuda for t in state.values())
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])


FLAGSHIP = "configs/mnist_svhn/mmvae_synth.json"
FLAGSHIP_BF16 = "configs/mnist_svhn/mmvae_synth_bf16.json"


@pytest.mark.cuda
def test_dreg_looser_step_on_card_matches_f64_cpu(card):
    """The flagship's DReG-looser objective and every gradient on cuda in
    float32 against the CPU in float64, same weights and uniform noise
    (B=8, K=5, latent 20, full-width nets). Objective rtol 1e-5; each
    gradient leaf to 2e-3 of its largest entry: the importance weights are
    softmaxes over log-weights near -6,000, where a float32 ulp is 5e-4."""
    cfg = ExperimentConfig.from_json(FLAGSHIP)
    cfg.K, b = 5, 8
    rng = np.random.default_rng(14)
    xs = [rng.uniform(size=(b, 1, 28, 28)), rng.uniform(size=(b, 3, 32, 32))]
    us = [rng.uniform(Dist.LAPLACE_U_MIN, Dist.LAPLACE_U_MAX, size=(cfg.K, b, cfg.latent_dim))
          for _ in range(2)]
    runs, weights = {}, None
    for dev, dtype in (("cpu", torch.float64), (card, torch.float32)):
        bundle = registry.build(cfg)
        model = bundle.model.to(dev, dtype)
        if weights is None:
            weights = export_jax_params(model)
        else:
            load_jax_params(model, weights)
        obj, _ = m_dreg_looser(model, [torch.tensor(x, dtype=dtype, device=dev) for x in xs],
                               bundle.spec, K=cfg.K,
                               noise=[torch.tensor(u, dtype=dtype, device=dev) for u in us])
        grads = torch.autograd.grad(obj, list(model.parameters()))
        runs[str(dev)] = (obj.item(), [g.double().cpu() for g in grads])
    (ref, ref_g), (got, got_g) = runs["cpu"], runs[str(card)]
    assert abs(got - ref) <= 1e-5 * abs(ref)
    for g, r in zip(got_g, ref_g):
        assert (g - r).abs().max() <= 2e-3 * r.abs().max()


def _bf16_layer(kind):
    if kind == "linear":
        return Linear(40, 24), (16, 40)
    if kind == "conv":
        return Conv2d(3, 8, 4, 2, padding=1), (4, 3, 16, 16)
    return ConvTranspose2d(16, 8, 4, 2, padding=1), (4, 16, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "conv", "conv_transpose"])
def test_bf16_layer_on_card_matches_cpu_form(card, kind):
    """Under the bf16 policy each layer's CUDA form (torch.mm with float32
    output for Linear, cuDNN's bf16 conv) against its CPU form (float32
    products of the bf16-rounded operands; a conv rounded once): Linear to
    float32 round-off (rtol 1e-5), a conv to one bf16 ulp of its value
    before the bias; the output float32. The gradients of the input, the
    weight and the bias, rounded to bf16 at other points on the two
    devices, to four bf16 ulps (2^-6) of each one's largest entry."""
    layer, shape = _bf16_layer(kind)
    layer.reset_parameters(torch.Generator().manual_seed(15))
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(shape, generator=gen)
    runs = {}
    for dev in ("cpu", card):
        mod = copy.deepcopy(layer).to(dev)
        xi = x.to(dev, copy=True).requires_grad_(True)
        with precision.use("bfloat16"):
            y = mod(xi)
        r = torch.randn(y.shape, generator=torch.Generator().manual_seed(17)).to(dev)
        (y * r).sum().backward()
        runs[str(dev)] = [t.detach().cpu() for t in (y, xi.grad, mod.weight.grad, mod.bias.grad)]
        assert y.dtype == torch.float32
    (y_ref, *g_ref), (y, *g) = runs["cpu"], runs[str(card)]
    if kind == "linear":
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-6)
    else:
        pre = y_ref - layer.bias.detach()[None, :, None, None]
        assert ((y - y_ref).abs() <= 2 ** -8 * pre.abs() + 1e-6).all()
    for a, b in zip(g, g_ref):
        assert (a - b).abs().max() <= 2 ** -6 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("config", [FLAGSHIP, FLAGSHIP_BF16])
def test_flagship_cli_epoch_on_card(card, tmp_path, config):
    """One small epoch of the flagship (and its bf16 twin) through the CLI
    on cuda: every parameter on the card and float32, finite losses, no
    skipped step, and no ar_solve launch (the path has no flow)."""
    with open(config) as f:
        raw = json.load(f)
    # an empty data dir inside tmp_path: the synthetic stand-in, nothing read outside
    raw.update(synthetic_n=64, batch_size=16, K=3, epochs=1, no_analytics=True,
               data_path=str(tmp_path / "data"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    run_path = cli_train.main(["--config-path", str(cfg_path), "--experiments-dir",
                               str(tmp_path / "exp"), "--device", "cuda"])
    assert ar_flow.ar_solve.launches == ar_flow.ar_solve.backward_launches == 0
    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    assert all(t.is_cuda and t.dtype == torch.float32 for t in state.values())
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    assert all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["train_nan_skipped"] == 0.0


JNF = "configs/mnist_svhn/jmvae_nf.json"


@pytest.mark.cuda
def test_jnf_post_warmup_step_on_card(card):
    """One post-warmup JMVAE-NF train step on cuda (frozen joint forward,
    unimodal reconstructions on; latent 20, B=16, full-width nets): a
    finite loss, no skipped step, 4 forward and 4 backward ar_solve launches
    (2 modalities x 2 MAF blocks, the unimodal VAE forwards of compute_kld),
    and the joint encoder and decoders untouched by the optimizer."""
    cfg = ExperimentConfig.from_json(JNF)
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device=card)
    trainer.init_parameters()
    trainer.init_opt_state(past_warmup=True, amsgrad=False)
    gen = torch.Generator().manual_seed(18)
    xs = [torch.rand(16, 1, 28, 28, generator=gen).to(card),
          torch.rand(16, 3, 32, 32, generator=gen).to(card)]
    frozen = {n: p.detach().clone() for n, p in bundle.model.named_parameters()
              if "joint_encoder" in n or "decoder" in n}
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    loss, details = trainer.train_step(xs, cfg.learning_rate, epoch=cfg.warmup)
    torch.cuda.synchronize()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (4, 4)
    assert torch.isfinite(loss) and details["nan_skipped"].item() == 0.0
    assert trainer.opt.count.item() == 1 and details["recon_loss_1"].item() > 0
    for n, p in bundle.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


TELBO_NF = "configs/mnist_svhn/telbo_nf.json"


def _card_batch(card, n=16, latent=20, n_noise=3, seed=18):
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.rand(n, 1, 28, 28, generator=gen).to(card),
          torch.rand(n, 3, 32, 32, generator=gen).to(card)]
    return xs, [torch.randn(n, latent, generator=gen).to(card) for _ in range(n_noise)]


@pytest.mark.cuda
def test_telbo_nf_post_warmup_step_on_card(card):
    """One post-warmup TELBO-NF step on cuda (telbo_nf.json: latent 20,
    B=16, full-width nets, MAF flows): the unimodal VAE forwards run both
    ar_solve kernels under autograd, 4 forward and 4 backward launches (2
    modalities x 2 MAF blocks). The objective and every gradient leaf
    against the same step through the plain solve on the card (rtol 1e-4;
    each leaf to 1e-4 of its largest entry); then the Trainer's step
    leaves the joint encoder and decoders untouched."""
    from mmvae_tpu_torch.objectives import m_telbo_nf

    cfg = ExperimentConfig.from_json(TELBO_NF)
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device=card)
    trainer.init_parameters()
    trainer.init_opt_state(past_warmup=True, amsgrad=False)
    model, params = bundle.model, list(bundle.model.parameters())
    xs, eps = _card_batch(card)
    flows = [v.flow for v in model.vaes]

    def objective_and_grads(fused):
        for f in flows:
            f.use_fused = fused
        obj, _ = m_telbo_nf(model, xs, bundle.spec, epoch=cfg.warmup, warmup=cfg.warmup,
                            noise=eps)
        grads = torch.autograd.grad(obj, params, allow_unused=True)
        return obj.item(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    plain_obj, plain_grads = objective_and_grads(False)
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    obj, grads = objective_and_grads(True)
    torch.cuda.synchronize()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (4, 4)
    assert obj == pytest.approx(plain_obj, rel=1e-4)
    for (name, _), g, ref in zip(model.named_parameters(), grads, plain_grads):
        scale = ref.abs().max().clamp_min(1e-30)
        assert ((g - ref).abs().max() / scale).item() <= 1e-4, name

    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if "joint_encoder" in n or "decoder" in n}
    loss, details = trainer.train_step(xs, cfg.learning_rate, epoch=cfg.warmup)
    torch.cuda.synchronize()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (8, 8)
    assert torch.isfinite(loss) and details["nan_skipped"].item() == 0.0
    assert details["neg_elbo_0"].item() > 0
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["configs/mnist_svhn/mvae_synth.json",
                                    "configs/mnist_svhn/moepoe_synth.json"])
def test_poe_family_step_on_card(card, config):
    """One MVAE and one MoE-PoE train step on cuda (latent 20, B=16,
    full-width nets): no ar_solve launch (no flow), a finite loss, no
    skipped step, every parameter on the card after the step."""
    cfg = ExperimentConfig.from_json(config)
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device=card)
    trainer.init_parameters()
    trainer.init_opt_state()
    xs, _ = _card_batch(card, n_noise=0)
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    loss, details = trainer.train_step(xs, cfg.learning_rate)
    torch.cuda.synchronize()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (0, 0)
    assert torch.isfinite(loss) and details["nan_skipped"].item() == 0.0
    assert trainer.opt.count.item() == 1
    assert all(p.is_cuda for p in bundle.model.parameters())


def _views(n, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 4))
    return [z @ rng.normal(size=(4, d)) + 0.5 * rng.normal(size=(n, d)) for _ in range(2)]


@pytest.mark.cuda
def test_chol_cca_on_card_matches_f64_cpu(card):
    """The Cholesky CCA loss (Solver backend "chol") on cuda in float32
    against the CPU in float64 at a DCCA batch (800 x 16, top 16): value to
    rtol 1e-4, each view's gradient to 2e-3 of its largest entry; and the
    singular-value Function's backward alone (a 16 x 16 T, top 9) to 1e-4."""
    hs = _views(800, 16, 19)
    runs = {}
    for dev, dtype in (("cpu", torch.float64), (card, torch.float32)):
        ts = [torch.tensor(h, dtype=dtype, device=dev, requires_grad=True) for h in hs]
        val = cca.cca_loss_chol(ts[0], ts[1], 16)
        runs[str(dev)] = (val.item(), [g.double().cpu() for g in torch.autograd.grad(val, ts)])
    (ref, ref_g), (got, got_g) = runs["cpu"], runs[str(card)]
    assert abs(got - ref) <= 1e-4 * abs(ref)
    for g, r in zip(got_g, ref_g):
        assert (g - r).abs().max() <= 2e-3 * r.abs().max()

    T = np.random.default_rng(20).normal(size=(16, 16))
    grads = []
    for dev, dtype in (("cpu", torch.float64), (card, torch.float32)):
        t = torch.tensor(T, dtype=dtype, device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(cca.sum_topk_sv(t, 9, 1e-3), t)
        grads.append(g.double().cpu())
    assert (grads[1] - grads[0]).abs().max() <= 1e-4 * grads[0].abs().max()


@pytest.mark.cuda
def test_rmsprop_step_on_card_matches_cpu(card):
    """Five RMSprop steps (the DCCA Solver's optimizer) on cuda against the
    same steps on the CPU, float32: parameters to rtol 1e-6."""
    rng = np.random.default_rng(21)
    shapes = [(64, 32), (32,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    runs = {}
    for dev in ("cpu", card):
        params = [torch.nn.Parameter(torch.tensor(p, device=dev)) for p in init]
        opt = RMSprop(params, lr=1e-3, weight_decay=1e-5)
        for g in grads:
            opt.step([torch.tensor(x, device=dev) for x in g])
        runs[str(dev)] = [p.detach().cpu() for p in params]
    for a, b in zip(runs[str(card)], runs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [500, 10_000])  # a coherence batch; an IS call, 100 x 100 rows
def test_forward_kernel_under_no_grad(card, monkeypatch, n):
    """The eval paths' call: the Function under no_grad, with parameters
    that require grad as a model's do, launches the forward kernel once,
    allocates no tape and matches `unrolled_solve`."""
    ws, bs = _weights(card, seed=22)
    params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
    x = torch.randn(n, D, generator=torch.Generator().manual_seed(23)).to(card)

    def no_tape(*args, **kwargs):
        raise AssertionError("a tape was allocated under no_grad")

    monkeypatch.setattr(ar_flow, "new_tape", no_tape)
    before = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
    with torch.no_grad():
        y, ld = ar_flow.ar_solve(x, params[:len(ws)], params[len(ws):], 1, 0.0)
        y_ref, ld_ref = ar_flow.unrolled_solve(x, ws, bs, 1, 0.0)
    torch.cuda.synchronize()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == \
        (before[0] + 1, before[1])
    assert not y.requires_grad and y.grad_fn is None
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(ld, ld_ref, **TOL)


@pytest.mark.cuda
def test_eval_clis_on_card(card, tmp_path):
    """A tiny JMVAE-NF run through the train CLI on cuda (with its
    analytics grids), then validate (classifier-feature FID, a pool of
    random classifiers) and compute_likelihoods --bis on cuda: the metric
    names, and the forward kernel's launches, 4 per conditional sampling
    call (2 modalities x 2 MAF blocks) and 2 per IS chunk and conditioning
    modality; no backward launch."""
    with open(JNF) as f:
        raw = json.load(f)
    raw.update(latent_dim=4, synthetic_n=64, batch_size=16, epochs=1, warmup=1, skip_warmup=False,
               data_path=str(tmp_path / "data"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    exp = tmp_path / "exp"
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32))):
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), str(exp / "classifiers" / f"{key}.pt"))
    run = cli_train.main(["--config-path", str(cfg_path), "--experiments-dir", str(exp)])
    assert os.path.exists(os.path.join(run, "generate_001.png"))
    nb = len(reload_model(run, 16)[2][1])  # test batches at the eval batch size

    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    summary = validate.main(["--run-path", run, "--experiments-dir", str(exp), "--repeats", "1",
                             "--fid-encoder", "classifier", "--batch-size", "16"])
    torch.cuda.synchronize()
    assert sorted(summary) == ["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence"]
    # coherence and FID per test batch, and the gen_from_cond grids
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (4 * (2 * nb + 1), 0)

    ar_flow.ar_solve.launches = 0
    summary = compute_likelihoods.main(["--run-path", run, "--k", "6", "--batch-size-k", "3",
                                        "--repeats", "1", "--batch-size", "16", "--bis"])
    torch.cuda.synchronize()
    assert sorted(summary) == ["cond_likelihood_0_1", "cond_likelihood_1_0",
                               "conditional_likelihood_bis_0_1", "conditional_likelihood_bis_1_0",
                               "likelihood"]
    assert all(math.isfinite(v["mean"]) for v in summary.values())
    # per batch: 2 conditioning modalities x 2 chunks x 2 blocks, for the
    # conditional likelihoods and again for the bis protocol's proposals
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (16 * nb, 0)


# ---------------------------------------------------------------------------
# k-means, EM, PRD and the Bernoulli family on the card
# ---------------------------------------------------------------------------

def _blob_data(seed=30, n_per=400, k=8, d=20):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4
    lab = rng.integers(0, k, n_per * k)
    return centers[lab] + rng.normal(size=(len(lab), d)), centers


@pytest.mark.cuda
def test_kmeans_on_card_matches_cpu(card):
    """From the same start centers, float64: the same labels and the
    inertia to rtol 1e-9; k-means++ restarts from a card generator give a
    labelling of every cluster."""
    x, centers = _blob_data()
    init = centers + 0.5
    cpu = CL.kmeans(torch.tensor(x), 8, init=init)
    gpu = CL.kmeans(torch.tensor(x, device=card), 8, init=init)
    assert gpu.labels.is_cuda and gpu.centers.dtype == torch.float64
    assert torch.equal(gpu.labels.cpu(), cpu.labels) and gpu.n_iter == cpu.n_iter
    np.testing.assert_allclose(gpu.inertia, cpu.inertia, rtol=1e-9)
    seeded = CL.kmeans(torch.tensor(x, device=card), 8,
                       generator=torch.Generator(device=card).manual_seed(0))
    assert len(torch.unique(seeded.labels)) == 8


@pytest.mark.cuda
def test_em_on_card_matches_cpu(card):
    """The mixture EM from the same start (one labelling's weights, means
    and precisions), float64: the same iterations, the converged parameters
    to rtol 1e-9 and the log-density of the data to rtol 1e-12."""
    x, _ = _blob_data(seed=31, n_per=300, k=5, d=10)
    xt = torch.tensor(x)
    labels = CL.kmeans(xt, 5, n_init=1, generator=torch.Generator().manual_seed(0)).labels
    start = CL.init_from_labels(xt, labels, 5)
    init = (start.weights, start.means, torch.linalg.inv(start.covariances))
    cpu = GaussianMixtureSampler(5).fit(xt, init=init)
    gpu = GaussianMixtureSampler(5).fit(xt.to(card), init=tuple(a.to(card) for a in init))
    assert gpu.fit_result.n_iter == cpu.fit_result.n_iter and gpu.params.means.is_cuda
    for a, b in zip(gpu.params[:3], cpu.params[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(gpu.log_prob(xt.to(card)).cpu().numpy(), cpu.log_prob(xt).numpy(),
                               rtol=1e-12)
    z = gpu.sample(1000, torch.Generator(device=card).manual_seed(0))
    assert z.is_cuda and tuple(z.shape) == (1000, 10) and torch.isfinite(z).all()


@pytest.mark.cuda
def test_prd_on_card_matches_cpu(card):
    """compute_prd and the F-beta pair of the same bins, and the bins of the
    same labels, on the card against the CPU: rtol 1e-12 and exact."""
    rng = np.random.default_rng(32)
    labels = torch.tensor(rng.integers(0, 20, 600))
    cpu_bins = PRD._histogram_bins(labels, 250, 20)
    gpu_bins = PRD._histogram_bins(labels.to(card), 250, 20)
    for a, b in zip(gpu_bins, cpu_bins):
        assert torch.equal(a.cpu(), b)
    cpu = PRD.compute_prd(*cpu_bins)
    gpu = PRD.compute_prd(*gpu_bins)
    for a, b in zip(gpu, cpu):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(PRD.prd_to_max_f_beta_pair(*gpu), PRD.prd_to_max_f_beta_pair(*cpu),
                               rtol=1e-12)
    x, _ = _blob_data(seed=33, n_per=50)
    p, r = PRD.compute_prd_from_embedding(x[:200], x[200:], device=card,
                                          generator=torch.Generator(device=card).manual_seed(0))
    assert p.is_cuda and 0.0 <= float(p.min()) and float(p.max()) <= 1.0


@pytest.mark.cuda
def test_bernoulli_on_card_matches_cpu(card):
    """The Bernoulli log-density on the card against the CPU (float64, rtol
    1e-12, probabilities at and beyond the clip), and draws from a card
    generator with the right law."""
    probs = torch.tensor([[-0.1, 0.0, 1e-9, 0.3, 0.5], [0.7, 1 - 1e-9, 1.0, 1.2, 0.05]],
                         dtype=torch.float64)
    x = torch.tensor(np.random.default_rng(34).uniform(size=(2, 5)))
    p = Dist.LocScale(probs, torch.ones_like(probs))
    want = Dist.log_prob("bernoulli", p, x)
    got = Dist.log_prob("bernoulli", Dist.LocScale(probs.to(card), torch.ones_like(probs, device=card)),
                        x.to(card))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12, atol=0)
    draws = Dist.bernoulli_sample(torch.full((100_000,), 0.3, device=card),
                                  generator=torch.Generator(device=card).manual_seed(0))
    assert draws.is_cuda and abs(float(draws.mean()) - 0.3) < 0.01


@pytest.mark.cuda
def test_gen_pipeline_on_card(card, tmp_path):
    """ms_small's augmentation pipeline at a tiny size on cuda: stage 1
    (epochs 2, warmup 2; no_recon, so only the epoch-1 grids launch the
    forward kernel, 4 times), generate_joint (no launch), stage 2 with
    use_gen (4 launches, its grids), validate --prd (4 per conditional
    sampling call), no backward launch anywhere."""
    exp = tmp_path / "exp"
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32))):
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), str(exp / "classifiers" / f"{key}.pt"))

    def config(path, **kw):
        with open(path) as f:
            raw = json.load(f)
        raw.update(latent_dim=4, synthetic_n=64, batch_size=16, len_train=100,
                   data_path=str(tmp_path / "data"), **kw)
        out = tmp_path / os.path.basename(path)
        out.write_text(json.dumps(raw))
        return str(out)

    def counted(fn, argv):
        ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
        out = fn(argv)
        torch.cuda.synchronize()
        return out, (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)

    common = ["--experiments-dir", str(exp)]
    run1, n1 = counted(cli_train.main, ["--config-path", config(
        "configs/ms_small/jnf_synth.json", epochs=2, warmup=2), *common])
    acc, n_gen = counted(generate_joint.main, ["--run-path", run1, "--n", "24", *common])
    run2, n2 = counted(cli_train.main, ["--config-path", config(
        "configs/ms_small/jnf_gen_synth.json", epochs=1, warmup=1, len_gen=24), *common])
    nb = len(reload_model(run2, 500)[2][1])
    summary, n_val = counted(validate.main, ["--run-path", run2, "--repeats", "1", "--prd",
                                             "--fid-encoder", "classifier", *common])
    assert (n1, n_gen, n2, n_val) == ((4, 0), (0, 0), (4, 0), (4 * (2 * nb + 1), 0))
    assert 0.0 <= acc <= 1.0
    for k in ("prd_f8_0", "prd_f8_1", "prd_f1_8_0", "prd_f1_8_1"):
        assert 0.0 <= summary[k]["mean"] <= 1.0
    assert os.path.exists(os.path.join(run2, "prd_curve_1.png"))


# ---------------------------------------------------------------------------
# circles-squares (latent 2) and the single-channel MNIST datasets
# ---------------------------------------------------------------------------

CIRCLES_JNF = "configs/circles/jmvae_nf.json"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 37])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_kernels_at_latent_2(card, n, sign, s_bound):
    """Both kernels at D = 2, circles-squares' width, where every MADE
    degree is 0 (each hidden unit sees y_0 alone, only head columns 1 and 3
    carry weights, the solve is two steps long): the forward against
    `unrolled_solve`, the backward with the reduction against autograd
    through it, for x, every weight and every bias."""
    ws, bs = _weights(card, seed=20, d=2)
    gen = torch.Generator().manual_seed(21)
    x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                  for shape in ((n, 2), (n, 2), (n,)))
    tape = ar_flow.new_tape(x, ws)
    y, ld = ar_flow.kernel_forward(x, ws, bs, sign, s_bound, tape=tape)
    gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, s_bound)
    inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
    outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):],
                                  sign, s_bound)
    want = torch.autograd.grad(outs, inputs, (gy, gld))
    for got, ref in zip([y, ld, gx, *gws, *gbs], [*outs, *want]):
        torch.testing.assert_close(got, ref.detach(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [120, 1_000, 10_000])  # HMC's start; neg_entropy's; an IS call
def test_forward_kernel_at_latent_2_eval_rows(card, n):
    ws, bs = _weights(card, seed=22, d=2)
    x = torch.randn(n, 2, generator=torch.Generator().manual_seed(23)).to(card)
    with torch.no_grad():
        for sign in (1, -1):
            got = ar_flow.kernel_forward(x, ws, bs, sign, 8.0)
            want = ar_flow.unrolled_solve(x, ws, bs, sign, 8.0)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, **TOL)


def _circles_jnf(dev, dtype, seed=1):
    cfg = ExperimentConfig.from_json(CIRCLES_JNF)
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu")
    trainer.init_parameters(seed)
    return cfg, bundle.model.to(dev, dtype).eval()


@pytest.mark.cuda
def test_hmc_step_on_card_matches_f64_cpu(card):
    """One HMC step over the product of the circles JMVAE-NF's experts (4
    rows x 30 chains, 10 leapfrogs of 0.01) on the card in float32 against
    the CPU in float64, from the same modality choice, start noise, momenta
    and accept-uniforms: the same accept decisions, the samples within 1e-4
    of their largest entry; the start runs the forward kernel, 2
    modalities x 2 MAF blocks, and the density none."""
    from mmvae_tpu_torch.data import synthetic
    from mmvae_tpu_torch.eval import hmc as H

    d = synthetic.make_circles_squares(dataset_size=8, n_repeat=1, seed=3)
    xs_np = [d["squares_train"][:4], d["circles_train"][:4]]
    rng = np.random.default_rng(4)
    choice = rng.integers(0, 2, 120)
    eps = [rng.standard_normal((120, 2)) for _ in range(2)]
    rho, u = rng.standard_normal((1, 120, 2)), rng.uniform(size=(1, 120))
    out = {}
    for dev, dtype in ((card, torch.float32), (torch.device("cpu"), torch.float64)):
        _, model = _circles_jnf(dev, dtype)

        def t(a):
            return torch.tensor(a, device=dev, dtype=dtype)

        data = [t(x) for x in xs_np]
        ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
        with torch.no_grad():
            z0 = H.sample_from_moe_subset(model, [0, 1], [torch.cat([x] * 30) for x in data],
                                          choice=torch.tensor(choice), eps=[t(e) for e in eps])
            z = H.sample_from_poe_subset(model, [0, 1], data, mcmc_steps=1, K=30,
                                         divide_prior=False, z0=z0, rho=t(rho), u=t(u))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (4, 0)
        out[dev.type] = (z0.double().cpu(), z.reshape(120, 2).double().cpu())
    (z0_c, z_c), (z0_r, z_r) = out["cuda"], out["cpu"]
    assert torch.equal((z_c != z0_c).any(1), (z_r != z0_r).any(1))
    scale = z_r.abs().max()
    assert ((z0_c - z0_r).abs().max() / scale).item() <= 1e-4
    assert ((z_c - z_r).abs().max() / scale).item() <= 1e-4


@pytest.mark.cuda
def test_hmc_graph_replays_the_eager_chain(card, monkeypatch):
    """On the card the chain evaluates ln q and its gradient by replaying one
    captured CUDA graph: 5 HMC steps over the circles JMVAE-NF's experts
    (4 rows x 30 chains) from the same start, momenta and accept-uniforms
    give the samples (to 1e-6) and the acceptance of the eager evaluation,
    and one evaluation at a new point the eager one's values (the same
    kernels on the same inputs)."""
    from mmvae_tpu_torch.data import synthetic
    from mmvae_tpu_torch.eval import hmc as H

    d = synthetic.make_circles_squares(dataset_size=8, n_repeat=1, seed=3)
    _, model = _circles_jnf(card, torch.float32)
    data = [torch.tensor(d[k][:4], device=card, dtype=torch.float32)
            for k in ("squares_train", "circles_train")]
    gen = torch.Generator().manual_seed(7)
    z0, rho, u = (torch.randn(*s, generator=gen).to(card) for s in ((120, 2), (5, 120, 2),
                                                                    (5, 120)))
    u = u.abs() / 3
    kw = dict(mcmc_steps=5, K=30, return_acceptance=True, z0=z0, rho=rho, u=u)
    with torch.no_grad():
        graphed, acc_g = H.sample_from_poe_subset(model, [0, 1], data, **kw)
        dens = model.poe_density([0, 1], [torch.cat([x] * 30) for x in data])
        evaluate = H._evaluator(dens, z0)
        z1 = z0 + 0.1
        for got, want in zip(evaluate(z1), H._log_q_and_grad(dens, z1)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        monkeypatch.setattr(H, "_evaluator",
                            lambda log_density, z: lambda zz: H._log_q_and_grad(log_density, zz))
        eager, acc_e = H.sample_from_poe_subset(model, [0, 1], data, **kw)
    torch.testing.assert_close(graphed, eager, rtol=1e-6, atol=1e-6)
    assert float(acc_g) == float(acc_e) > 0


@pytest.mark.cuda
def test_circles_jnf_step_on_card_matches_f64_cpu(card):
    """A post-warmup step of jmvae_nf.json (frozen joint, no_recon) at
    latent 2, B=16, on the card against float64 on the CPU with the same
    weights and noise: the objective rtol 1e-5, every trainable gradient
    within 1e-4 of its leaf's largest entry; no kernel launch (no_recon:
    the flows run their density direction only)."""
    from mmvae_tpu_torch.data import synthetic
    from mmvae_tpu_torch.objectives import m_jmvae_nf

    d = synthetic.make_circles_squares(dataset_size=32, n_repeat=1, seed=5)
    xs_np = [d["squares_train"][:16], d["circles_train"][:16]]
    eps_np = [np.random.default_rng(6).standard_normal((16, 2)) for _ in range(2)]
    res = {}
    for dev, dtype in ((card, torch.float32), (torch.device("cpu"), torch.float64)):
        cfg, model = _circles_jnf(dev, dtype)
        model.train()
        ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
        obj, _ = m_jmvae_nf(model, [torch.tensor(x, device=dev, dtype=dtype) for x in xs_np],
                            registry.build(cfg).spec,
                            noise=[torch.tensor(e, device=dev, dtype=dtype) for e in eps_np],
                            epoch=16, warmup=15, past_warmup=True, frozen_joint=True)
        named = [(n, p) for n, p in model.named_parameters()
                 if "joint_encoder" not in n and "decoder" not in n]
        grads = torch.autograd.grad(obj, [p for _, p in named])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (0, 0)
        res[dev.type] = (obj.item(), [g.double().cpu() for g in grads])
    assert math.isclose(res["cuda"][0], res["cpu"][0], rel_tol=1e-5)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_jnf_mnist_fashion_step_on_card(card):
    """A post-warmup jnf_mnist_fashion train step on the card (conv MNIST
    nets with BatchNorm, latent 20, B=16): 4 forward and 4 backward
    launches, a finite loss, no skipped step, and the BatchNorm statistics
    moved (the unimodal encoders' and the decoders' through compute_kld)."""
    cfg = ExperimentConfig.from_json(JNF)
    cfg.model = "jnf_mnist_fashion"
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device=card)
    trainer.init_parameters()
    trainer.init_opt_state(past_warmup=True, amsgrad=False)
    gen = torch.Generator().manual_seed(24)
    xs = [torch.rand(16, 1, 28, 28, generator=gen).to(card) for _ in range(2)]
    stats = {n: b.clone() for n, b in bundle.model.named_buffers() if n.endswith(".var")}
    ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
    loss, details = trainer.train_step(xs, cfg.learning_rate, epoch=cfg.warmup)
    torch.cuda.synchronize()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == (4, 4)
    assert torch.isfinite(loss) and details["nan_skipped"].item() == 0.0
    moved = [n for n, b in bundle.model.named_buffers() if n in stats and not torch.equal(b, stats[n])]
    assert any("vaes.0.encoder" in n for n in moved) and any("decoder" in n for n in moved)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_kernels_at_latent_30(card, sign, s_bound):
    """Both kernels at D = 30, the trimodal JMVAE-NF-DCCA and TELBO-NF
    latent, at the rows of its paths: the forward against `unrolled_solve`
    at a TELBO-NF step's and HMC's start's 256 rows, a validate batch's 500
    and an IS call's 10,000; the backward with the reduction against
    autograd through it at 256 rows and a ragged tile of 37, for x, every
    weight and every bias."""
    d = 30
    ws, bs = _weights(card, seed=30, d=d)
    gen = torch.Generator().manual_seed(31)
    for n in (256, 37, 500, 10_000):
        x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                      for shape in ((n, d), (n, d), (n,)))
        with torch.no_grad():
            y, ld = ar_flow.kernel_forward(x, ws, bs, sign, s_bound)
            want = ar_flow.unrolled_solve(x, ws, bs, sign, s_bound)
        for got, ref in zip((y, ld), want):
            torch.testing.assert_close(got, ref, **TOL)
        if n > 256:
            continue
        tape = ar_flow.new_tape(x, ws)
        y, ld = ar_flow.kernel_forward(x, ws, bs, sign, s_bound, tape=tape)
        gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, s_bound)
        inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
        outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):],
                                      sign, s_bound)
        grads = torch.autograd.grad(outs, inputs, (gy, gld))
        for got, ref in zip([gx, *gws, *gbs], grads):
            torch.testing.assert_close(got, ref.detach(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 43, 64])  # MedMNIST's latent; the old limit + 1; CelebA's
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_kernels_at_latent_16_43_64(card, d, sign, s_bound):
    """Both kernels at the widths the first layer and head no longer stage
    (MADE widths [D, 128, 128, 128, 2D]; staging them as well, D = 43 and
    up would overflow shared memory): the forward against `unrolled_solve`, the
    backward with the reduction against autograd through it, for x, every
    weight and every bias, at a full tile, a ragged one and CelebA
    MMVAE-NF's K*B rows (N = 128, 37, 7,680)."""
    ws, bs = _weights(card, seed=24, d=d)
    gen = torch.Generator().manual_seed(25)
    for n in (128, 37, 7_680):
        x, gy, gld = (torch.randn(*shape, generator=gen).to(card)
                      for shape in ((n, d), (n, d), (n,)))
        tape = ar_flow.new_tape(x, ws)
        y, ld = ar_flow.kernel_forward(x, ws, bs, sign, s_bound, tape=tape)
        gx, gws, gbs = ar_flow.kernel_backward(x, y, gy, gld, tape, ws, sign, s_bound)
        inputs = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
        outs = ar_flow.unrolled_solve(inputs[0], inputs[1:1 + len(ws)], inputs[1 + len(ws):],
                                      sign, s_bound)
        want = torch.autograd.grad(outs, inputs, (gy, gld))
        for got, ref in zip([y, ld, gx, *gws, *gbs], [*outs, *want]):
            torch.testing.assert_close(got, ref.detach(), **TOL)


def _chip_smoke():
    """The repo's chip_smoke.py as a module (it imports torch only inside
    its functions): its `_ReluBranches` and `_SolveBranches`."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_iaf_jnf_step_on_card_matches_f64_cpu(card):
    """A post-warmup step of jmvae_nf.json with "flow": "iaf" (latent 20,
    B=16, full-width nets, frozen joint, unimodal reconstructions on) on the
    card against float64 on the CPU, the same weights and noise (the joint
    forward's, compute_kld's joint sample, each unimodal forward's), the CPU
    step on the card step's ReLU branches, the kernels' hidden ones read
    from their tapes (chip_smoke's `_ReluBranches`, `_SolveBranches`), each
    element on another branch within 1e-5 of 0: the objective rtol 1e-5,
    every trainable gradient within 1e-4 of its leaf's largest entry. On
    the card IAF's density direction (compute_kld) launches 4 forward and 4
    backward kernels, every one at sign -1."""
    import contextlib

    from mmvae_tpu_torch.nets import init_parameters
    from mmvae_tpu_torch.objectives import m_jmvae_nf

    smoke = _chip_smoke()
    cfg = ExperimentConfig.from_json(JNF)
    cfg.flow = "iaf"
    bundle = registry.build(cfg)
    init_parameters(bundle.model, torch.Generator().manual_seed(7))
    xs, eps = _card_batch(card, n_noise=4, seed=26)
    res, branches = {}, {}
    for dev, dtype in ((card, torch.float32), (torch.device("cpu"), torch.float64)):
        model = copy.deepcopy(bundle.model).to(dev, dtype).train()
        replay = None if dev.type == "cuda" else branches["cuda"].masks
        branches[dev.type] = smoke._ReluBranches(replay)
        kernels = (smoke._SolveBranches(branches["cuda"]) if dev.type == "cuda"
                   else contextlib.nullcontext())
        ar_flow.ar_solve.launches = ar_flow.ar_solve.backward_launches = 0
        ar_flow.ar_solve.sign_minus_launches = ar_flow.ar_solve.sign_minus_backward_launches = 0
        with branches[dev.type], kernels:
            obj, _ = m_jmvae_nf(model, [x.to(dev, dtype) for x in xs], bundle.spec,
                                noise=[e.to(dev, dtype) for e in eps], epoch=2, warmup=2,
                                past_warmup=True, frozen_joint=True)
            named = [(n, p) for n, p in model.named_parameters()
                     if "joint_encoder" not in n and "decoder" not in n]
            grads = torch.autograd.grad(obj, [p for _, p in named])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            a = ar_flow.ar_solve
            assert (a.launches, a.backward_launches) == (4, 4)
            assert (a.sign_minus_launches, a.sign_minus_backward_launches) == (4, 4)
        res[dev.type] = (obj.item(), [g.double().cpu() for g in grads])
    rb = branches["cpu"]
    assert len(rb.masks) == len(branches["cuda"].masks) and rb.flip_max_abs <= 1e-5
    assert math.isclose(res["cuda"][0], res["cpu"][0], rel_tol=1e-5)
    for (name, _), a, b in zip(named, res["cuda"][1], res["cpu"][1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30), name


@pytest.mark.cuda
def test_ddp_two_gloo_ranks_on_card_match_one_process(card, tmp_path):
    """Two ranks on the one card over gloo (chip_smoke's ddp_parity at
    B=16): a post-warmup jnf_mnist_fashion step (BatchNorm over the global
    batch, both kernels on each rank's 8 rows) against one process on the
    card, the objective rtol 1e-5, the ranks' all-reduced gradients equal
    and within 1e-4 of each leaf of the float64 CPU step on their ReLU
    branches, 4 forward and 4 backward launches a step on each rank, the
    parameters equal on both after 3 steps (the phase raises otherwise)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
    import chip_smoke

    spec = ("jnf_mnist_fashion", chip_smoke.JNF,
            dict(chip_smoke.JNF_RUN, model="jnf_mnist_fashion", dcca=False, synthetic_n=256,
                 batch_size=16), 4)
    launches = chip_smoke.phase_ddp_parity(str(tmp_path), specs=[spec])
    assert launches == {f"ddp_parity_jnf_mnist_fashion_gloo_rank{r}": (16, 16) for r in (0, 1)}


@pytest.mark.cuda
def test_umap_layout_on_card_matches_cpu(card):
    """The UMAP layout's epochs on the card against the CPU, float32, the
    same start and draws, at learning rate 0.1 over 30 epochs (where the
    CPU is within 2.4e-6 of JAX's loop): within 1e-4; and a default UMAP
    on the card keeps two blobs apart."""
    from mmvae_tpu_torch import embed

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 0.3, (20, 6)) + 4, rng.normal(0, 0.3, (20, 6))])
    x = x.astype(np.float32)
    idx, dists = embed._knn(x, 8)
    heads, tails, weights = embed._fuzzy_graph(idx, dists, 8)
    emb0 = embed.pca_init(x, 2, 0)
    draws = (rng.uniform(size=(30, len(heads))), rng.integers(0, len(x), (30, len(heads), 5)))
    kw = dict(a=1.5769434603113077, b=0.8950608779109733, n_epochs=30, neg_rate=5, lr=0.1,
              seed=0, draws=draws)
    on_card = embed._optimize_layout(emb0, heads, tails, weights, device=card, **kw)
    on_cpu = embed._optimize_layout(emb0, heads, tails, weights, device="cpu", **kw)
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)
    emb = embed.UMAP(n_neighbors=8, device=card).fit_transform(x)
    gap = np.linalg.norm(emb[:20].mean(0) - emb[20:].mean(0))
    spread = max(np.linalg.norm(emb[:20] - emb[:20].mean(0), axis=1).mean(),
                 np.linalg.norm(emb[20:] - emb[20:].mean(0), axis=1).mean())
    assert np.isfinite(emb).all() and gap > 2.0 * spread


@pytest.mark.cuda
def test_inception_on_card_matches_f64_cpu(card):
    """The FID net at torch's default init with randomised BatchNorm
    statistics, 4 images at 299 x 299: float32 on the card (TF32 off)
    against float64 on the CPU."""
    from mmvae_tpu_torch.eval import fid

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = fid.InceptionV3FID().eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, fid.FrozenBatchNorm):
                n = m.weight.numel()
                m.running_mean.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)
        x = torch.rand(4, 1, 28, 28, generator=torch.Generator().manual_seed(1))
        on_card = net.to(card)(fid.fid_preprocess(x.to(card))).double().cpu()
        ref = net.cpu().double()(fid.fid_preprocess(x.double()))
    assert ref.abs().max() > 1e-2
    np.testing.assert_allclose(on_card.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_linear_probes_on_card_match_cpu(card):
    """LinearSVC and the SGD probe on the card against the CPU, float64,
    the same data and shuffles."""
    from mmvae_tpu_torch.eval.linear import LinearSVC, SGDClassifier

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(10, 16)) * 1.5
    y = rng.integers(0, 10, 600)
    x = centers[y] + rng.normal(size=(600, 16))
    svc = [LinearSVC(device=d).fit(x[:400], y[:400]) for d in (card, "cpu")]
    scale = np.abs(svc[1].coef_).max()
    np.testing.assert_allclose(svc[0].coef_, svc[1].coef_, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(svc[0].intercept_, svc[1].intercept_, rtol=0, atol=1e-9 * scale)
    sgd = [SGDClassifier(device=d, generator=torch.Generator().manual_seed(0)).fit(x[:400], y[:400])
           for d in (card, "cpu")]
    assert sgd[0].n_iter_ == sgd[1].n_iter_
    np.testing.assert_allclose(sgd[0].coef_, sgd[1].coef_, rtol=1e-9, atol=1e-9)
    assert sgd[0].score(x[400:], y[400:]) == sgd[1].score(x[400:], y[400:])


@pytest.mark.cuda
def test_k_split_on_card_matches_one_process(card, tmp_path, monkeypatch):
    """chip_smoke's ksplit_parity at B=8: the flagship step with the K split
    on two gloo ranks sharing the card against one process (the phase
    raises otherwise)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "MMVAE_PARITY_B", 8)
    monkeypatch.setattr(chip_smoke, "KSPLIT_MESHES", ((1, 2),))
    chip_smoke.phase_ksplit_parity(str(tmp_path))
