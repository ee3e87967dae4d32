"""Port of the fused autoregressive solve against the JAX package.

The port's plain `unrolled_solve` and its autograd Function (which on CPU
tensors runs the plain version) are held against JAX `unrolled_solve` and
`ar_solve` (Pallas in interpret mode on CPU), with real MADE masks, both
signs, s_bound 0 and 8, leading dims (K, B, D), and gradients with respect
to x, every weight and every bias. Both sides are float32 on the CPU; they
differ only in summation order, hence rtol/atol 1e-5 on values and 1e-4 on
gradients; at MADE's zero initial biases, where hidden units sit exactly at
the ReLU's tie and JAX's jnp.maximum passes half the gradient, both are
float64 and agree to 1e-12. The Hopper kernel itself runs only on a CUDA card: its tests
are marked `cuda` and live in tests/test_torch_cuda.py, which imports no
JAX so that it runs on a machine with a card and no JAX stack.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.flows.made import build_masks as jax_build_masks
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.flows.made import build_masks
from mmvae_tpu_torch.ops import ar_flow

D, H, N_HIDDEN = 5, 8, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores (a CLI epoch here took 50 times as long
    beside five other workers as alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(seed, d=D, h=H, n_hidden=N_HIDDEN, scale=0.5):
    """Masked MADE weights (in, out) and biases, as numpy float32."""
    rng = np.random.default_rng(seed)
    masks, out_mask = build_masks(d, (h,) * n_hidden)
    masks = masks + [np.concatenate([out_mask, out_mask], axis=1)]
    ws = [(rng.standard_normal(m.shape) * scale / np.sqrt(m.shape[0]) * m).astype(np.float32)
          for m in masks]
    bs = [(rng.standard_normal(m.shape[1]) * 0.1).astype(np.float32) for m in masks]
    return ws, bs


def _t(arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


@pytest.mark.parametrize("features,hidden", [(2, (4,)), (5, (8, 8, 8)), (20, (128, 128, 128))])
def test_masks_match_jax(features, hidden):
    ours, our_out = build_masks(features, hidden)
    theirs, their_out = jax_build_masks(features, hidden)
    assert len(ours) == len(theirs)
    for a, b in zip(ours + [our_out], theirs + [their_out]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_solve_matches_jax(sign, s_bound):
    ws, bs = _weights(0)
    x = np.random.default_rng(1).standard_normal((2, 3, D)).astype(np.float32)
    y_ref, ld_ref = jax_ar.unrolled_solve(jnp.asarray(x), ws, bs, sign, s_bound)
    y_pal, ld_pal = jax_ar.ar_solve(jnp.asarray(x), ws, bs, sign, s_bound)
    launches = ar_flow.ar_solve.launches
    with torch.no_grad():
        y_plain, ld_plain = ar_flow.unrolled_solve(torch.tensor(x), _t(ws), _t(bs), sign, s_bound)
        y_fn, ld_fn = ar_flow.ar_solve(torch.tensor(x), _t(ws), _t(bs), sign, s_bound)
    assert ar_flow.ar_solve.launches == launches  # CPU tensors never launch the kernel
    assert y_fn.shape == (2, 3, D) and ld_fn.shape == (2, 3)
    for y, ld in [(y_plain, ld_plain), (y_fn, ld_fn)]:
        for yr, ldr in [(y_ref, ld_ref), (y_pal, ld_pal)]:
            np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(ld.numpy(), np.asarray(ldr), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sign,s_bound", [(-1, 0.0), (1, 8.0)])
def test_gradients_match_jax(sign, s_bound):
    ws, bs = _weights(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, D)).astype(np.float32)
    ry = rng.standard_normal((2, 3, D)).astype(np.float32)
    rld = rng.standard_normal((2, 3)).astype(np.float32)

    def loss(x_, ws_, bs_):
        y, ld = jax_ar.ar_solve(x_, list(ws_), list(bs_), sign, s_bound)
        return jnp.sum(y * ry) + jnp.sum(ld * rld)

    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), ws, bs)

    xt, wt, bt = torch.tensor(x, requires_grad=True), _t(ws, True), _t(bs, True)
    y, ld = ar_flow.ar_solve(xt, wt, bt, sign, s_bound)
    (torch.sum(y * torch.tensor(ry)) + torch.sum(ld * torch.tensor(rld))).backward()
    for ours, theirs in zip([xt, *wt, *bt], [gx, *gw, *gb]):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_plain_reverse_chain_matches_jax(sign, s_bound):
    """The backward kernel's algorithm on the CPU: the recording forward and
    the reverse chain, which sums the weight and bias gradients as it goes,
    give JAX's values and its gradients for x, every weight and every bias;
    leading dims (K, B, D) flattened to rows as `ar_solve` does."""
    ws, bs = _weights(8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, D)).astype(np.float32)
    ry = rng.standard_normal((2, 3, D)).astype(np.float32)
    rld = rng.standard_normal((2, 3)).astype(np.float32)

    def loss(x_, ws_, bs_):
        y, ld = jax_ar.ar_solve(x_, list(ws_), list(bs_), sign, s_bound)
        return jnp.sum(y * ry) + jnp.sum(ld * rld)

    y_ref, ld_ref = jax_ar.unrolled_solve(jnp.asarray(x), ws, bs, sign, s_bound)
    gx_ref, gw_ref, gb_ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), ws, bs)

    x2 = torch.tensor(x).reshape(-1, D)
    y, ld, tape = ar_flow.plain_tape(x2, _t(ws), _t(bs), sign, s_bound)
    np.testing.assert_allclose(y.reshape(2, 3, D).numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.reshape(2, 3).numpy(), np.asarray(ld_ref), rtol=1e-5, atol=1e-5)
    gx, gws, gbs = ar_flow.plain_backward(x2, y, torch.tensor(ry).reshape(-1, D),
                                          torch.tensor(rld).reshape(-1), tape, _t(ws), sign,
                                          s_bound)
    for ours, theirs in zip([gx.reshape(2, 3, D), *gws, *gbs], [gx_ref, *gw_ref, *gb_ref]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("d", [2, 20])
@pytest.mark.parametrize("sign,s_bound", [(-1, 0.0), (1, 8.0)])
def test_plain_reverse_chain_matches_jax_at_ties(d, sign, s_bound):
    """The reverse chain at MADE's zero initial biases, where every hidden
    unit whose masked inputs are all still 0 sits exactly at the ReLU's tie:
    float64, against JAX's own VJP of ar_solve (`_ar_solve_bwd`: jax.vjp of
    unrolled_solve, op by op), whose jnp.maximum passes half the gradient at
    a tie. The port's plain algorithm and its autograd Function give JAX's
    gradients for x, every weight and every bias to 1e-12.

    At step 0 every unit is tied, but no head column reads it. So here
    y_0 = x_0 > 0 (at zero biases y_0 = x_0) and the first layer's degree-0
    units, whose one input is y_0, carry negative weights: from step 1 on
    they are off, and the degree-0 units of the later layers, which the
    head's columns past 0 read, sit at the tie (counted as exact zeros of
    the port's plain tape past step 0). The same chain at slope 0 there
    (the tied pre-activations moved just below 0) misses JAX's gradients."""
    ws, bs = _weights(10 + d, d=d, h=32)
    ws, bs = [w.astype(np.float64) for w in ws], [np.zeros(b.shape) for b in bs]
    deg0 = np.flatnonzero((ws[0] != 0).sum(axis=0) == 1)
    assert len(deg0) and (ws[0][1:, deg0] == 0).all()
    ws[0][0, deg0] = -np.abs(ws[0][0, deg0])
    rng = np.random.default_rng(11 + d)
    x, ry = (rng.standard_normal((2, 3, d)) for _ in range(2))
    x[..., 0] = np.abs(x[..., 0])
    rld = rng.standard_normal((2, 3))
    with _x64():
        gx_ref, gw_ref, gb_ref = jax_ar._ar_solve_bwd(
            sign, s_bound, (jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                            tuple(map(jnp.asarray, bs))), (jnp.asarray(ry), jnp.asarray(rld)))
        want = [np.asarray(a) for a in (gx_ref, *gw_ref, *gb_ref)]

    x2 = torch.tensor(x).reshape(-1, d)
    y, _, tape = ar_flow.plain_tape(x2, _t(ws), _t(bs), sign, s_bound)
    assert sum(int((z[1:] == 0).sum()) for z in tape.z) > 0
    gx, gws, gbs = ar_flow.plain_backward(x2, y, torch.tensor(ry).reshape(-1, d),
                                          torch.tensor(rld).reshape(-1), tape, _t(ws), sign,
                                          s_bound)
    below = ar_flow.Tape([torch.where(z == 0, -1e-300, z) for z in tape.z], tape.s)
    slope0 = ar_flow.plain_backward(x2, y, torch.tensor(ry).reshape(-1, d),
                                    torch.tensor(rld).reshape(-1), below, _t(ws), sign, s_bound)
    assert any(not np.allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
               for ours, theirs in zip([*slope0[1], *slope0[2]], want[1:]))
    xt, wt, bt = torch.tensor(x, requires_grad=True), _t(ws, True), _t(bs, True)
    yt, ldt = ar_flow.ar_solve(xt, wt, bt, sign, s_bound)
    fn = torch.autograd.grad((yt * torch.tensor(ry)).sum() + (ldt * torch.tensor(rld)).sum(),
                             [xt, *wt, *bt])
    for got in ([gx.reshape(2, 3, d), *gws, *gbs], fn):
        for ours, theirs in zip(got, want):
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bad", ["1d", "d1", "head", "chain", "dtype", "hidden"])
def test_kernel_input_checks(bad):
    ws, bs = _weights(4)
    x = torch.zeros(4, D)
    wt, bt = _t(ws), _t(bs)
    if bad == "1d":
        x = torch.zeros(D)
    elif bad == "d1":
        x = torch.zeros(4, 1)
    elif bad == "head":
        wt[-1], bt[-1] = wt[-1][:, :-1], bt[-1][:-1]
    elif bad == "chain":
        wt[1] = torch.zeros(H + 1, H)
    elif bad == "dtype":
        x = x.double()
    with pytest.raises(ValueError, match="width 128" if bad == "hidden" else None):
        ar_flow._check(x, wt, bt)


def test_cpu_tensors_never_launch_the_kernel():
    ws, bs = _weights(6)
    x = torch.tensor(np.random.default_rng(7).standard_normal((4, D)).astype(np.float32),
                     requires_grad=True)
    before = (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches)
    y, ld = ar_flow.ar_solve(x, _t(ws), _t(bs), 1, 0.0)
    (y.sum() + ld.sum()).backward()
    assert (ar_flow.ar_solve.launches, ar_flow.ar_solve.backward_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.kernel_forward(x.detach(), _t(ws), _t(bs), 1)
    xd = x.detach()
    tape = ar_flow.new_tape(xd, _t(ws))
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.kernel_backward(xd, xd, xd, xd[:, 0], tape, _t(ws), 1)
