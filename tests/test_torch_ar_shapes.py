"""The port's ar_solve at every MADE shape JAX's Pallas solve takes, against
the JAX package on the CPU.

On a CUDA tensor `ar_solve` runs the 128-wide Hopper kernels where they take
the MADE's widths, the general kernels (csrc/ar_flow_general.cu) wherever a
cluster of at most 8 CTAs holds the MADE, and the streamed kernels
(csrc/ar_flow_streamed.cu) past that, as `ops.ar_flow.route` decides from
the widths, the direction and the device's shared-memory limit. Here,
without a card:

- the port's MAF and IAF built with other widths than every config's
  (`hidden_size` 64 with `n_hidden_in_made` 4, 100 with 2), and a MADE of
  mixed widths, against JAX's flax modules with the same weights (JAX's
  init moved off its zero biases, carried by `bridge.load_jax_params`):
  y, the log-det and every leaf's gradient in float64, rtol 1e-6 and 1e-6
  of each leaf's largest entry (float64 round-off over a few hundred
  operations is far below it). JAX's flows run their sequential direction
  unrolled (`use_fused=False`); the port's, on CPU tensors, the plain solve;
- the streamed backward's algorithm, `plain_chain` with `sum_grads` after
  the recording forward `plain_tape`, against `jax.vjp` of JAX's
  `unrolled_solve` in float64 at hidden widths 32, 100 and 256 and 1, 4
  and 6 hidden layers, both signs, s_bound 0 and 8 (1e-10), and at MADE's
  zero biases with ReLU ties past step 0, where JAX's jnp.maximum passes half
  the gradient (1e-12), with a slope-0 control that must miss;
- `route` at the H100's 232,448 bytes a block: every MADE the repo's 96
  configs build stays on the 128-wide pair in both directions, the shapes
  it refuses go to the general pair, and a wide grid of the shapes JAX
  takes gets a kernel in both directions (tests/test_torch_ar_plan.py holds
  the general pair's plan and the streamed route).

The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py's `ar_solve_shapes` phase).
"""

import contextlib
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.flows import IAF as JIAF
from mmvae_tpu.flows import MAF as JMAF
from mmvae_tpu.flows.made import MADE as JMADE
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.flows import IAF, MADE, MAF, build_masks
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.ops import ar_flow

H100_SMEM = 232_448  # shared memory a block may opt in to on an H100
FLOW_TOL = 1e-6
CHAIN_TOL = 1e-10
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_params(jmodule, x, seed):
    """JAX's init of `jmodule`, every leaf moved by uniform(-0.05, 0.05) so
    that no bias sits at 0, in float64."""
    rng = np.random.default_rng(seed)
    params = jmodule.init(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.float32))["params"]
    return jax.tree.map(lambda a: np.asarray(a, np.float64) + rng.uniform(-0.05, 0.05, a.shape),
                        params)


def _port_grads(module, grads):
    """The port's parameter gradients as the JAX params tree's leaves."""
    saved = [p.detach().clone() for p in module.parameters()]
    with torch.no_grad():
        for p, g in zip(module.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(module)))
        for p, s in zip(module.parameters(), saved):
            p.copy_(s)
    return tree


def _assert_leaves(ours, theirs, tol):
    assert sorted(ours) == sorted(theirs)
    for path, g in theirs.items():
        scale = max(np.abs(g).max(), 1e-300)
        np.testing.assert_allclose(ours[path], g, rtol=tol, atol=tol * scale,
                                   err_msg="/".join(path))


def _compare(module, jmodule, params, x, call, jcall, seed):
    """y, the log-det, and the gradient of sum(y * r) + sum(logdet * r') for
    x and every parameter: the port's `call` against JAX's method `jcall`."""
    rng = np.random.default_rng(seed)
    ry, rld = rng.standard_normal(x.shape), rng.standard_normal(x.shape[:-1])
    with _x64():
        def f(p, xj):
            y, ld = jmodule.apply({"params": p}, xj, method=jcall)
            return jnp.sum(y * ry) + jnp.sum(ld * rld), (y, ld)

        (_, (jy, jld)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y, ld = call(module, xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=FLOW_TOL, atol=FLOW_TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=FLOW_TOL,
                               atol=FLOW_TOL)
    grads = torch.autograd.grad((y * torch.tensor(ry)).sum() + (ld * torch.tensor(rld)).sum(),
                                [xt, *module.parameters()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=FLOW_TOL,
                               atol=FLOW_TOL * np.abs(np.asarray(jgx)).max())
    _assert_leaves(_port_grads(module, grads[1:]), dict(_flat(jgp)), FLOW_TOL)


@pytest.mark.parametrize("hidden_size,n_hidden", [(64, 4), (100, 2)])
@pytest.mark.parametrize("flow", ["maf", "iaf"])
def test_flows_at_other_widths_match_jax(flow, hidden_size, n_hidden):
    """MAF's sampling and IAF's density direction (the sequential ones,
    through `ar_solve`) of flows built with `hidden_size` and
    `n_hidden_in_made` other than every config's: on the card the general
    kernels take them (a 4 x 64 MADE, a 2 x 100 one)."""
    d, n = 4, 3
    cls, jcls, method = (MAF, JMAF, "inverse") if flow == "maf" else (IAF, JIAF, "forward")
    jmodule = jcls(features=d, hidden_size=hidden_size, n_hidden_in_made=n_hidden,
                   use_fused=False)
    x = np.random.default_rng(20).standard_normal((n, d))
    params = _jax_params(jmodule, x, 21)
    module = cls(d, hidden_size=hidden_size, n_hidden_in_made=n_hidden).double()
    load_jax_params(module, params)
    widths = [w.shape[1] for w in module.made[0].masked_layer_params()[0]]
    assert widths == [hidden_size] * n_hidden + [2 * d]
    _compare(module, jmodule, params, x, lambda m, xt: getattr(m, method)(xt), method, 22)


@pytest.mark.parametrize("sign,s_bound", [(1, 0.0), (-1, 8.0)])
def test_made_of_mixed_widths_matches_jax(sign, s_bound):
    """A MADE whose hidden layers differ in width (24, 40, 16), which no flow
    constructor builds but JAX's Pallas solve takes: the port's `ar_solve`
    over its masked parameters against JAX's `ar_solve` VJP (`_ar_solve_bwd`,
    jax.vjp of `unrolled_solve`) over JAX's, for x and every parameter."""
    d, hidden, n = 4, (24, 40, 16), 3
    jmade = JMADE(features=d, hidden_sizes=hidden)
    x = np.random.default_rng(23).standard_normal((n, d))
    params = _jax_params(jmade, x, 24)
    made = MADE(d, hidden).double()
    load_jax_params(made, params)

    def jsolve(self, xj):
        ws, bs = self.masked_layer_params()
        return jax_ar.unrolled_solve(xj, ws, bs, sign, s_bound)

    def call(module, xt):
        ws, bs = module.masked_layer_params()
        return ar_flow.ar_solve(xt, ws, bs, sign, s_bound)

    _compare(made, jmade, params, x, call, jsolve, 25)


def _weights(seed, d, hidden):
    """Masked MADE weights (in, out) and biases, float64 numpy."""
    rng = np.random.default_rng(seed)
    masks, out_mask = build_masks(d, hidden)
    masks = masks + [np.concatenate([out_mask, out_mask], axis=1)]
    ws = [rng.standard_normal(m.shape) / np.sqrt(m.shape[0]) * m for m in masks]
    bs = [rng.standard_normal(m.shape[1]) * 0.1 for m in masks]
    return ws, bs


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _jax_vjp(x, ws, bs, sign, s_bound, ry, rld):
    with _x64():
        (y, ld), vjp = jax.vjp(
            lambda xx, ww, bb: jax_ar.unrolled_solve(xx, list(ww), list(bb), sign, s_bound),
            jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
        gx, gw, gb = vjp((jnp.asarray(ry), jnp.asarray(rld)))
        return [np.asarray(a) for a in (y, ld, gx, *gw, *gb)]


def _general_chain(x, ws, bs, sign, s_bound, ry, rld):
    """The streamed kernels' algorithm in plain PyTorch: the recording
    forward, the reverse chain that keeps every step's deltas, the sums."""
    xt = torch.tensor(x)
    y, ld, tape = ar_flow.plain_tape(xt, _t(ws), _t(bs), sign, s_bound)
    gx, deltas, head = ar_flow.plain_chain(xt, y, torch.tensor(ry), torch.tensor(rld), tape,
                                           _t(ws), sign, s_bound)
    gws, gbs = ar_flow.sum_grads(y, tape, deltas, head)
    return y, ld, tape, (gx, deltas, head), [gx, *gws, *gbs]


@pytest.mark.parametrize("h", [32, 100, 256])
@pytest.mark.parametrize("n_hidden", [1, 4, 6])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_general_chain_matches_jax(h, n_hidden, sign, s_bound):
    """`plain_chain` and `sum_grads` give JAX's gradients for x, every weight
    and every bias; the deltas have the shapes the kernel writes."""
    d, n = 4, 3
    ws, bs = _weights(100 + h + n_hidden, d, (h,) * n_hidden)
    rng = np.random.default_rng(h + n_hidden)
    x, ry = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    rld = rng.standard_normal(n)
    want = _jax_vjp(x, ws, bs, sign, s_bound, ry, rld)
    y, ld, _, (_, deltas, head), grads = _general_chain(x, ws, bs, sign, s_bound, ry, rld)
    assert [tuple(t.shape) for t in deltas] == [(d, n, h)] * n_hidden
    assert tuple(head.shape) == (d, n, 2)
    for ours, theirs in zip([y, ld, *grads], want):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=CHAIN_TOL,
                                   atol=CHAIN_TOL * max(np.abs(theirs).max(), 1.0))


@pytest.mark.parametrize("sign", [-1, 1])
def test_general_chain_matches_jax_at_ties(sign):
    """At MADE's zero biases, with y_0 > 0 and the first layer's degree-0
    units on negative weights, the later layers' degree-0 units sit exactly
    at the ReLU's tie past step 0, where the head reads them: the streamed
    chain takes JAX's slope 1/2 there (JAX's `_ar_solve_bwd`, 1e-12), and
    the same chain at slope 0 (the tied pre-activations moved just below 0)
    misses JAX."""
    d, hidden = 6, (16, 24, 16, 16)
    ws, bs = _weights(31, d, hidden)
    bs = [np.zeros(b.shape) for b in bs]
    deg0 = np.flatnonzero((ws[0] != 0).sum(axis=0) == 1)
    assert len(deg0) and (ws[0][1:, deg0] == 0).all()
    ws[0][0, deg0] = -np.abs(ws[0][0, deg0])
    rng = np.random.default_rng(32)
    x, ry = rng.standard_normal((4, d)), rng.standard_normal((4, d))
    x[:, 0] = np.abs(x[:, 0])
    rld = rng.standard_normal(4)
    with _x64():
        res = (jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
        gx, gw, gb = jax_ar._ar_solve_bwd(sign, 0.0, res, (jnp.asarray(ry), jnp.asarray(rld)))
        want = [np.asarray(a) for a in (gx, *gw, *gb)]
    y, _, tape, _, grads = _general_chain(x, ws, bs, sign, 0.0, ry, rld)
    assert sum(int((z[1:] == 0).sum()) for z in tape.z) > 0
    for ours, theirs in zip(grads, want):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-12, atol=1e-12)
    below = ar_flow.Tape([torch.where(z == 0, -1e-300, z) for z in tape.z], tape.s)
    chain = ar_flow.plain_chain(torch.tensor(x), y, torch.tensor(ry), torch.tensor(rld), below,
                                _t(ws), sign, 0.0)
    gws, gbs = ar_flow.sum_grads(y, below, chain[1], chain[2])
    assert any(not np.allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
               for ours, theirs in zip([*gws, *gbs], want[1:]))


def _config_made_widths():
    """The layer widths of every MADE that the repo's configs build."""
    widths = set()
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.json"), recursive=True))
    assert len(paths) == 96
    for path in paths:
        flow = registry._flow(ExperimentConfig.from_json(path))
        if isinstance(flow, (MAF, IAF)):
            for made in flow.made:
                ws, _ = made.masked_layer_params()
                widths.add((made.features, *[w.shape[1] for w in ws]))
    return widths


def test_route_keeps_every_config_on_the_128_wide_pair():
    widths = _config_made_widths()
    assert sorted(w[0] for w in widths) == [2, 16, 20, 30, 64]
    for w in widths:
        assert w[1:-1] == (128, 128, 128)
        for backward in (False, True):
            assert ar_flow.route(list(w), backward, H100_SMEM) == "fast"


@pytest.mark.parametrize("hidden,d,expected", [
    ((64,) * 3, 20, ("general", "general")),
    ((128,) * 4, 20, ("fast", "general")),  # the 128-wide backward's shared memory refuses 4
    ((128,) * 4, 64, ("fast", "general")),
    ((128,) * 5, 20, ("general", "general")),  # and the forward's 5
    ((128,) * 6, 20, ("general", "general")),
    ((256,) * 2, 64, ("general", "general")),
    ((100,) * 3, 16, ("general", "general")),
    ((96, 160, 64), 30, ("general", "general")),
    ((32,), 2, ("general", "general")),
    ((64,) * 4, 64, ("general", "general")),
    ((128,) * 3, 20, ("fast", "fast")),
    ((128,) * 1, 2, ("fast", "fast")),
])
def test_route_sends_the_refused_shapes_to_the_general_pair(hidden, d, expected):
    widths = [d, *hidden, 2 * d]
    got = tuple(ar_flow.route(widths, backward, H100_SMEM) for backward in (False, True))
    assert got == expected
    fast = [ar_flow.fast_smem_bytes(widths, backward) for backward in (False, True)]
    assert (fast == [None, None]) == (set(hidden) != {128})


def test_route_takes_every_shape_jax_takes():
    """A grid of the shapes JAX's Pallas solve builds for: D from 2 to 256,
    1 to 16 hidden layers of 1 to 2,048 units, ragged and mixed widths; each
    direction gets a kernel (the streamed one past what 8 CTAs hold). Past
    what a block's shared memory holds (a hidden layer of 16,384 units) the
    route refuses, before any launch."""
    rng = np.random.default_rng(40)
    shapes = [(d, (h,) * n) for d in (2, 3, 20, 64, 256) for n in (1, 2, 3, 4, 5, 8, 16)
              for h in (1, 7, 32, 100, 128, 256, 1024, 2048)]
    shapes += [(int(rng.integers(2, 128)), tuple(int(w) for w in rng.integers(1, 1024, size=n)))
               for n in rng.integers(1, 9, size=50)]
    for d, hidden in shapes:
        for backward in (False, True):
            assert ar_flow.route([d, *hidden, 2 * d], backward, H100_SMEM) in (
                "fast", "general", "streamed")
    with pytest.raises(ValueError, match="shared memory"):
        ar_flow.route([20, 16_384, 40], False, H100_SMEM)


def test_general_entries_take_cuda_tensors_only():
    ws, bs = _weights(50, 5, (8, 8))
    x = torch.zeros(4, 5, dtype=torch.float32)
    wt, bt = [torch.tensor(w, dtype=torch.float32) for w in ws], [
        torch.tensor(b, dtype=torch.float32) for b in bs]
    before = (ar_flow.ar_solve.general_launches, ar_flow.ar_solve.general_backward_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.general_forward(x, wt, bt, 1)
    tape = ar_flow.new_tape(x, wt)
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.general_backward(x, x, x, x[:, 0], tape, wt, 1)
    assert (ar_flow.ar_solve.general_launches,
            ar_flow.ar_solve.general_backward_launches) == before
