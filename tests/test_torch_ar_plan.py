"""The plan and the three routes of the port's ar_solve kernels, and the
general backward's algorithm against the JAX package, on the CPU.

On a CUDA tensor `ar_solve` takes one of three pairs of Hopper kernels,
decided by `ops.ar_flow.route` from numbers alone: the 128-wide pair
(csrc/ar_flow.cu) wherever it takes the MADE, the general pair
(csrc/ar_flow_general.cu) wherever a thread-block cluster of at most 8 CTAs
holds the MADE's weights in shared memory, and the streamed pair
(csrc/ar_flow_streamed.cu) past that. The general pair's plan
(`general_plan`: the CTAs of a cluster, the rows of a tile, the bytes of
shared memory a CTA takes) is a copy of the library's; the card tests hold
the two equal. Here, without a card:

- the plan at every shape chip_smoke.py's `ar_solve_shapes` phase runs, on
  an H100 (132 SMs, 232,448 bytes a block): clusters of at most 8, no CTA
  past the limit, the least cluster whose shared memory holds the MADE;
- every width list that the route took before the general pair was
  redesigned (the 128-wide pair's sizes, or the streamed kernels' shared
  memory within the limit) still gets a kernel in both directions
  (hypothesis), and the streamed route only past 8 CTAs;
- `plain_general_backward`, the general backward's algorithm in plain
  PyTorch with its partial sums in its order (per cluster over its tiles,
  step by step, then over the clusters in order), against `jax.vjp` of
  JAX's `unrolled_solve` in float64 (1e-10 of each leaf's largest entry),
  at ragged rows and tiles of 4, 8 and 16 rows over 1 to 4 clusters, and
  at ReLU ties past step 0 (JAX's slope 1/2, 1e-12) with a slope-0 control
  that must miss.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.flows import build_masks
from mmvae_tpu_torch.ops import ar_flow

H100_SMEM, H100_SMS = 232_448, 132
TOL = 1e-10

# chip_smoke.py's ar_solve_shapes (hidden widths, D, rows) with their plans
# on an H100: (cluster, rows a tile) of the forward, then of the backward
PLANS = [
    (((64,) * 4, 20, 128), (1, 4), (1, 4)),
    (((64,) * 3, 20, 128), (1, 4), (1, 4)),
    (((128,) * 4, 20, 128), (2, 4), (4, 8)),
    (((128,) * 6, 20, 128), (2, 4), (4, 4)),
    (((256,) * 2, 64, 256), (4, 16), (4, 4)),
    (((100,) * 3, 16, 37), (1, 4), (1, 4)),
    (((96, 160, 64), 30, 256), (1, 4), (2, 8)),
    (((32,), 2, 128), (1, 4), (1, 4)),
    (((64,) * 4, 64, 7_680), (1, 16), (1, 8)),
    (((50,) * 3, 20, 128), (1, 4), (1, 4)),
    (((100,) * 6, 20, 128), (2, 4), (4, 8)),
    (((202,) * 4, 20, 37), (4, 4), (8, 4)),
    (((510, 22, 510), 64, 128), (4, 8), (4, 4)),
    (((128,) * 3, 20, 128), (1, 4), (2, 4)),  # the general pair forced at every config's MADE
]


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


@pytest.mark.parametrize("shape,forward,backward", PLANS)
def test_plan_at_every_smoke_shape(shape, forward, backward):
    hidden, d, n = shape
    widths = [d, *hidden, 2 * d]
    for is_backward, want in ((False, forward), (True, backward)):
        cluster, rows, need = ar_flow.general_plan(widths, is_backward, n, H100_SMS, H100_SMEM)
        assert (cluster, rows) == want
        assert need <= H100_SMEM
        # the least cluster whose shared memory holds the MADE at 4-row tiles
        if cluster > 1:
            smaller = ar_flow.general_layout_floats(widths, cluster // 2, 4, is_backward)
            assert 4 * smaller + ar_flow.GENERAL_STATIC_SMEM > H100_SMEM


def test_plan_bounds_over_a_grid():
    """No CTA past the limit, no cluster past 8, tiles of 4, 8 or 16 rows,
    and where there is no plan, even 8 CTAs at 4-row tiles overflow."""
    for d in (2, 5, 20, 64, 256):
        for h in (1, 7, 32, 100, 128, 256, 512, 1024):
            for n_hidden in (1, 2, 4, 8):
                widths = [d, *(h,) * n_hidden, 2 * d]
                for backward in (False, True):
                    for n in (1, 37, 128, 7_680):
                        plan = ar_flow.general_plan(widths, backward, n, H100_SMS, H100_SMEM)
                        if plan is None:
                            floats = ar_flow.general_layout_floats(widths, 8, 4, backward)
                            assert 4 * floats + ar_flow.GENERAL_STATIC_SMEM > H100_SMEM
                            continue
                        cluster, rows, need = plan
                        assert cluster in (1, 2, 4, 8) and rows in (4, 8, 16)
                        assert need <= H100_SMEM


def test_plan_rows_take_the_fewest_rounds():
    """Of the tiles of 4, 8 and 16 rows that shared memory holds, the plan
    takes the one with the fewest rounds of tiles over the clusters the card
    runs at once, the fewer rows on a tie."""
    for hidden, d in (((64,) * 4, 20), ((128,) * 6, 20), ((256,) * 2, 64), ((64,) * 4, 64)):
        widths = [d, *hidden, 2 * d]
        for backward in (False, True):
            for n in (1, 37, 128, 500, 529, 1_056, 2_112, 7_680, 10_000):
                cluster, rows, _ = ar_flow.general_plan(widths, backward, n, H100_SMS, H100_SMEM)
                slots = H100_SMS if cluster == 1 else 7 * H100_SMS // (8 * cluster)
                fits = [r for r in (4, 8, 16) if 4 * ar_flow.general_layout_floats(
                    widths, cluster, r, backward) + ar_flow.GENERAL_STATIC_SMEM <= H100_SMEM]
                rounds = {r: -(-(-(-n // r)) // slots) for r in fits}
                assert rows == min(fits, key=lambda r: (rounds[r], r))


def _took_before_the_redesign(widths, backward):
    """Whether the route took these widths before the general pair was
    redesigned: the 128-wide kernel's sizes, or the streamed route's scope
    (the same rule since that pair's first kernels) within the limit."""
    fast = ar_flow.fast_smem_bytes(widths, backward)
    if (fast is not None and fast <= H100_SMEM
            and not (backward and len(widths) - 2 > ar_flow.FAST_MAX_BACKWARD_HIDDEN)):
        return True
    streamed = ar_flow.streamed_scope_bytes(widths, backward)
    return streamed is not None and streamed <= H100_SMEM


@settings(max_examples=300, deadline=None, database=None)
@given(d=st.integers(2, 256), hidden=st.lists(st.integers(1, 2_048), min_size=1, max_size=63),
       backward=st.booleans())
def test_every_shape_the_route_took_still_routes(d, hidden, backward):
    widths = [d, *hidden, 2 * d]
    if not _took_before_the_redesign(widths, backward):
        with pytest.raises(ValueError, match="shared memory"):
            ar_flow.route(widths, backward, H100_SMEM)
        return
    kind = ar_flow.route(widths, backward, H100_SMEM)
    plan = ar_flow.general_plan(widths, backward, 1, ar_flow.GENERAL_MAX_CLUSTER, H100_SMEM)
    assert kind in ("fast", "general", "streamed")
    if kind == "general":
        assert plan is not None
    if kind == "streamed":
        assert plan is None


def test_third_route_past_eight_ctas():
    """Two hidden layers of 1,024: eight CTAs cannot hold them, so both
    directions take the streamed kernels."""
    widths = [16, 1024, 1024, 32]
    for backward in (False, True):
        assert ar_flow.general_plan(widths, backward, 128, H100_SMS, H100_SMEM) is None
        assert ar_flow.route(widths, backward, H100_SMEM) == "streamed"
        assert ar_flow.streamed_scope_bytes(widths, backward) <= H100_SMEM


def test_general_forward_beside_the_streamed_backward():
    """Two hidden layers of 512 at D = 64: eight CTAs hold the forward's
    weights (one copy of each layer) but not the backward's (the weights
    and their gradients' sums), so `ar_solve` runs the general forward on
    clusters of 8 and the streamed backward, on one tape."""
    widths = [64, 512, 512, 128]
    assert ar_flow.general_plan(widths, False, 128, H100_SMS, H100_SMEM)[:2] == (8, 4)
    assert ar_flow.general_plan(widths, True, 128, H100_SMS, H100_SMEM) is None
    assert [ar_flow.route(widths, b, H100_SMEM) for b in (False, True)] == ["general", "streamed"]


@pytest.mark.parametrize("kind", ["fast", "general", "streamed"])
@pytest.mark.parametrize("sign", [-1, 1])
def test_each_pair_counts_its_own_launches(kind, sign):
    """A launch of one pair adds one to that pair's count and to the total,
    at sign -1 to both sign -1 counts too, and to no other pair's count."""
    a = ar_flow.ar_solve
    for what in ("launches", "backward_launches"):
        before = {k: getattr(a, k) for k in ar_flow.COUNTS}
        ar_flow._count(kind, what, sign)
        got = {k: getattr(a, k) - before[k] for k in ar_flow.COUNTS}
        minus = f"sign_minus_{what}"
        want = {what: 1, f"{kind}_{what}": 1, minus: int(sign < 0),
                f"{kind}_{minus}": int(sign < 0)}
        assert got == {k: want.get(k, 0) for k in ar_flow.COUNTS}
        for k, v in before.items():
            setattr(a, k, v)


def test_streamed_entries_take_cuda_tensors_only():
    ws, bs = _weights(50, 5, (8, 8))
    x = torch.zeros(4, 5, dtype=torch.float32)
    wt, bt = [torch.tensor(w, dtype=torch.float32) for w in ws], [
        torch.tensor(b, dtype=torch.float32) for b in bs]
    a = ar_flow.ar_solve
    before = (a.general_launches, a.general_backward_launches, a.streamed_launches,
              a.streamed_backward_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.streamed_forward(x, wt, bt, 1)
    tape = ar_flow.new_tape(x, wt)
    with pytest.raises(ValueError, match="CUDA"):
        ar_flow.streamed_backward(x, x, x, x[:, 0], tape, wt, 1)
    assert (a.general_launches, a.general_backward_launches, a.streamed_launches,
            a.streamed_backward_launches) == before


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
        _, vjp = jax.vjp(
            lambda xx, ww, bb: jax_ar.unrolled_solve(xx, list(ww), list(bb), sign, s_bound),
            jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
        gx, gw, gb = vjp((jnp.asarray(ry), jnp.asarray(rld)))
        return [np.asarray(a) for a in (gx, *gw, *gb)]


def _general(x, ws, bs, sign, s_bound, ry, rld, clusters, rows):
    """The general kernels' algorithm in plain PyTorch: the recording
    forward, then the general backward over `clusters` clusters of tiles of
    `rows` rows."""
    xt = torch.tensor(x)
    y, _, tape = ar_flow.plain_tape(xt, _t(ws), _t(bs), sign, s_bound)
    gx, gws, gbs = ar_flow.plain_general_backward(xt, y, torch.tensor(ry), torch.tensor(rld),
                                                  tape, _t(ws), sign, s_bound, clusters, rows)
    return y, tape, [gx, *gws, *gbs]


@pytest.mark.parametrize("hidden", [(8,), (12, 20, 8), (32,) * 3])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_plain_general_backward_matches_jax(hidden, sign, s_bound):
    """37 rows (a ragged last tile at every tile size) over 1 to 4 clusters
    of 4-, 8- and 16-row tiles: x's, every weight's and every bias's
    gradient as JAX's, in float64."""
    d, n = 5, 37
    ws, bs = _weights(70 + len(hidden) + hidden[0], d, hidden)
    rng = np.random.default_rng(71 + hidden[0])
    x, ry = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    rld = rng.standard_normal(n)
    want = _jax_vjp(x, ws, bs, sign, s_bound, ry, rld)
    for clusters, rows in ((1, 4), (2, 4), (3, 8), (4, 16)):
        _, _, got = _general(x, ws, bs, sign, s_bound, ry, rld, clusters, rows)
        for ours, theirs in zip(got, want):
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=TOL,
                                       atol=TOL * max(np.abs(theirs).max(), 1.0),
                                       err_msg=f"clusters {clusters}, rows {rows}")


def test_plain_general_backward_sums_per_cluster_then_in_order():
    """In float32 the clusters' partial sums, each over its own tiles in
    order, added in cluster order, give the bits of the whole: cluster b's
    partial is the backward of its tiles' rows taken as one cluster."""
    d, hidden, n, rows, clusters = 6, (16, 24, 16), 53, 4, 3
    ws, bs = _weights(80, d, hidden)
    rng = np.random.default_rng(81)
    x, gy = (torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32) for _ in range(2))
    gld = torch.tensor(rng.standard_normal(n), dtype=torch.float32)
    wt = [torch.tensor(w, dtype=torch.float32) for w in ws]
    bt = [torch.tensor(b, dtype=torch.float32) for b in bs]
    y, _, tape = ar_flow.plain_tape(x, wt, bt, 1, 8.0)
    gx, gws, gbs = ar_flow.plain_general_backward(x, y, gy, gld, tape, wt, 1, 8.0, clusters, rows)
    n_tiles = -(-n // rows)
    total = None
    for b in range(clusters):
        idx = torch.cat([torch.arange(t * rows, min(n, (t + 1) * rows))
                         for t in range(b, n_tiles, clusters)])
        sub = ar_flow.Tape([z[:, idx] for z in tape.z], tape.s[:, idx])
        part_gx, pws, pbs = ar_flow.plain_general_backward(
            x[idx], y[idx], gy[idx], gld[idx], sub, wt, 1, 8.0, 1, rows)
        assert torch.equal(part_gx, gx[idx])
        total = pws + pbs if total is None else [t + p for t, p in zip(total, pws + pbs)]
    for ours, theirs in zip([*gws, *gbs], total):
        assert torch.equal(ours, theirs)


@pytest.mark.parametrize("sign", [-1, 1])
def test_plain_general_backward_at_ties(sign):
    """At MADE's zero biases, with y_0 > 0 and the first layer's degree-0
    units on negative weights, the later layers' degree-0 units sit exactly
    at the ReLU's tie past step 0, where the head reads them: the general
    backward takes JAX's slope 1/2 there (JAX's `_ar_solve_bwd`, 1e-12) over
    2 clusters of 4-row tiles, and the same backward at slope 0 (the tied
    pre-activations moved just below 0) misses JAX."""
    d, hidden, n = 6, (16, 24, 16, 16), 11
    ws, bs = _weights(31, d, hidden)
    bs = [np.zeros(b.shape) for b in bs]
    deg0 = np.flatnonzero((ws[0] != 0).sum(axis=0) == 1)
    assert len(deg0) and (ws[0][1:, deg0] == 0).all()
    ws[0][0, deg0] = -np.abs(ws[0][0, deg0])
    rng = np.random.default_rng(32)
    x, ry = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    x[:, 0] = np.abs(x[:, 0])
    rld = rng.standard_normal(n)
    with _x64():
        res = (jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
        gx, gw, gb = jax_ar._ar_solve_bwd(sign, 0.0, res, (jnp.asarray(ry), jnp.asarray(rld)))
        want = [np.asarray(a) for a in (gx, *gw, *gb)]
    y, tape, got = _general(x, ws, bs, sign, 0.0, ry, rld, 2, 4)
    assert sum(int((z[1:] == 0).sum()) for z in tape.z) > 0
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-12, atol=1e-12)
    below = ar_flow.Tape([torch.where(z == 0, -1e-300, z) for z in tape.z], tape.s)
    _, gws, gbs = ar_flow.plain_general_backward(torch.tensor(x), y, torch.tensor(ry),
                                                 torch.tensor(rld), below, _t(ws), sign, 0.0,
                                                 2, 4)
    assert any(not np.allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
               for ours, theirs in zip([*gws, *gbs], want[1:]))
