"""The plan of the port's streamed ar_solve kernels and the shapes `route`
sends them, on the CPU.

csrc/ar_flow_streamed.cu takes the MADEs that no cluster of 8 CTAs holds
(two hidden layers of 1,024, twelve of them, 512 x 2 backward at D = 64).
One cooperative launch runs every CTA the card holds at once, cut into row
groups: the CTAs of a group hold the slices of every hidden layer's
columns, resident in their shared memory or streamed through a ring of it
in blocks, and walk the group's row tiles. `streamed_plan` is the Python
copy of the library's plan; the card tests and chip_smoke.py hold the two
equal. Here, without a card, on an H100 (132 CTAs at once, 232,448 bytes a
block) and on smaller cards:

- the plan at the shapes chip_smoke.py runs through the streamed pair;
- over a grid of widths, rows and card sizes: every CTA within the limit,
  the grid within the CTAs the card runs at once, every row tile walked by
  exactly one group, every hidden layer's columns covered by exactly one
  CTA of a group, every streamed block within a ring slot, and the weights
  streamed wherever no resident layout fits;
- `route` sends the streamed pair exactly the shapes it sent before the
  redesign (no 8-CTA cluster holds them; the older kernels' shared memory
  fits: `streamed_scope_bytes`), and `streamed_plan` has a layout on an
  H100 for every shape it sends there, out to the scope's edges.
"""

import pytest
import torch

from mmvae_tpu_torch.ops import ar_flow

H100_SMEM, H100_CTAS = 232_448, 132

# chip_smoke.py's streamed shapes (hidden widths, D, rows) with their plans
# on an H100: (a ring slot's floats at most, 0 the weights resident; CTAs a
# group, rows a tile, groups) of the forward, then of the backward
PLANS = [
    (((1024,) * 2, 16, 128), (8192, 16, 16, 8), (8192, 16, 16, 8)),
    (((1024,) * 2, 16, 37), (0, 26, 8, 5), (0, 26, 8, 5)),
    (((1024,) * 2, 16, 3), (0, 24, 4, 1), (0, 24, 4, 1)),
    (((1024,) * 2, 16, 10_000), (8192, 4, 32, 33), None),
    (((1024,) * 12, 16, 128), (8192, 16, 16, 8), (8192, 16, 16, 8)),
    (((512,) * 2, 64, 128), None, (0, 8, 8, 16)),
    (((4000,), 64, 128), (0, 4, 4, 32), (0, 4, 4, 32)),
    (((1002,) * 2, 16, 128), (8192, 16, 16, 8), (8192, 32, 32, 4)),
    (((2048, 1024), 16, 128), (8192, 15, 16, 8), (8192, 16, 16, 8)),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _widths(hidden, d):
    return (d, *hidden, 2 * d)


@pytest.mark.parametrize("shape,forward,backward", PLANS)
def test_plan_at_the_smoke_shapes(shape, forward, backward):
    hidden, d, n = shape
    widths = _widths(hidden, d)
    for is_backward, want in ((False, forward), (True, backward)):
        if want is None:
            continue
        plan = ar_flow.streamed_plan(widths, is_backward, n, H100_CTAS, H100_SMEM)
        assert (plan.cap, plan.ctas, plan.rows, plan.groups) == want
        assert plan.bytes <= H100_SMEM
        assert ar_flow.route(widths, is_backward, H100_SMEM) == "streamed"


def _resident_fits(widths, backward, ctas, limit):
    """Whether any C of at most `ctas` CTAs holds the weights resident at
    4-row tiles."""
    lays = [ar_flow.streamed_layout(widths, c, 4, backward, 0) for c in range(1, ctas + 1)]
    return any(lay is not None and 4 * lay.floats + ar_flow.STREAMED_STATIC_SMEM <= limit
               for lay in lays)


SHAPES = [((1024,) * 2, 16), ((512,) * 2, 64), ((1024,) * 12, 16), ((100,) * 3, 16),
          ((96, 1500, 64), 30), ((2048,), 8), ((300, 700, 300, 700), 20)]


@pytest.mark.parametrize("hidden,d", SHAPES)
@pytest.mark.parametrize("ctas,limit", [(H100_CTAS, H100_SMEM), (24, 101_376)])
def test_plan_bounds_over_a_grid(hidden, d, ctas, limit):
    widths = _widths(hidden, d)
    L = len(hidden)
    for backward in (False, True):
        streams = not _resident_fits(widths, backward, ctas, limit)
        for n in (1, 3, 37, 128, 500, 10_000):
            plan = ar_flow.streamed_plan(widths, backward, n, ctas, limit)
            if plan is None:
                continue
            assert plan.bytes <= limit
            assert 1 <= plan.groups * plan.ctas <= ctas
            assert plan.rows % 4 == 0 and 4 <= plan.rows <= ar_flow.STREAMED_MAX_ROWS
            if streams:
                assert plan.cap > 0
            # every row tile walked by one group: group g takes g, g + groups, ...
            tiles = -(-n // plan.rows)
            assert plan.groups <= tiles
            walked = sorted(t for g in range(plan.groups) for t in range(g, tiles, plan.groups))
            assert walked == list(range(tiles))
            lay = ar_flow.streamed_layout(widths, plan.ctas, plan.rows, backward, plan.cap)
            assert 4 * lay.floats + ar_flow.STREAMED_STATIC_SMEM == plan.bytes
            # every column of every hidden layer in exactly one CTA's slice
            for w, p in zip(hidden, lay.P):
                cover = [0] * w
                for c in range(plan.ctas):
                    for col in range(c * p, min(w, (c + 1) * p)):
                        cover[col] += 1
                assert cover == [1] * w and p % 4 == 0
            # a streamed chunk fits a ring slot, a resident one is every
            # input; a thread keeps at most 4 row quads; K slices a power of
            # two, at most 16, of at least 8 inputs each
            for l, kc, ks in zip(range(1, L), lay.kc, lay.ks):
                k, p = ar_flow._link_kp(widths, lay.P, l, backward)
                assert 1 <= kc <= k
                if plan.cap:
                    assert plan.cap <= ar_flow.STREAMED_SLOT_FLOATS and plan.cap % 4 == 0
                    assert kc * p <= max(plan.cap, p)
                else:
                    assert kc == k
                threads_a_group = ar_flow.STREAMED_THREADS // (p // 4)
                assert -(-(plan.rows // 4) // threads_a_group) <= ar_flow.STREAMED_ITEMS
                assert ks & (ks - 1) == 0 and ks <= 16 and (ks == 1 or kc // ks >= 8)


def _streamed_before(widths, backward):
    """The streamed kernels' shared memory as `route` read it before their
    redesign (4-row blocks that read every weight through the cache), in
    bytes: the x and y tiles, the first layer's pre-activation and two
    buffers of the widest hidden layer forward; five tiles, dsum and two
    delta buffers backward."""
    d, w1, wmax = widths[0], widths[1], max(widths[1:-1])
    floats = 5 * d + w1 + 2 * wmax + 8 + 3 if backward else 2 * d + w1 + 2 * wmax + 16
    return 4 * floats * 4 + 2560


# hidden layers at a width h: all of it, the first of it and the rest half,
# the last of it and the rest half
PATTERNS = [lambda h, n: (h,) * n, lambda h, n: (h,) + (max(h // 2, 1),) * (n - 1),
            lambda h, n: (max(h // 2, 1),) * (n - 1) + (h,)]


@pytest.mark.parametrize("d", [2, 16, 64, 256])
def test_route_sends_the_same_shapes_to_the_streamed_pair(d):
    """Past what 8 CTAs hold, a direction goes to the streamed pair exactly
    where the older streamed kernels took it (`streamed_scope_bytes` is
    their shared memory, `_streamed_before`), at hidden widths up to 12,000
    units, equal or mixed; `route` raises where neither the other pairs nor
    that scope take it (a hidden layer of 16,384 units forward)."""
    for h in (128, 256, 512, 700, 1002, 1024, 1500, 2048, 3000, 4000, 4500, 4700, 4800, 5000,
              6000, 12_000):
        for n_hidden in (1, 2, 3, 6, 12, 40):
            for pattern in PATTERNS:
                widths = _widths(pattern(h, n_hidden), d)
                for backward in (False, True):
                    before = _streamed_before(widths, backward)
                    assert ar_flow.streamed_scope_bytes(widths, backward) == before
                    try:
                        got = ar_flow.route(widths, backward, H100_SMEM)
                    except ValueError:
                        got = None
                    if got in (None, "streamed"):
                        assert ar_flow.general_plan(widths, backward, 1,
                                                    ar_flow.GENERAL_MAX_CLUSTER, H100_SMEM) is None
                        assert (got == "streamed") == (before <= H100_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        ar_flow.route([20, 16_384, 40], False, H100_SMEM)


def _widest_in_scope(pattern, n_hidden, d, backward):
    """The widest h at which `pattern`'s widths lie in the streamed route's
    scope on an H100 (its bytes grow with h)."""
    lo, hi = 1, 20_000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        widths = _widths(pattern(mid, n_hidden), d)
        lo, hi = (mid, hi) if ar_flow.streamed_scope_bytes(widths, backward) <= H100_SMEM else (
            lo, mid - 1)
    return lo


@pytest.mark.parametrize("d", [2, 16, 64, 256])
@pytest.mark.parametrize("n_hidden", [1, 2, 3, 12, 63])
def test_every_routed_shape_has_a_plan(d, n_hidden):
    """Wherever `route` sends a direction to the streamed pair, the launch
    finds a plan: `streamed_plan` has a layout on an H100 (132 CTAs at once,
    232,448 bytes a block) at the scope's edge (the widest hidden layers of
    each pattern that `route` sends there) and at layers of 1,024 and 1,002
    units."""
    for backward in (False, True):
        for pattern in PATTERNS:
            for h in (_widest_in_scope(pattern, n_hidden, d, backward), 1002, 1024):
                widths = _widths(pattern(h, n_hidden), d)
                try:
                    if ar_flow.route(widths, backward, H100_SMEM) != "streamed":
                        continue
                except ValueError:
                    continue
                assert ar_flow.streamed_plan(widths, backward, 128, H100_CTAS,
                                             H100_SMEM) is not None, (widths, backward)


def test_streamed_plan_takes_only_what_the_kernels_take():
    assert ar_flow.streamed_plan((16, 1024, 1024, 30), False, 128, H100_CTAS, H100_SMEM) is None
    assert ar_flow.streamed_plan((1, 8, 2), False, 128, H100_CTAS, H100_SMEM) is None
    assert ar_flow.streamed_plan(_widths((64,) * 64, 4), True, 128, H100_CTAS, H100_SMEM) is None
    assert ar_flow.streamed_plan(_widths((64,), 4), True, 0, H100_CTAS, H100_SMEM) is None
    assert ar_flow.streamed_scope_bytes((16, 1024, 1024, 30), False) is None
