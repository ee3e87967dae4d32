"""Fused autoregressive-flow solve (mmvae_tpu/ops/ar_flow.py).

`ar_solve` runs the whole D-step sequential solve of one MADE block. On a
CUDA tensor it runs hand-written Hopper kernels, picked by `route` from the
MADE's widths, the call's direction and the device's shared-memory limit
before any launch:

- "fast": the 128-wide pair in csrc/ar_flow.cu, for hidden layers of 128
  (every config's MADE): the forward (one launch), and the backward, which
  returns the gradients of x, every weight and every bias in two launches:
  the reverse chain, which sums each block's weight and bias gradients as
  it goes, then the sum of those partial sums in block order;
- "general": the pair in csrc/ar_flow_general.cu, for every other shape
  whose weights the shared memory of a thread-block cluster of at most 8
  CTAs holds: the forward (one launch) and the backward (two: the reverse
  chain, whose second warp group sums the weight and bias gradients on
  chip, then the sum of the clusters' partial sums). `general_plan` picks
  the cluster and the rows of a tile from numbers alone;
- "streamed": the pair in csrc/ar_flow_streamed.cu, for the shapes past 8
  CTAs (hidden widths near 1,000, dozens of hidden layers): one cooperative
  launch over the whole card, whose row groups of CTAs each hold one copy
  of the MADE's weights spread over their shared memory (or, past the
  card's shared memory, stream them through a ring of it) and trade each
  link's activations through L2. `streamed_plan` picks the groups, the
  slices and the rows of a tile from numbers alone. The backward's chain
  writes each hidden layer's per-step deltas and the weight and bias sums
  over rows and steps are then plain matrix products (`sum_grads`).

All three pairs read and write the same tape, so a call's forward and
backward may take different pairs. On a CPU tensor the forward is the
plain PyTorch version `unrolled_solve` and the backward is the JAX
package's own design (`_ar_solve_bwd`): autograd through `unrolled_solve`,
re-run from the saved inputs.

The hidden ReLUs are `hidden_relu`, JAX's `jnp.maximum(z, 0.0)`, whose
gradient at an exact tie is one half. The kernels take the same three
slopes (1, 1/2, 0) from the pre-activations that the forward records.

The backward kernels' algorithms have plain versions too, in explicit
PyTorch, so that the CPU tests can hold the algorithms against JAX:
`plain_tape` and `plain_backward` (the 128-wide chain, with the weight and
bias sums taken inside), `plain_general_backward` (the same chain over the
general pair's row tiles, summed per cluster and then over the clusters in
order) and `plain_chain` with `sum_grads` (the streamed chain and the sums
taken after it).

The masked weights arrive with the mask already applied, as in JAX: the
mask multiply stays outside the autograd Function, so gradients reach the
raw MADE kernels through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

_SOURCE = "ar_flow.cu"
_GENERAL_SOURCE = "ar_flow_general.cu"
_STREAMED_SOURCE = "ar_flow_streamed.cu"
KERNEL_HIDDEN = 128  # the one hidden width the 128-wide kernels take
KERNEL_TILE_ROWS = 4  # the rows a block of the kernels owns at a time (kTile)
# csrc/ar_flow.cu: the layers its kernels take (kMaxLayers, hidden + head)
# and the hidden layers its backward takes (kMaxBackwardHidden)
FAST_MAX_LAYERS, FAST_MAX_BACKWARD_HIDDEN = 8, 3
# csrc/ar_flow_general.cu: the layers its kernels take (kMaxLayers), the
# bytes it counts for their static shared memory (kStaticSmem), the largest
# cluster, the chain's threads, the least input features a K slice sums
# (kMinChunk)
GENERAL_MAX_LAYERS, GENERAL_STATIC_SMEM, GENERAL_MAX_CLUSTER = 64, 9216, 8
GENERAL_CHAIN_THREADS, GENERAL_MIN_CHUNK = 256, 8
GENERAL_CHAIN_WARPS = GENERAL_CHAIN_THREADS // 32
# csrc/ar_flow_streamed.cu: the layers its kernels take, the bytes it counts
# for their static shared memory, its consumer threads, the rows of a tile at
# most, the ring's slots and a slot's floats at most, the least
# input features a K slice sums, the CTAs' partial sums staged at a time
# (forward, backward), the row quads a thread keeps, the K slices a link
# takes at most, and the plan's cost model (a group barrier's cycles, a
# chunk's, FMAs, staged and streamed floats a cycle)
STREAMED_MAX_LAYERS, STREAMED_STATIC_SMEM, STREAMED_THREADS = 64, 6144, 256
STREAMED_MAX_ROWS, STREAMED_SLOTS, STREAMED_SLOT_FLOATS = 64, 2, 8192
STREAMED_MIN_CHUNK, STREAMED_HEAD_PASS, STREAMED_GRAD_PASS = 8, 64, 128
STREAMED_ITEMS, STREAMED_MAX_SLICES = 4, 16
STREAMED_SYNC_CYCLES, STREAMED_CHUNK_CYCLES, STREAMED_FMA_PER_CYCLE = 8000, 100, 64
STREAMED_STAGE_PER_CYCLE, STREAMED_STREAM_PER_CYCLE = 8, 3


def hidden_relu(z):
    """The solve's hidden ReLU as JAX's unrolled_solve takes it,
    jnp.maximum(z, 0.0): its gradient is 1 above 0, 0 below and 1/2 at an
    exact tie (torch.relu passes none there). MADE's biases start at 0, so
    at initialisation every hidden unit whose masked inputs are all still 0
    sits at the tie."""
    return torch.maximum(z, z.new_zeros(()))


def unrolled_solve(x, masked_weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor], sign: int, s_bound: float = 0.0):
    """Plain differentiable version (JAX `unrolled_solve`). x: (..., D);
    weights (in, out) as used by `h @ W`. Returns (y, logdet)."""
    d = x.shape[-1]
    n_hidden = len(masked_weights) - 1
    y = torch.zeros_like(x)
    ld = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    cols = torch.arange(d, device=x.device)
    for i in range(d):
        h = y
        for li in range(n_hidden):
            h = hidden_relu(h @ masked_weights[li] + biases[li])
        o = h @ masked_weights[n_hidden] + biases[n_hidden]
        mu_i, s_i = o[..., i], o[..., i + d]
        if s_bound > 0.0:
            s_i = s_bound * torch.tanh(s_i / s_bound)
        if sign < 0:
            y_i = (x[..., i] - mu_i) * torch.exp(-s_i)
        else:
            y_i = x[..., i] * torch.exp(s_i) + mu_i
        y = torch.where(cols == i, y_i.unsqueeze(-1), y)
        ld = ld + sign * s_i
    return y, ld


class Tape(NamedTuple):
    """What the forward records for the backward, per step i of the solve.
    z[l]: (D, N, width of hidden layer l), the layer's pre-activation, the
    input of its ReLU, so that the backward tells a tie from a negative;
    s: (D, N), the head's log-scale before the bound. The first layer's
    input is not recorded: at step i it is y with the features from i on
    zeroed."""
    z: List[torch.Tensor]
    s: torch.Tensor


def new_tape(x: torch.Tensor, masked_weights: Sequence[torch.Tensor]) -> Tape:
    n, d = x.shape
    return Tape([x.new_empty(d, n, w.shape[1]) for w in masked_weights[:-1]], x.new_empty(d, n))


def plain_tape(x, masked_weights, biases, sign: int, s_bound: float = 0.0):
    """Plain version of the recording forward kernel on (N, D) tensors:
    (y, logdet, tape), computing only head columns i and i+D at step i."""
    ws, bs = list(masked_weights), list(biases)
    n, d = x.shape
    tape = new_tape(x, ws)
    y = torch.zeros_like(x)
    ld = x.new_zeros(n)
    for i in range(d):
        h = y
        for li in range(len(ws) - 1):
            z = h @ ws[li] + bs[li]
            tape.z[li][i] = z
            h = hidden_relu(z)
        cols = [i, i + d]
        o = h @ ws[-1][:, cols] + bs[-1][cols]
        mu, s = o[:, 0], o[:, 1]
        tape.s[i] = s
        if s_bound > 0.0:
            s = s_bound * torch.tanh(s / s_bound)
        y = y.clone()
        y[:, i] = (x[:, i] - mu) * torch.exp(-s) if sign < 0 else x[:, i] * torch.exp(s) + mu
        ld = ld + sign * s
    return y, ld, tape


def _relu_slope(z):
    """hidden_relu's slope: 1 above 0, 1/2 at the tie, 0 below."""
    return (z > 0).to(z.dtype) + 0.5 * (z == 0).to(z.dtype)


def _head_grads(g, s_raw, x_i, y_i, gld, sign: int, s_bound: float):
    """Step i of the reverse chain at the head, from y's gradient g at
    feature i: (gx_i, the gradient at mu_i, the gradient at the raw s_i)."""
    s, ds = s_raw, 1.0
    if s_bound > 0.0:
        t = torch.tanh(s_raw / s_bound)
        s, ds = s_bound * t, 1.0 - t * t
    if sign < 0:
        gx_i = g * torch.exp(-s)
        g_mu, g_s = -gx_i, -g * y_i - gld
    else:
        e = torch.exp(s)
        gx_i = g * e
        g_mu, g_s = g, g * x_i * e + gld
    return gx_i, g_mu, g_s * ds


def plain_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int, s_bound: float = 0.0):
    """Plain version of the 128-wide backward kernel on (N, D) tensors: the
    reverse chain over i = D-1..0, with the weight and bias gradients summed
    over rows and steps as it goes. Returns (gx, gws, gbs).

    y's gradient at feature i is gy_i plus what the first layer of every
    later step sends back, W0[i, :] . dsum, where dsum sums the first
    layer's deltas of the steps after i. The first layer's input at step k
    is y with the features from k on zeroed, so its weight gradient has the
    rank-1 form dW0[i, :] = sum over rows of y_i * dsum, read before step
    i's delta joins dsum. Step i reaches only head columns i and i+D."""
    ws = list(masked_weights)
    gws = [torch.zeros_like(w) for w in ws]
    gbs = [x.new_zeros(w.shape[1]) for w in ws]
    gx = _reverse_chain(x, y, gy, gld, tape, ws, sign, s_bound, gws, gbs)
    return gx, gws, gbs


def _reverse_chain(x, y, gy, gld, tape: Tape, ws, sign: int, s_bound: float, gws, gbs):
    """`plain_backward`'s reverse chain over the rows of x, adding each
    step's weight and bias gradients into gws and gbs in place, in step
    order. Returns gx."""
    n, d = x.shape
    gx = torch.empty_like(x)
    dsum = x.new_zeros(n, ws[0].shape[1])
    for i in reversed(range(d)):
        gws[0][i] += y[:, i] @ dsum
        gx[:, i], g_mu, g_s = _head_grads(gy[:, i] + dsum @ ws[0][i], tape.s[i], x[:, i],
                                          y[:, i], gld, sign, s_bound)
        h = hidden_relu(tape.z[-1][i])
        gws[-1][:, i] += g_mu @ h
        gws[-1][:, i + d] += g_s @ h
        gbs[-1][i] += g_mu.sum()
        gbs[-1][i + d] += g_s.sum()
        g_in = g_mu[:, None] * ws[-1][:, i] + g_s[:, None] * ws[-1][:, i + d]
        for li in range(len(ws) - 2, -1, -1):
            delta = g_in * _relu_slope(tape.z[li][i])
            gbs[li] += delta.sum(0)
            if li > 0:
                gws[li] += hidden_relu(tape.z[li - 1][i]).T @ delta
                g_in = delta @ ws[li].T
        dsum += delta
    return gx


def plain_general_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int,
                           s_bound: float = 0.0, clusters: int = 1,
                           rows: int = KERNEL_TILE_ROWS):
    """Plain version of the general backward kernel on (N, D) tensors, with
    its partial sums in its order: the rows cut into tiles of `rows`;
    cluster b of `clusters` (at most the tiles) walks tiles b, b + clusters,
    ..., adding each step's weight and bias gradients to its own partial
    sums, step by step (the reverse chain of `plain_backward`); then the
    clusters' partial sums are added in cluster order, as the second launch
    does. Returns (gx, gws, gbs)."""
    ws = list(masked_weights)
    n, _ = x.shape
    gx = torch.empty_like(x)
    n_tiles = -(-n // rows)
    total = [torch.zeros_like(w) for w in ws] + [x.new_zeros(w.shape[1]) for w in ws]
    for b in range(min(clusters, n_tiles)):
        gws = [torch.zeros_like(w) for w in ws]
        gbs = [x.new_zeros(w.shape[1]) for w in ws]
        for tile in range(b, n_tiles, clusters):
            r = slice(tile * rows, min(n, (tile + 1) * rows))
            sub = Tape([z[:, r] for z in tape.z], tape.s[:, r])
            gx[r] = _reverse_chain(x[r], y[r], gy[r], gld[r], sub, ws, sign, s_bound, gws, gbs)
        total = [t + p for t, p in zip(total, gws + gbs)] if b else gws + gbs
    return gx, total[:len(ws)], total[len(ws):]


def plain_chain(x, y, gy, gld, tape: Tape, masked_weights, sign: int, s_bound: float = 0.0):
    """Plain version of the streamed backward kernel on (N, D) tensors: the
    same reverse chain as `plain_backward`, which keeps each step's deltas
    instead of summing them. Returns (gx, deltas, head): deltas[l] (D, N,
    width of hidden layer l), the gradient at layer l's pre-activation at
    each step; head (D, N, 2), the gradients at mu_i and the raw s_i at step
    i (head columns i and i+D, the only ones step i reaches)."""
    ws = list(masked_weights)
    n, d = x.shape
    gx = torch.empty_like(x)
    deltas = [x.new_empty(d, n, w.shape[1]) for w in ws[:-1]]
    head = x.new_empty(d, n, 2)
    dsum = x.new_zeros(n, ws[0].shape[1])
    for i in reversed(range(d)):
        gx[:, i], g_mu, g_s = _head_grads(gy[:, i] + dsum @ ws[0][i], tape.s[i], x[:, i],
                                          y[:, i], gld, sign, s_bound)
        head[i, :, 0], head[i, :, 1] = g_mu, g_s
        g_in = g_mu[:, None] * ws[-1][:, i] + g_s[:, None] * ws[-1][:, i + d]
        for li in range(len(ws) - 2, -1, -1):
            deltas[li][i] = g_in * _relu_slope(tape.z[li][i])
            if li > 0:
                g_in = deltas[li][i] @ ws[li].T
        dsum += deltas[0][i]
    return gx, deltas, head


def sum_grads(y, tape: Tape, deltas: Sequence[torch.Tensor], head: torch.Tensor):
    """The weight and bias gradients from the streamed chain's per-step
    deltas: sums over rows and steps, one matrix product and one sum per
    layer, as JAX's autodiff of `unrolled_solve` leaves them to XLA. The
    first layer's input at step i is y with the features from i on zeroed;
    hidden layer l's is relu(z[l - 1]); the head's is the last hidden
    layer's output, of which step i reaches columns i and i+D. Returns (gws,
    gbs). (The ReLU is taken by clamp, not `hidden_relu`: these are values,
    not a graph.)"""
    n, d = y.shape
    earlier = torch.ones(d, d, dtype=y.dtype, device=y.device).tril(-1)  # [i, k]: k < i
    inputs = [y * earlier[:, None, :]] + [z.clamp(min=0) for z in tape.z]
    gws = [a.reshape(-1, a.shape[-1]).T @ dl.reshape(-1, dl.shape[-1])
           for a, dl in zip(inputs, deltas)]
    gws.append(torch.einsum("inh,inc->hci", inputs[-1], head).reshape(-1, 2 * d))
    gbs = [dl.sum((0, 1)) for dl in deltas] + [head.sum(1).T.reshape(-1)]
    return gws, gbs


def _widths(x: torch.Tensor, ws: List[torch.Tensor]) -> List[int]:
    """Validate x and the weights' shapes; returns the layer widths."""
    if x.dim() != 2:
        raise ValueError("x must be (N, D)")
    d = x.shape[1]
    if d < 2:
        raise ValueError(f"D must be at least 2, got {d}")
    if len(ws) < 2:
        raise ValueError("need weights for >= 1 hidden layer and the head")
    widths = [d] + [int(w.shape[1]) for w in ws]
    if widths[-1] != 2 * d:
        raise ValueError(f"head width {widths[-1]} != 2*D = {2 * d}")
    for li, w in enumerate(ws):
        if tuple(w.shape) != (widths[li], widths[li + 1]):
            raise ValueError(f"layer {li}: weight {tuple(w.shape)} does not chain from width "
                             f"{widths[li]}")
    return widths


def _check_params(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> List[int]:
    """Validate what the forward kernels take at any widths; returns the
    layer widths."""
    widths = _widths(x, ws)
    if len(bs) != len(ws):
        raise ValueError("need one bias per weight")
    for li, b in enumerate(bs):
        if tuple(b.shape) != (widths[li + 1],):
            raise ValueError(f"layer {li}: bias {tuple(b.shape)} != ({widths[li + 1]},)")
    _check_like(x, [x, *ws, *bs])
    return widths


def _check(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> List[int]:
    """Validate what the 128-wide forward kernel can take; returns the layer
    widths."""
    widths = _check_params(x, ws, bs)
    _check_hidden(widths)
    return widths


def _check_hidden(widths: List[int]) -> None:
    """The 128-wide kernels are built for hidden layers of KERNEL_HIDDEN
    only, the width of the port's MADE blocks (csrc/ar_flow.cu, kHidden)."""
    if any(w != KERNEL_HIDDEN for w in widths[1:-1]):
        raise ValueError(f"ar_solve kernels take hidden layers of width {KERNEL_HIDDEN}, "
                         f"got {widths[1:-1]}")


def _check_like(x: torch.Tensor, tensors) -> None:
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("ar_solve kernel takes contiguous float32 tensors on one CUDA device")


def _check_shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _lib():
    from .build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(vp)
        lib.ar_solve_smem_bytes.argtypes = [ctypes.POINTER(ci), ci, ci]
        lib.ar_solve_smem_bytes.restype = ctypes.c_longlong
        lib.ar_solve_forward.argtypes = [
            vp, pp, pp, ctypes.POINTER(ci), ci, ci, ci, cf, vp, vp, pp, vp, vp]
        lib.ar_solve_forward.restype = ci
        lib.ar_solve_backward.argtypes = [
            vp, vp, vp, vp, pp, ctypes.POINTER(ci), ci, ci, ci, cf, pp, vp, vp, vp, vp, ci, vp]
        lib.ar_solve_backward.restype = ci
        lib._typed = True
    return lib


def _general_lib():
    from .build import load

    lib = load(_GENERAL_SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
        lib.ar_solve_general_plan.argtypes = [pi, ci, ci, ci, ci, ci, pi]
        lib.ar_solve_general_plan.restype = ci
        lib.ar_solve_general_clusters.argtypes = [pi, ci, ci, ci]
        lib.ar_solve_general_clusters.restype = ci
        lib.ar_solve_general_forward.argtypes = [
            vp, pp, pp, pi, ci, ci, ci, cf, vp, vp, pp, vp, ci, vp]
        lib.ar_solve_general_forward.restype = ci
        lib.ar_solve_general_backward.argtypes = [
            vp, vp, vp, vp, pp, pi, ci, ci, ci, cf, pp, vp, vp, vp, vp, ci, vp]
        lib.ar_solve_general_backward.restype = ci
        lib._typed = True
    return lib


def _streamed_lib():
    from .build import load

    lib = load(_STREAMED_SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(vp)
        ll = ctypes.c_longlong
        lib.ar_solve_streamed_ctas.argtypes = [ci]
        lib.ar_solve_streamed_ctas.restype = ci
        lib.ar_solve_streamed_plan.argtypes = [
            ctypes.POINTER(ci), ci, ci, ci, ci, ci, ctypes.POINTER(ll)]
        lib.ar_solve_streamed_plan.restype = ci
        lib.ar_solve_streamed_forward.argtypes = [
            vp, pp, pp, ctypes.POINTER(ci), ci, ci, ci, cf, vp, vp, pp, vp, ctypes.POINTER(ll),
            vp, vp]
        lib.ar_solve_streamed_forward.restype = ci
        lib.ar_solve_streamed_backward.argtypes = [
            vp, vp, vp, vp, pp, ctypes.POINTER(ci), ci, ci, ci, cf, pp, vp, pp, vp, vp,
            ctypes.POINTER(ll), vp, vp]
        lib.ar_solve_streamed_backward.restype = ci
        lib._typed = True
    return lib


def _round4(v: int) -> int:
    return (v + 3) & ~3


def fast_smem_bytes(widths: Sequence[int], backward: bool):
    """The dynamic shared memory, in bytes, one block of the 128-wide
    forward or backward kernel needs at these layer widths ([D, hidden...,
    2D]); None where its kernels do not take them. A copy of
    csrc/ar_flow.cu's smem_floats (ar_solve_smem_bytes), so that `route` is
    a function of numbers."""
    n, d, h = len(widths) - 1, widths[0], KERNEL_HIDDEN
    if (n < 2 or n > FAST_MAX_LAYERS or d < 2 or widths[-1] != 2 * d
            or any(w != h for w in widths[1:-1])):
        return None
    tile, warps, slices = KERNEL_TILE_ROWS, 16, 8
    staged, part = (n - 2) * _round4(h * (h + 1)), slices * h * tile
    if backward:
        floats = (staged + 5 * d * tile + 4 * tile + 3 * (n - 1) * h * tile + h * tile
                  + warps * tile + part)
    else:
        floats = (staged + 2 * h * tile + part + sum(_round4(w) for w in widths[1:])
                  + 2 * d * tile + h * tile + 2 * warps * tile)
    return 4 * floats


def _streamed_kslices(p: int, r: int, kc: int) -> int:
    """csrc/ar_flow_streamed.cu's kslices: the K slices of a link of p
    columns over r rows, chunks of kc inputs."""
    tg, rv, ks = STREAMED_THREADS // (p // 4), r // 4, 1
    while (2 * ks <= STREAMED_MAX_SLICES and 2 * ks * rv <= tg
           and 2 * ks * STREAMED_MIN_CHUNK <= kc):
        ks *= 2
    return ks


class StreamedLayout(NamedTuple):
    """One CTA of the streamed kernels: each hidden layer's slice width
    (`P`), each link's chunk of inputs and K slices (index l - 1 for link
    l), the most floats a ring slot may take (`cap`, 0 where the weights
    are resident) and the floats of its dynamic shared memory."""
    P: Tuple[int, ...]
    kc: Tuple[int, ...]
    ks: Tuple[int, ...]
    cap: int
    floats: int


def _link_kp(widths, p, l: int, backward: bool):
    """Link l's inputs and slice width: the forward's product that gives
    hidden layer l, the backward's that gives layer l - 1's delta."""
    return (widths[l + 1], p[l - 1]) if backward else (widths[l], p[l])


def streamed_layout(widths: Sequence[int], ctas: int, rows: int, backward: bool,
                    cap: int, pass_ctas: int | None = None):
    """The layout of one CTA of the streamed forward or backward kernel at
    these layer widths, `ctas` CTAs a row group sharing each layer's columns,
    tiles of `rows` rows, the weights resident (`cap` 0) or streamed through
    a ring of two slots of at most `cap` floats (each link a chunk of
    cap / P of its inputs at a time, at least one); None where a link's
    slice is too wide for its threads. A copy of csrc/ar_flow_streamed.cu's
    layout(); `pass_ctas` (default `ctas`) sets the CTAs whose partial sums
    the stage holds at once."""
    pass_ctas = ctas if pass_ctas is None else pass_ctas
    d, L = widths[0], len(widths) - 2
    p = [_round4(-(-w // ctas)) for w in widths[1:-1]]
    floats, ring, part, kcs, kss = 0, 0, 0, [], []  # ring: a slot's floats
    for l in range(1, L):
        k, pl = _link_kp(widths, p, l, backward)
        tg = STREAMED_THREADS // (pl // 4) if pl <= 4 * STREAMED_THREADS else 0
        if tg == 0 or -(-(rows // 4) // tg) > STREAMED_ITEMS:
            return None
        if cap:
            kc = min(k, max(cap // pl, 1))
            ring = max(ring, kc * pl)
        else:
            kc, floats = k, floats + k * pl
        ks = _streamed_kslices(pl, rows, kc)
        if ks > 1:
            part = max(part, ks * pl * rows)
        kcs.append(kc)
        kss.append(ks)
    floats += STREAMED_SLOTS * ring
    if not backward:
        stage = max([2 * min(pass_ctas, STREAMED_HEAD_PASS)] + list(widths[2:L]))
        floats += 2 * p[-1] + sum(p[1:]) + _round4(2 * d) + widths[1] * rows
        floats += _round4(widths[1]) + stage * rows + part
        floats += (p[-1] // 4 * 2 * rows if L > 1 else 0) + 2 * d * rows
    else:
        stage = max([min(pass_ctas, STREAMED_GRAD_PASS)] + list(widths[2:L + 1]))
        floats += stage * rows + part + p[0] + p[0] * rows + 5 * d * rows + 3 * rows
    return StreamedLayout(tuple(p), tuple(kcs), tuple(kss), cap, floats)


def _streamed_ring_layout(widths: Sequence[int], ctas: int, rows: int, backward: bool,
                          limit: int):
    """The streamed layout at these CTAs and rows with the widest ring that
    fits `limit`: slots of at most STREAMED_SLOT_FLOATS where they fit, else
    of at most the floats that the other buffers leave (a multiple of 4, at
    least every link's slice: three or more hidden layers of ~4,500 units);
    None where none fits. A copy of csrc/ar_flow_streamed.cu's
    ring_layout()."""
    lay = streamed_layout(widths, ctas, rows, backward, STREAMED_SLOT_FLOATS)
    if lay is None or 4 * lay.floats + STREAMED_STATIC_SMEM <= limit:
        return lay
    links = [(kc, _link_kp(widths, lay.P, l, backward)[1])
             for l, kc in zip(range(1, len(widths) - 2), lay.kc)]
    if not links:  # one hidden layer: no ring to narrow
        return None
    ring = max(kc * p for kc, p in links)
    room = (limit - STREAMED_STATIC_SMEM) // 4 - (lay.floats - STREAMED_SLOTS * ring)
    cap = (room // STREAMED_SLOTS) & ~3
    if cap < max(p for _, p in links):
        return None
    return streamed_layout(widths, ctas, rows, backward, cap)


def _streamed_step_cost(widths, lay: StreamedLayout, ctas: int, rows: int, backward: bool) -> int:
    """csrc/ar_flow_streamed.cu's step_cost: a step's estimated cycles on one
    SM."""
    L, p = len(widths) - 2, lay.P
    weights = fma = chunks = 0
    for l, kc, ks in zip(range(1, L), lay.kc, lay.ks):
        k, pl = _link_kp(widths, p, l, backward)
        items = -(-(rows // 4) // (STREAMED_THREADS // (pl // 4)))  # the slowest thread's quads
        busy = min(STREAMED_THREADS, (pl // 4) * (rows // 4) * ks // items)
        weights, fma = weights + k * pl, fma + k * pl * STREAMED_THREADS // busy
        chunks -= -k // kc
    staged = sum(widths[2:L])
    if backward:
        fma, staged = fma + 2 * widths[L] + p[0], staged + ctas
    else:
        fma, staged = fma + widths[1] + 2 * p[-1], staged + 2 * ctas
    syncs = L - 1 if L > 1 else 1
    work = rows * fma // STREAMED_FMA_PER_CYCLE
    if lay.cap:
        work = max(work, weights // STREAMED_STREAM_PER_CYCLE)
    return (syncs * STREAMED_SYNC_CYCLES + chunks * STREAMED_CHUNK_CYCLES + work
            + rows * staged // STREAMED_STAGE_PER_CYCLE)


def _streamed_takes(widths: Sequence[int]) -> bool:
    n, d = len(widths) - 1, widths[0]
    return (2 <= n <= STREAMED_MAX_LAYERS and d >= 2 and widths[-1] == 2 * d
            and min(widths[1:-1]) >= 1)


class StreamedPlan(NamedTuple):
    """The streamed kernels' plan: a ring slot's floats at most (`cap`, 0:
    the weights resident), the CTAs of a row group, the rows of a tile, the
    groups, the bytes of shared memory a CTA takes (dynamic and static) and
    the floats of the workspace (the packed weights, each group's exchange
    and its barrier counter). The launch takes it as it is."""
    cap: int
    ctas: int
    rows: int
    groups: int
    bytes: int
    work: int


@functools.lru_cache(maxsize=4096)
def streamed_plan(widths: Sequence[int], backward: bool, n_rows: int, ctas: int, limit: int):
    """The streamed kernels' plan at these layer widths for `n_rows` rows on
    a card that runs `ctas` CTAs at once (the occupancy reading,
    `_streamed_ctas`) and allows `limit` bytes of shared memory a CTA: of
    every layout that fits (the weights resident or streamed through a ring
    of full slots; a ring narrowed to fit, `_streamed_ring_layout`, only
    where none of those fits; C from 1 to `ctas` CTAs a row group; tiles of
    4 to 64 rows, step 4), the least rounds of tiles
    over the groups times a step's estimated cost, the fewer CTAs on a tie,
    then the first found. None where the kernels do not take the widths or
    no layout fits. A copy of csrc/ar_flow_streamed.cu's
    ar_solve_streamed_plan. (`widths` a tuple: the plan is cached.)"""
    widths = tuple(widths)
    if not _streamed_takes(widths) or n_rows <= 0 or ctas <= 0:
        return None
    L, d = len(widths) - 2, widths[0]
    best, best_cost = None, None
    # the weights resident, streamed through a ring of full slots, then
    # through a ring narrowed to fit only where neither fits
    for mode in range(3):
        if mode == 2 and best is not None:
            break
        for c in range(1, ctas + 1):
            for r in range(4, STREAMED_MAX_ROWS + 1, 4):
                lay = (_streamed_ring_layout(widths, c, r, backward, limit) if mode == 2 else
                       streamed_layout(widths, c, r, backward, mode * STREAMED_SLOT_FLOATS))
                if lay is None or 4 * lay.floats + STREAMED_STATIC_SMEM > limit:
                    break
                tiles = -(-n_rows // r)
                groups = min(ctas // c, tiles)
                cost = -(-tiles // groups) * _streamed_step_cost(widths, lay, c, r, backward)
                if best is None or cost < best_cost or (cost == best_cost
                                                        and groups * c < best.groups * best.ctas):
                    packed = _round4(2 * d * widths[-2]) + sum(
                        c * k * pl for k, pl in (_link_kp(widths, lay.P, l, backward)
                                                 for l in range(1, L)))
                    exchange = (sum(widths[l + 1] * r for l in range(1, L - 1))
                                + 2 * c * (1 if backward else 2) * r)
                    best_cost = cost
                    best = StreamedPlan(lay.cap, c, r, groups,
                                        4 * lay.floats + STREAMED_STATIC_SMEM,
                                        packed + groups * exchange + groups)
    return best


def streamed_scope_bytes(widths: Sequence[int], backward: bool):
    """The number that bounds the streamed route: where the kernels take
    the widths, 4 rows of the activations the route's first streamed
    kernels held in shared memory (forward: the x and y rows, the first
    layer's pre-activation and two rows of the widest hidden layer;
    backward: five D-wide rows, the first layer's and two of the widest),
    in bytes with their static shared memory; None where the kernels do not
    take the widths. `route` sends a direction past 8 CTAs here where this
    fits the device's limit, the scope the route has had since it was
    added (hidden layers up to about 4,800 units at D = 16 on an H100);
    tests/test_torch_ar_streamed.py checks that `streamed_plan` has a
    layout at every shape within it."""
    if not _streamed_takes(widths):
        return None
    d, w1, wmax = widths[0], widths[1], max(widths[1:-1])
    floats = 5 * d + w1 + 2 * wmax + 11 if backward else 2 * d + w1 + 2 * wmax + 16
    return 16 * floats + 2560


def _ksplit(p: int, k: int, rv: int) -> int:
    """csrc/ar_flow_general.cu's ksplit: the K slices of a product of p
    columns, k inputs and rv quads of rows."""
    groups = 1 << max(p // 4 - 1, 0).bit_length()  # p / 4, rounded up to a power of two
    ks = 1
    while 2 * ks * groups * rv <= GENERAL_CHAIN_THREADS and 2 * ks * GENERAL_MIN_CHUNK <= k:
        ks *= 2
    return ks


def general_layout_floats(widths: Sequence[int], cluster: int, rows: int, backward: bool) -> int:
    """The floats of dynamic shared memory one CTA of the general forward or
    backward kernel needs at these layer widths, `cluster` CTAs sharing a
    tile of `rows` rows. A copy of csrc/ar_flow_general.cu's layout()."""
    d, hidden = widths[0], list(widths[1:-1])
    n_hidden = len(hidden)
    p = [_round4(-(-h // cluster)) for h in hidden]  # each CTA's slice, padded to 4
    rv = rows // 4
    if not backward:
        floats = d * p[0] + sum(hidden[l - 1] * p[l] for l in range(1, n_hidden))
        floats += 2 * d * p[-1] + sum(p) + _round4(2 * d)
        floats += sum(_round4(h) * rows for h in hidden[:-1]) + p[0] * rows
        floats += max([_ksplit(p[l], hidden[l - 1], rv) * p[l] * rows
                       for l in range(1, n_hidden)], default=0)
        return floats + 2 * d * rows + 2 * cluster * GENERAL_CHAIN_WARPS * 2 * rows
    floats = d * p[0] + 2 * sum(hidden[l] * p[l - 1] for l in range(1, n_hidden))
    floats += 2 * d * p[-1] + sum(p) + _round4(2 * d) + 3 * sum(p) * rows
    floats += 2 * sum(_round4(h) * rows for h in hidden[1:]) + 2 * p[0] * rows + 6 * rows
    floats += 2 * p[0] * rows + 2 * d * rows
    floats += max([_ksplit(p[l - 1], hidden[l], rv) * p[l - 1] * rows
                   for l in range(1, n_hidden)], default=0)
    return floats + 2 * cluster * GENERAL_CHAIN_WARPS * rows


def general_plan(widths: Sequence[int], backward: bool, n_rows: int, n_sms: int, limit: int):
    """The general kernels' plan at these layer widths for `n_rows` rows on
    a card of `n_sms` SMs that allows `limit` bytes of shared memory a
    block: (cluster, rows, bytes), the least cluster of 1, 2, 4 or 8 CTAs
    whose shared memory holds the MADE at 4-row tiles; of the tiles of 4, 8
    and 16 rows that shared memory holds, the one with the fewest rounds of
    tiles over the clusters the card runs at once (SMs / cluster, seven
    eighths of it for clusters past one CTA: a floor of what the card's
    occupancy query reads, make_plan says which), the fewer rows on a tie;
    and the bytes of shared memory a CTA takes. None where the kernels do
    not take the widths or no cluster of at most 8 holds them. A copy of
    csrc/ar_flow_general.cu's ar_solve_general_plan."""
    n, d = len(widths) - 1, widths[0]
    if (n < 2 or n > GENERAL_MAX_LAYERS or d < 2 or widths[-1] != 2 * d
            or min(widths[1:-1]) < 1 or n_rows <= 0):
        return None
    cluster = 1
    while cluster <= GENERAL_MAX_CLUSTER:
        slots = n_sms if cluster == 1 else 7 * n_sms // (8 * cluster)
        best = None
        for rows in (4, 8, 16):
            need = 4 * general_layout_floats(widths, cluster, rows, backward) + GENERAL_STATIC_SMEM
            if need > limit:
                break
            rounds = -(-(-(-n_rows // rows)) // max(slots, 1))
            if best is None or rounds < best[0]:
                best = (rounds, (cluster, rows, need))
        if best is not None:
            return best[1]
        cluster *= 2
    return None


def route(widths: Sequence[int], backward: bool, limit: int) -> str:
    """The kernel that takes one direction of a call at these layer widths
    ([D, hidden..., 2D]) on a device that allows `limit` bytes of shared
    memory a block: "fast", the 128-wide kernel of csrc/ar_flow.cu, wherever
    it takes them (hidden layers of 128; a backward of at most three); else
    "general", the kernel of csrc/ar_flow_general.cu, wherever a cluster of
    at most 8 CTAs holds the MADE (`general_plan` at 4-row tiles); else
    "streamed", the kernel of csrc/ar_flow_streamed.cu, within its scope
    (`streamed_scope_bytes`). Raises ValueError where none does. Decided
    from numbers alone, before any launch. The pairs read and write the
    same tape, so the two directions of one call may take different kernels
    (a 4-hidden-layer MADE of 128: the fast forward, the general
    backward)."""
    fast = fast_smem_bytes(widths, backward)
    if (fast is not None and fast <= limit
            and not (backward and len(widths) - 2 > FAST_MAX_BACKWARD_HIDDEN)):
        return "fast"
    # one row: 4-row tiles, the least shared memory a cluster can take
    if general_plan(widths, backward, 1, GENERAL_MAX_CLUSTER, limit) is not None:
        return "general"
    streamed = streamed_scope_bytes(widths, backward)
    if streamed is not None and streamed <= limit:
        return "streamed"
    raise ValueError(f"ar_solve has no kernel for the {'backward' if backward else 'forward'} "
                     f"at widths {list(widths)}: the streamed route's scope needs {streamed} "
                     f"bytes of shared memory per block; the device allows {limit}")


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def _check_smem(widths: Tuple[int, ...], device_index: int, backward: bool) -> int:
    """Shared memory one block needs at these layer widths, checked against
    the device's limit once per (widths, device, direction)."""
    arr = (ctypes.c_int * len(widths))(*widths)
    need = int(_lib().ar_solve_smem_bytes(arr, len(widths) - 1, int(backward)))
    limit = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    if need < 0 or need > limit:
        raise ValueError(f"ar_solve needs {need} bytes of shared memory per block at widths "
                         f"{list(widths)}; the device allows {limit}")
    return need


@functools.lru_cache(maxsize=None)
def _streamed_ctas(device_index: int, backward: bool) -> int:
    """The CTAs of the streamed forward or backward kernel the device runs at
    once (the occupancy reading at the opt-in shared-memory limit, times the
    SMs): the plan's `ctas`, read in this one place."""
    with torch.cuda.device(device_index):
        got = int(_streamed_lib().ar_solve_streamed_ctas(int(backward)))
    if got <= 0:
        raise RuntimeError(f"ar_solve's streamed {'backward' if backward else 'forward'}: the "
                           f"card runs none of its CTAs at once ({got})")
    return got


@functools.lru_cache(maxsize=None)
def _streamed_plan_on(widths: Tuple[int, ...], backward: bool, n_rows: int,
                      device_index: int) -> StreamedPlan:
    """The streamed kernels' plan on the device, from its library, once for
    each widths and rows: every launch takes it as it is. Raises where
    there is none."""
    ctas, limit = _streamed_ctas(device_index, backward), _smem_limit(device_index)
    arr = (ctypes.c_int * len(widths))(*widths)
    out = (ctypes.c_longlong * 6)()
    rc = _streamed_lib().ar_solve_streamed_plan(arr, len(widths) - 1, int(backward), n_rows, ctas,
                                                limit, out)
    if rc != 0:
        raise ValueError(f"ar_solve's streamed kernel takes no plan at widths {list(widths)} on "
                         f"this device ({ctas} CTAs at once, {limit} bytes of shared memory a "
                         f"block)")
    return StreamedPlan(*map(int, out))


@functools.lru_cache(maxsize=None)
def _general_clusters(widths: Tuple[int, ...], backward: bool, n_rows: int,
                      device_index: int) -> int:
    """The general kernels' persistent grid at these widths and rows on the
    device: the clusters of the plan's size that it runs at once
    (cudaOccupancyMaxActiveClusters), at most the row tiles. Raises where
    there is no plan, and where the card runs no such cluster: a cluster
    launch that the plan promised and the card refuses."""
    if general_plan(widths, backward, n_rows, _sm_count(device_index),
                    _smem_limit(device_index)) is None:
        raise ValueError(f"ar_solve's general kernel takes no plan at widths {list(widths)} "
                         f"(no cluster of at most {GENERAL_MAX_CLUSTER} CTAs holds them)")
    arr = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(device_index):
        got = int(_general_lib().ar_solve_general_clusters(arr, len(widths) - 1, int(backward),
                                                           n_rows))
    if got <= 0:
        raise RuntimeError(f"ar_solve's general {'backward' if backward else 'forward'} at "
                           f"widths {list(widths)}: the card runs no cluster of its plan "
                           f"({got})")
    return got


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ar_solve {what} kernel launch failed: CUDA error {err}")


def _check_tape(x, tape: Tape, widths: List[int]) -> None:
    n, d = x.shape
    if len(tape.z) != len(widths) - 2:
        raise ValueError(f"tape has {len(tape.z)} hidden layers, the weights {len(widths) - 2}")
    for li, z in enumerate(tape.z):
        _check_shape(f"tape.z[{li}]", z, (d, n, widths[li + 1]))
    _check_shape("tape.s", tape.s, (d, n))
    _check_like(x, [*tape.z, tape.s])


def _count(kind: str, what: str, sign: int) -> None:
    """Counts one forward launch (`what` "launches") or one backward call
    ("backward_launches") of the pair `kind` ("fast", "general" or
    "streamed") in that pair's own counts and in the totals, and at sign -1
    in both sign -1 counts too."""
    for key in (what, f"{kind}_{what}"):
        setattr(ar_solve, key, getattr(ar_solve, key) + 1)
        if sign < 0:
            key = key.replace(what, f"sign_minus_{what}")
            setattr(ar_solve, key, getattr(ar_solve, key) + 1)


def _forward(launch, x, ws, bs, widths, sign: int, s_bound: float, tape, kind: str):
    """One forward launch (`launch`: the C entry of a kernel, whose
    arguments are the same but for the general kernel's grid, which
    `launch` binds) on tensors already checked; counts it by its route
    `kind`."""
    n, d = x.shape
    if tape is not None:
        _check_tape(x, tape, widths)
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y, ld
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), _ptrs(ws), _ptrs(bs), (ctypes.c_int * len(widths))(*widths), len(ws),
            n, int(sign), float(s_bound), y.data_ptr(), ld.data_ptr(),
            None if tape is None else _ptrs(tape.z),
            None if tape is None else tape.s.data_ptr(), stream)
    _raise_on(err, "forward" if kind == "fast" else f"{kind} forward")
    _count(kind, "launches", sign)
    return y, ld


def kernel_forward(x, masked_weights, biases, sign: int, s_bound: float = 0.0,
                   tape: Tape | None = None):
    """Launch the 128-wide Hopper forward kernel on (N, D) CUDA tensors.
    Returns (y, logdet). With `tape` (from `new_tape`) the launch also
    records the per-step hidden pre-activations and raw log-scales the
    backward needs."""
    ws, bs = list(masked_weights), list(biases)
    if not x.is_cuda:
        raise ValueError("kernel_forward takes CUDA tensors")
    widths = _check(x, ws, bs)
    lib = _lib()
    _check_smem(tuple(widths), x.device.index, False)
    return _forward(lib.ar_solve_forward, x, ws, bs, widths, sign, s_bound, tape, "fast")


def general_forward(x, masked_weights, biases, sign: int, s_bound: float = 0.0,
                    tape: Tape | None = None):
    """Launch the general Hopper forward kernel on (N, D) CUDA tensors, at
    any MADE widths a cluster of at most 8 CTAs holds (128-wide included):
    as `kernel_forward`, on `general_plan`'s cluster and tiles."""
    ws, bs = list(masked_weights), list(biases)
    if not x.is_cuda:
        raise ValueError("general_forward takes CUDA tensors")
    widths = _check_params(x, ws, bs)
    n = x.shape[0]
    if n == 0:
        return _forward(None, x, ws, bs, widths, sign, s_bound, tape, "general")
    lib = _general_lib()
    clusters = _general_clusters(tuple(widths), False, n, x.device.index)

    def launch(*args):
        return lib.ar_solve_general_forward(*args[:-1], clusters, args[-1])

    return _forward(launch, x, ws, bs, widths, sign, s_bound, tape, "general")


def streamed_forward(x, masked_weights, biases, sign: int, s_bound: float = 0.0,
                     tape: Tape | None = None):
    """Launch the streamed Hopper forward kernel on (N, D) CUDA tensors, at
    any MADE widths a plan of `streamed_plan` takes: as `kernel_forward`,
    on the plan's row groups."""
    ws, bs = list(masked_weights), list(biases)
    if not x.is_cuda:
        raise ValueError("streamed_forward takes CUDA tensors")
    widths = _check_params(x, ws, bs)
    n = x.shape[0]
    if n == 0:
        return _forward(None, x, ws, bs, widths, sign, s_bound, tape, "streamed")
    lib = _streamed_lib()
    plan = _streamed_plan_on(tuple(widths), False, n, x.device.index)
    work = x.new_empty(plan.work)

    def launch(*args):
        return lib.ar_solve_streamed_forward(*args[:-1], (ctypes.c_longlong * 6)(*plan),
                                             work.data_ptr(), args[-1])

    return _forward(launch, x, ws, bs, widths, sign, s_bound, tape, "streamed")


def _check_backward_args(x, y, gy, gld, tape: Tape, ws) -> List[int]:
    widths = _widths(x, ws)
    n, d = x.shape
    for name, t in (("y", y), ("gy", gy)):
        _check_shape(name, t, (n, d))
    _check_shape("gld", gld, (n,))
    _check_like(x, [x, *ws, y, gy, gld])
    _check_tape(x, tape, widths)
    return widths


def kernel_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int, s_bound: float = 0.0):
    """Launch the 128-wide Hopper backward kernel on (N, D) CUDA tensors:
    the same result as `plain_backward`, (gx, gws, gbs)."""
    ws = list(masked_weights)
    if not x.is_cuda:
        raise ValueError("kernel_backward takes CUDA tensors")
    widths = _check_backward_args(x, y, gy, gld, tape, ws)
    _check_hidden(widths)
    return _backward(x, y, gy, gld, tape, ws, widths, sign, s_bound)


def general_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int, s_bound: float = 0.0):
    """Launch the general Hopper backward kernels on (N, D) CUDA tensors, at
    any MADE widths a cluster of at most 8 CTAs holds: the same result as
    `plain_general_backward` on the launch's grid, (gx, gws, gbs)."""
    ws = list(masked_weights)
    if not x.is_cuda:
        raise ValueError("general_backward takes CUDA tensors")
    widths = _check_backward_args(x, y, gy, gld, tape, ws)
    return _general_backward(x, y, gy, gld, tape, ws, widths, sign, s_bound)


def streamed_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int,
                      s_bound: float = 0.0):
    """Launch the streamed Hopper backward kernel on (N, D) CUDA tensors, at
    any MADE widths a plan of `streamed_plan` takes, and sum its deltas: the
    same result as `plain_backward`, (gx, gws, gbs)."""
    ws = list(masked_weights)
    if not x.is_cuda:
        raise ValueError("streamed_backward takes CUDA tensors")
    widths = _check_backward_args(x, y, gy, gld, tape, ws)
    return _streamed_backward(x, y, gy, gld, tape, ws, widths, sign, s_bound)


def _backward(x, y, gy, gld, tape: Tape, ws, widths, sign: int, s_bound: float):
    """The backward launches on tensors already checked. The chain's blocks
    each walk every gridDim-th tile of KERNEL_TILE_ROWS rows and leave their
    partial weight and bias gradients in `work`, one row a block, in the
    parameters' order; the second launch sums them in block order into one
    flat buffer, which the gradients view."""
    lib = _lib()
    _check_smem(tuple(widths), x.device.index, True)
    n, d = x.shape
    gx = torch.empty_like(x)
    shapes = [(a, b) for a, b in zip(widths[:-1], widths[1:])] + [(b,) for b in widths[1:]]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = x.new_zeros(sum(sizes)) if n == 0 else x.new_empty(sum(sizes))
    if n > 0:
        blocks = min(-(-n // KERNEL_TILE_ROWS), _sm_count(x.device.index))
        work = x.new_empty(blocks, flat.numel())
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.ar_solve_backward(
                x.data_ptr(), y.data_ptr(), gy.data_ptr(), gld.data_ptr(), _ptrs(ws),
                (ctypes.c_int * len(widths))(*widths), len(ws), n, int(sign), float(s_bound),
                _ptrs(tape.z), tape.s.data_ptr(), gx.data_ptr(), flat.data_ptr(),
                work.data_ptr(), blocks, stream)
        _raise_on(err, "backward")
        _count("fast", "backward_launches", sign)
    grads = [g.view(s) for g, s in zip(flat.split(sizes), shapes)]
    return gx, grads[:len(ws)], grads[len(ws):]


def _general_backward(x, y, gy, gld, tape: Tape, ws, widths, sign: int, s_bound: float):
    """The general backward on tensors already checked: the reverse chain,
    whose clusters each leave their partial weight and bias gradients in
    their row of `work`, in the parameters' order, then the sum of those
    rows in cluster order into one flat buffer, which the gradients view."""
    n, d = x.shape
    gx = torch.empty_like(x)
    shapes = [(a, b) for a, b in zip(widths[:-1], widths[1:])] + [(b,) for b in widths[1:]]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = x.new_zeros(sum(sizes)) if n == 0 else x.new_empty(sum(sizes))
    if n > 0:
        lib = _general_lib()
        clusters = _general_clusters(tuple(widths), True, n, x.device.index)
        work = x.new_empty(clusters, flat.numel())
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.ar_solve_general_backward(
                x.data_ptr(), y.data_ptr(), gy.data_ptr(), gld.data_ptr(), _ptrs(ws),
                (ctypes.c_int * len(widths))(*widths), len(ws), n, int(sign), float(s_bound),
                _ptrs(tape.z), tape.s.data_ptr(), gx.data_ptr(), flat.data_ptr(),
                work.data_ptr(), clusters, stream)
        _raise_on(err, "general backward")
        _count("general", "backward_launches", sign)
    grads = [g.view(s) for g, s in zip(flat.split(sizes), shapes)]
    return gx, grads[:len(ws)], grads[len(ws):]


def _streamed_backward(x, y, gy, gld, tape: Tape, ws, widths, sign: int, s_bound: float):
    """The streamed backward on tensors already checked: the reverse chain
    (the weights packed, then one cooperative launch), which writes gx and
    every step's deltas, then `sum_grads` over them."""
    lib = _streamed_lib()
    n, d = x.shape
    gx = torch.empty_like(x)
    deltas = [x.new_empty(d, n, w) for w in widths[1:-1]]
    head = x.new_empty(d, n, 2)
    if n > 0:
        plan = _streamed_plan_on(tuple(widths), True, n, x.device.index)
        work = x.new_empty(plan.work)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.ar_solve_streamed_backward(
                x.data_ptr(), y.data_ptr(), gy.data_ptr(), gld.data_ptr(), _ptrs(ws),
                (ctypes.c_int * len(widths))(*widths), len(ws), n, int(sign), float(s_bound),
                _ptrs(tape.z), tape.s.data_ptr(), _ptrs(deltas), head.data_ptr(),
                gx.data_ptr(), (ctypes.c_longlong * 6)(*plan), work.data_ptr(), stream)
        _raise_on(err, "streamed backward")
        _count("streamed", "backward_launches", sign)
    gws, gbs = sum_grads(y, tape, deltas, head)
    return gx, gws, gbs



class _ARSolve(torch.autograd.Function):
    """CUDA: the forward kernel that `route` picks (recording the tape when
    gradients are wanted) and the backward kernel it picks. CPU: the plain
    version, and autograd through `unrolled_solve` (JAX `_ar_solve_bwd`)."""

    @staticmethod
    def forward(ctx, x, sign, s_bound, n_layers, record, *params):
        ws, bs = list(params[:n_layers]), list(params[n_layers:])
        ctx.sign, ctx.s_bound, ctx.n_layers = sign, s_bound, n_layers
        ctx.on_card = x.is_cuda
        if not x.is_cuda:
            ctx.save_for_backward(x, *params)
            return unrolled_solve(x, ws, bs, sign, s_bound)
        widths = _check_params(x, ws, bs)
        limit = _smem_limit(x.device.index)
        # both directions are routed before any launch
        # (looked up at each call, by name, so that a caller may wrap them)
        forward = {"fast": kernel_forward, "general": general_forward,
                   "streamed": streamed_forward}[route(widths, False, limit)]
        ctx.route = route(widths, True, limit) if record else None
        tape = new_tape(x, ws) if record else None
        y, ld = forward(x, ws, bs, sign, s_bound, tape=tape)
        if record:
            ctx.widths = widths
            ctx.save_for_backward(x, y, tape.s, *tape.z, *ws)
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        n = ctx.n_layers
        if ctx.on_card:
            x, y, s, *rest = ctx.saved_tensors
            tape, ws = Tape(rest[:n - 1], s), rest[n - 1:]
            backward = {"fast": _backward, "general": _general_backward,
                        "streamed": _streamed_backward}[ctx.route]
            # the saved tensors were checked by the forward; gy and gld come
            # from autograd with the outputs' shapes
            gx, gws, gbs = backward(x, y, gy.contiguous(), gld.contiguous(), tape, ws,
                                    ctx.widths, ctx.sign, ctx.s_bound)
            return (gx, None, None, None, None, *gws, *gbs)
        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (x, *params)]
            y, ld = unrolled_solve(inputs[0], inputs[1:1 + n], inputs[1 + n:],
                                   ctx.sign, ctx.s_bound)
            grads = torch.autograd.grad((y, ld), inputs, (gy, gld), allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs)]
        return (grads[0], None, None, None, None, *grads[1:])


def ar_solve(x, masked_weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
             sign: int, s_bound: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused autoregressive solve: sign=-1 IAF density direction, sign=+1 MAF
    sampling direction. x: (..., D). Returns (y, logdet). s_bound > 0 bounds
    the log-scale as s -> s_bound * tanh(s / s_bound)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        x2 = x2.contiguous()
        masked_weights = [w.contiguous() for w in masked_weights]
        biases = [b.contiguous() for b in biases]
    params = (*masked_weights, *biases)
    # the forward kernel records its tape only when a backward can follow
    record = torch.is_grad_enabled() and any(t.requires_grad for t in (x2, *params))
    y, ld = _ARSolve.apply(x2, int(sign), float(s_bound), len(masked_weights), record, *params)
    return y.reshape(*lead, -1), ld.reshape(lead)


# kernel launches since the last reset (plain integers; reset by assigning
# 0), a backward call (its launches) counted once: each pair's own ("fast_",
# the 128-wide pair; "general_"; "streamed_", the third route), and with no
# prefix their sum; each of them also at sign -1, IAF's density direction
# ("sign_minus_" after the pair's prefix)
COUNTS = tuple(f"{pair}{sign}{what}" for pair in ("", "fast_", "general_", "streamed_")
               for sign in ("", "sign_minus_") for what in ("launches", "backward_launches"))
for _key in COUNTS:
    setattr(ar_solve, _key, 0)
