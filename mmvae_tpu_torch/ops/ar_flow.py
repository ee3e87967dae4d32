"""Fused autoregressive-flow solve (mmvae_tpu/ops/ar_flow.py).

`ar_solve` runs the whole D-step sequential solve of one MADE block. On a
CUDA tensor its forward is the hand-written Hopper kernel in
csrc/ar_flow.cu (one launch per call), and its backward is the backward
kernel there (one launch per call) followed by one matrix product and one
sum per layer for the weight and bias gradients. On a CPU tensor the
forward is the plain PyTorch version `unrolled_solve` and the backward is
the JAX package's own design (`_ar_solve_bwd`): autograd through
`unrolled_solve`, re-run from the saved inputs.

The backward kernel's algorithm has a plain version too, `plain_tape` and
`plain_backward`: the same reverse chain and the same scratch layout in
explicit PyTorch, so that the CPU tests can hold the algorithm and the
wrapper's reduction `reduce_grads` against JAX.

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
KERNEL_HIDDEN = 128  # the one hidden width the kernels take


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
            h = torch.relu(h @ masked_weights[li] + biases[li])
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
    acts[l]: (D, N, width of layer l's input), the input of layer l (acts[0]
    is the partly built y); s: (D, N), the head's log-scale before the
    bound."""
    acts: List[torch.Tensor]
    s: torch.Tensor


def new_tape(x: torch.Tensor, masked_weights: Sequence[torch.Tensor]) -> Tape:
    n, d = x.shape
    acts = [x.new_empty(d, n, w.shape[0]) for w in masked_weights]
    return Tape(acts, x.new_empty(d, n))


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
            tape.acts[li][i] = h
            h = torch.relu(h @ ws[li] + bs[li])
        tape.acts[-1][i] = h
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


def plain_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int, s_bound: float = 0.0):
    """Plain version of the backward kernel on (N, D) tensors: the reverse
    chain over i = D-1..0. Returns (gx, deltas), deltas[l] (D, N, width of
    layer l's output): the gradient at layer l's pre-activation output at
    each step. y's gradient at feature i is gy_i plus what the first layer
    of every later step sends back, W0[i, :] . dsum, where dsum sums the
    first layer's deltas of the steps after i."""
    ws = list(masked_weights)
    n, d = x.shape
    gx = torch.empty_like(x)
    deltas = [x.new_zeros(d, n, w.shape[1]) for w in ws]
    dsum = x.new_zeros(n, ws[0].shape[1])
    for i in reversed(range(d)):
        g, s_raw = gy[:, i] + dsum @ ws[0][i], tape.s[i]
        s, ds = s_raw, 1.0
        if s_bound > 0.0:
            t = torch.tanh(s_raw / s_bound)
            s, ds = s_bound * t, 1.0 - t * t
        if sign < 0:
            gx[:, i] = g * torch.exp(-s)
            g_mu, g_s = -gx[:, i], -g * y[:, i] - gld
        else:
            e = torch.exp(s)
            gx[:, i] = g * e
            g_mu, g_s = g, g * x[:, i] * e + gld
        g_s = g_s * ds
        deltas[-1][i, :, i], deltas[-1][i, :, i + d] = g_mu, g_s
        g_in = g_mu[:, None] * ws[-1][:, i] + g_s[:, None] * ws[-1][:, i + d]
        for li in range(len(ws) - 2, -1, -1):
            deltas[li][i] = g_in * (tape.acts[li + 1][i] > 0)
            if li > 0:
                g_in = deltas[li][i] @ ws[li].T
        dsum += deltas[0][i]
    return gx, deltas


def reduce_grads(tape: Tape, deltas: Sequence[torch.Tensor]):
    """Weight and bias gradients from the per-step layer inputs and deltas:
    sums over rows and steps, one matrix product and one sum per layer."""
    gws, gbs = [], []
    for a, dl in zip(tape.acts, deltas):
        a2, d2 = a.reshape(-1, a.shape[-1]), dl.reshape(-1, dl.shape[-1])
        gws.append(a2.T @ d2)
        gbs.append(d2.sum(0))
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


def _check(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> List[int]:
    """Validate what the forward kernel can take; returns the layer widths."""
    widths = _widths(x, ws)
    if len(bs) != len(ws):
        raise ValueError("need one bias per weight")
    for li, b in enumerate(bs):
        if tuple(b.shape) != (widths[li + 1],):
            raise ValueError(f"layer {li}: bias {tuple(b.shape)} != ({widths[li + 1]},)")
    _check_like(x, [x, *ws, *bs])
    _check_hidden(widths)
    return widths


def _check_hidden(widths: List[int]) -> None:
    """The kernels are built for hidden layers of KERNEL_HIDDEN only, the
    width of the port's MADE blocks (csrc/ar_flow.cu, kHidden)."""
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
            vp, vp, vp, vp, pp, ctypes.POINTER(ci), ci, ci, ci, cf, pp, vp, vp, pp, vp]
        lib.ar_solve_backward.restype = ci
        lib._typed = True
    return lib


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


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ar_solve {what} kernel launch failed: CUDA error {err}")


def kernel_forward(x, masked_weights, biases, sign: int, s_bound: float = 0.0,
                   tape: Tape | None = None):
    """Launch the Hopper forward kernel on (N, D) CUDA tensors. Returns
    (y, logdet). With `tape` (from `new_tape`) the launch also records the
    per-step layer inputs and raw log-scales the backward needs."""
    ws, bs = list(masked_weights), list(biases)
    if not x.is_cuda:
        raise ValueError("kernel_forward takes CUDA tensors")
    widths = _check(x, ws, bs)
    lib = _lib()
    _check_smem(tuple(widths), x.device.index, False)
    n, d = x.shape
    if tape is not None:
        for li, a in enumerate(tape.acts):
            _check_shape(f"tape.acts[{li}]", a, (d, n, widths[li]))
        _check_shape("tape.s", tape.s, (d, n))
        _check_like(x, [*tape.acts, tape.s])
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y, ld
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ar_solve_forward(
            x.data_ptr(), _ptrs(ws), _ptrs(bs), (ctypes.c_int * len(widths))(*widths), len(ws),
            n, int(sign), float(s_bound), y.data_ptr(), ld.data_ptr(),
            None if tape is None else _ptrs(tape.acts),
            None if tape is None else tape.s.data_ptr(), stream)
    _raise_on(err, "forward")
    ar_solve.launches += 1
    ar_solve.sign_minus_launches += int(sign < 0)
    return y, ld


def kernel_backward(x, y, gy, gld, tape: Tape, masked_weights, sign: int, s_bound: float = 0.0):
    """Launch the Hopper backward kernel on (N, D) CUDA tensors: the same
    result as `plain_backward`, (gx, deltas)."""
    ws = list(masked_weights)
    if not x.is_cuda:
        raise ValueError("kernel_backward takes CUDA tensors")
    widths = _widths(x, ws)
    n, d = x.shape
    for name, t in (("y", y), ("gy", gy)):
        _check_shape(name, t, (n, d))
    _check_shape("gld", gld, (n,))
    for li, a in enumerate(tape.acts):
        _check_shape(f"tape.acts[{li}]", a, (d, n, widths[li]))
    _check_shape("tape.s", tape.s, (d, n))
    _check_like(x, [x, *ws, y, gy, gld, *tape.acts, tape.s])
    _check_hidden(widths)
    return _backward(x, y, gy, gld, tape, ws, widths, sign, s_bound)


def _backward(x, y, gy, gld, tape: Tape, ws, widths, sign: int, s_bound: float):
    """The backward launch on tensors already checked."""
    lib = _lib()
    _check_smem(tuple(widths), x.device.index, True)
    n, d = x.shape
    gx = torch.empty_like(x)
    deltas = [x.new_empty(d, n, w) for w in widths[1:]]
    if n == 0:
        return gx, deltas
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ar_solve_backward(
            x.data_ptr(), y.data_ptr(), gy.data_ptr(), gld.data_ptr(), _ptrs(ws),
            (ctypes.c_int * len(widths))(*widths), len(ws), n, int(sign), float(s_bound),
            _ptrs(tape.acts), tape.s.data_ptr(), gx.data_ptr(), _ptrs(deltas), stream)
    _raise_on(err, "backward")
    ar_solve.backward_launches += 1
    ar_solve.sign_minus_backward_launches += int(sign < 0)
    return gx, deltas


class _ARSolve(torch.autograd.Function):
    """CUDA: forward kernel (recording the tape when gradients are wanted)
    and backward kernel plus `reduce_grads`. CPU: the plain version, and
    autograd through `unrolled_solve` (JAX `_ar_solve_bwd`)."""

    @staticmethod
    def forward(ctx, x, sign, s_bound, n_layers, record, *params):
        ws, bs = list(params[:n_layers]), list(params[n_layers:])
        ctx.sign, ctx.s_bound, ctx.n_layers = sign, s_bound, n_layers
        ctx.on_card = x.is_cuda
        if not x.is_cuda:
            ctx.save_for_backward(x, *params)
            return unrolled_solve(x, ws, bs, sign, s_bound)
        tape = new_tape(x, ws) if record else None
        y, ld = kernel_forward(x, ws, bs, sign, s_bound, tape=tape)
        if record:
            ctx.widths = [x.shape[1]] + [w.shape[1] for w in ws]
            ctx.save_for_backward(x, y, tape.s, *tape.acts, *ws)
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        n = ctx.n_layers
        if ctx.on_card:
            x, y, s, *rest = ctx.saved_tensors
            tape, ws = Tape(rest[:n], s), rest[n:]
            # the saved tensors were checked by the forward; gy and gld come
            # from autograd with the outputs' shapes
            gx, deltas = _backward(x, y, gy.contiguous(), gld.contiguous(), tape, ws, ctx.widths,
                                   ctx.sign, ctx.s_bound)
            gws, gbs = reduce_grads(tape, deltas)
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
# 0), and among them those at sign -1, IAF's density direction
ar_solve.launches = 0
ar_solve.backward_launches = 0
ar_solve.sign_minus_launches = 0
ar_solve.sign_minus_backward_launches = 0
