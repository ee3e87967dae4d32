"""Fused autoregressive-flow solve (mmvae_tpu/ops/ar_flow.py).

`ar_solve` runs the whole D-step sequential solve of one MADE block. On a
CUDA tensor its forward is the hand-written Hopper kernel in
csrc/ar_flow.cu (one launch per call); on a CPU tensor it is the plain
PyTorch version `unrolled_solve`. Its backward is the JAX package's own
gradient design (`_ar_solve_bwd`): autograd through `unrolled_solve`,
re-run from the saved inputs, for x, every weight and every bias.

The masked weights arrive with the mask already applied, as in JAX: the
mask multiply stays outside the autograd Function, so gradients reach the
raw MADE kernels through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

_SOURCE = "ar_flow.cu"


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


def _check(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> List[int]:
    """Validate what the kernel can take; returns the layer widths."""
    if x.dim() != 2:
        raise ValueError("x must be (N, D)")
    d = x.shape[1]
    if d < 2:
        raise ValueError(f"D must be at least 2, got {d}")
    if len(ws) != len(bs) or len(ws) < 2:
        raise ValueError("need matching weights and biases for >= 1 hidden layer and the head")
    widths = [d] + [int(w.shape[1]) for w in ws]
    if widths[-1] != 2 * d:
        raise ValueError(f"head width {widths[-1]} != 2*D = {2 * d}")
    for li, (w, b) in enumerate(zip(ws, bs)):
        if tuple(w.shape) != (widths[li], widths[li + 1]) or tuple(b.shape) != (widths[li + 1],):
            raise ValueError(f"layer {li}: weight {tuple(w.shape)}, bias {tuple(b.shape)} "
                             f"do not chain from width {widths[li]}")
    for t in [x, *ws, *bs]:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("ar_solve kernel takes contiguous float32 tensors on one CUDA device")
    return widths


def _lib():
    from .build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.ar_solve_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.ar_solve_smem_bytes.restype = ctypes.c_longlong
        lib.ar_solve_forward.argtypes = [
            vp, ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, vp, vp, vp]
        lib.ar_solve_forward.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _check_smem(widths: Tuple[int, ...], device_index: int) -> int:
    """Shared memory one block needs at these layer widths, checked against
    the device's limit once per (widths, device)."""
    arr = (ctypes.c_int * len(widths))(*widths)
    need = int(_lib().ar_solve_smem_bytes(arr, len(widths) - 1))
    limit = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    if need < 0 or need > limit:
        raise ValueError(f"ar_solve needs {need} bytes of shared memory per block at widths "
                         f"{list(widths)}; the device allows {limit}")
    return need


def kernel_forward(x, masked_weights, biases, sign: int, s_bound: float = 0.0):
    """Launch the Hopper kernel on (N, D) CUDA tensors. Returns (y, logdet)."""
    ws, bs = list(masked_weights), list(biases)
    if not x.is_cuda:
        raise ValueError("kernel_forward takes CUDA tensors")
    widths = _check(x, ws, bs)
    lib = _lib()
    _check_smem(tuple(widths), x.device.index)
    n = x.shape[0]
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y, ld
    vp = ctypes.c_void_p
    w_ptrs = (vp * len(ws))(*[w.data_ptr() for w in ws])
    b_ptrs = (vp * len(bs))(*[b.data_ptr() for b in bs])
    width_arr = (ctypes.c_int * len(widths))(*widths)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ar_solve_forward(x.data_ptr(), w_ptrs, b_ptrs, width_arr, len(ws), n,
                                   int(sign), float(s_bound), y.data_ptr(), ld.data_ptr(),
                                   stream)
    if err != 0:
        raise RuntimeError(f"ar_solve kernel launch failed: CUDA error {err}")
    ar_solve.launches += 1
    return y, ld


class _ARSolve(torch.autograd.Function):
    """Kernel forward (plain version on CPU); backward = autograd through
    `unrolled_solve` (JAX `_ar_solve_bwd`)."""

    @staticmethod
    def forward(ctx, x, sign, s_bound, n_layers, *params):
        ws, bs = list(params[:n_layers]), list(params[n_layers:])
        ctx.sign, ctx.s_bound, ctx.n_layers = sign, s_bound, n_layers
        ctx.save_for_backward(x, *params)
        if x.is_cuda:
            return kernel_forward(x, ws, bs, sign, s_bound)
        return unrolled_solve(x, ws, bs, sign, s_bound)

    @staticmethod
    def backward(ctx, gy, gld):
        x, *params = ctx.saved_tensors
        n = ctx.n_layers
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (x, *params)]
            y, ld = unrolled_solve(inputs[0], inputs[1:1 + n], inputs[1 + n:],
                                   ctx.sign, ctx.s_bound)
            grads = torch.autograd.grad((y, ld), inputs, (gy, gld), allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs)]
        return (grads[0], None, None, None, *grads[1:])


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
    y, ld = _ARSolve.apply(x2, int(sign), float(s_bound), len(masked_weights),
                           *masked_weights, *biases)
    return y.reshape(*lead, -1), ld.reshape(lead)


# kernel launches since the last reset (a plain integer; reset by assigning 0)
ar_solve.launches = 0
