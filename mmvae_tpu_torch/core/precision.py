"""Compute-dtype policy for the matmul and conv primitives (mixed precision;
mmvae_tpu/core/precision.py).

Parameters and optimizer state keep their dtype (float32). Under the
"bfloat16" policy the operands of every Linear and conv are cast to
bfloat16:

- Linear returns float32, the products summed in float32 (JAX's
  `preferred_element_type`). On CUDA that is `torch.mm(..., out_dtype=
  torch.float32)` inside an autograd Function (PyTorch has no derivative
  for the mixed-dtype mm); on the CPU, the bfloat16-rounded operands
  multiplied in float32, which is exact, since a bfloat16 x bfloat16
  product fits in float32.
- A conv rounds its final output to bfloat16 once, then upcasts (JAX's
  bf16 conv followed by `.astype(float32)`): cuDNN's bfloat16 conv on CUDA,
  a float32 conv of the rounded operands then one rounding on the CPU.
- Every gradient with respect to a cast operand is rounded to bfloat16, as
  JAX's transpose rules return the operand's dtype.

A second, separate opt-in, "activation_dtype", stores conv outputs in that
dtype between layers; `head=True` layers (distribution parameters) never
take it. Elementwise math, log-probs and reductions run in the dtype of
their inputs: a bfloat16 activation meeting a float32 operand is promoted.

The Trainer enters `use(compute_dtype, activation_dtype)` around its train
and eval steps; the layers read the policy when they run.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_POLICY = contextvars.ContextVar("mmvae_tpu_torch_compute_dtype", default=None)
_ACT_POLICY = contextvars.ContextVar("mmvae_tpu_torch_activation_dtype", default=None)

_NAMES = {"float32": None, "f32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def parse(name) -> Optional[torch.dtype]:
    """Config value -> dtype; None for the default (no cast, the
    parameters' own dtype). Unknown names raise."""
    if name is None or name == "":
        return None
    if isinstance(name, torch.dtype):
        return None if name == torch.float32 else name
    if name not in _NAMES:
        raise ValueError(f"unknown precision {name!r}; expected one of {sorted(_NAMES)}")
    return _NAMES[name]


def compute_dtype() -> Optional[torch.dtype]:
    """Dtype matmul/conv operands are cast to, or None for no cast."""
    return _POLICY.get()


def activation_dtype() -> Optional[torch.dtype]:
    """Dtype conv activations are stored in between layers, or None."""
    return _ACT_POLICY.get()


@contextlib.contextmanager
def use(dtype, act_dtype=None):
    """Pin the compute (and optionally conv-activation) dtype for the
    layers run inside this context. Takes config names or torch dtypes."""
    token = _POLICY.set(parse(dtype))
    atoken = _ACT_POLICY.set(parse(act_dtype))
    try:
        yield
    finally:
        _POLICY.reset(token)
        _ACT_POLICY.reset(atoken)


class _MatmulF32(torch.autograd.Function):
    """x @ w.T of two reduced-precision CUDA matrices, returned in float32
    with float32 sums. Gradients come back in the operands' dtype, each
    product summed in float32 and rounded once."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w, out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(g.t(), x, out_dtype=torch.float32).to(w.dtype)
        return gx, gw


def _device_form(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no {compute_dtype()} policy for tensors on {x.device}")


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """F.linear under the policy; returns the weight's dtype."""
    d = compute_dtype() or weight.dtype
    if d == weight.dtype:
        return F.linear(x.to(d), weight, bias)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(d)
    if _device_form(x2) == "cuda":
        y = _MatmulF32.apply(x2, weight.to(d)).to(weight.dtype)
    else:
        y = F.linear(x2.to(weight.dtype), weight.to(d).to(weight.dtype))
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, y.shape[-1])


def conv(fn: Callable, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
         head: bool = False, **kw) -> torch.Tensor:
    """A conv (`F.conv2d` or `F.conv_transpose2d`) under the policy: the
    output rounded to the compute dtype once, then in the weight's dtype
    with the bias; stored in the activation dtype unless `head`."""
    d = compute_dtype() or weight.dtype
    if d == weight.dtype:
        y = fn(x.to(d), weight, bias, **kw)
    else:
        if _device_form(x) == "cuda":
            y = fn(x.to(d), weight.to(d), None, **kw)
        else:
            wd = weight.dtype
            y = fn(x.to(d).to(wd), weight.to(d).to(wd), None, **kw).to(d)
        y = y.to(weight.dtype)
        if bias is not None:
            y = y + bias[None, :, None, None]
    act = activation_dtype()
    return y if head or act is None else y.to(act)
