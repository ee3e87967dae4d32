"""Linear and conv primitives on NCHW tensors (mmvae_tpu/nets/conv.py).

Same shapes and init distributions as the JAX package: weights uniform in
+-sqrt(3/fan_in), biases uniform in +-1/sqrt(fan_in). Parameters use
PyTorch's layouts: Linear (out, in), Conv2d (out, in, kh, kw),
ConvTranspose2d (in, out, kh, kw); bridge.py converts from and to the JAX
trees. Every module here re-draws its parameters from an explicit
`torch.Generator` in `reset_parameters`, so the draws do not depend on the
device the module lives on.

Every forward goes through core/precision.py, which casts the operands
under a reduced-precision policy and is a no-op under the default one.
`head=True` convs (distribution parameters) keep their output out of the
activation-storage downcast.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import precision


@torch.no_grad()
def _uniform_(param: torch.Tensor, bound: float, generator=None):
    # drawn on the CPU and copied, so a seed gives the same weights on any device
    param.copy_(torch.empty(param.shape).uniform_(-bound, bound, generator=generator))


class _Kaiming(nn.Module):
    """Weight (and optional bias) with the JAX package's kaiming-uniform init."""

    def __init__(self, weight_shape, fan_in: int, features: int, use_bias: bool):
        super().__init__()
        self.fan_in = fan_in
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, math.sqrt(3.0) * bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


class Linear(_Kaiming):
    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__((features, in_features), in_features, features, use_bias)

    def forward(self, x):
        return precision.linear(x, self.weight, self.bias)


class Conv2d(_Kaiming):
    """Cross-correlation, NCHW."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, head: bool = False):
        k = kernel_size
        super().__init__((features, in_channels, k, k), in_channels * k * k, features, use_bias)
        self.stride, self.padding, self.head = stride, padding, head

    def forward(self, x):
        return precision.conv(F.conv2d, x, self.weight, self.bias, self.head,
                              stride=self.stride, padding=self.padding)


class ConvTranspose2d(_Kaiming):
    """out = (in - 1)*stride - 2*padding + kernel + output_padding. The JAX
    package computes it as an input-dilated convolution with the kernel
    flipped; PyTorch's conv_transpose2d takes the same (in, out, kh, kw)
    array unflipped (tests/test_torch_modules.py holds the two together)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = True,
                 head: bool = False):
        k = kernel_size
        # weight (in, out, kh, kw): fan_in = out * kh * kw, as torch and JAX
        super().__init__((in_channels, features, k, k), features * k * k, features, use_bias)
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.head = head

    def forward(self, x):
        return precision.conv(F.conv_transpose2d, x, self.weight, self.bias, self.head,
                              stride=self.stride, padding=self.padding,
                              output_padding=self.output_padding)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of `model` from `generator`, module by module
    in registration order."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
