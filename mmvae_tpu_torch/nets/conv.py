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


class RunningStats(nn.Module):
    """A module with BatchNorm running statistics: the buffers `mean` and
    `var`, which a training-mode forward updates in place, kept by the JAX
    package in its `batch_stats` collection at `jax_scope` below the
    module's own path."""

    jax_scope: tuple = ()

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))


class _BatchNorm(RunningStats):
    """flax.linen.BatchNorm written out. In training the batch's statistics
    normalize, with the variance as flax computes it, E[x^2] - E[x]^2 clamped
    at 0, and the running statistics take `momentum` of them, the running
    variance the BIASED batch variance (torch.nn.BatchNorm* takes the
    unbiased one). In eval mode the running statistics normalize.
    `momentum` is torch's convention: flax's momentum is 1 - momentum."""

    axis: int = 1

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(features)
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for t, v in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0), (self.var, 1.0)):
                t.fill_(v)

    def forward(self, x):
        # statistics in at least float32, as flax computes them
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [d for d in range(x.dim()) if d != self.axis % x.dim()]
        shape = [1] * x.dim()
        shape[self.axis] = -1
        if self.training:
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def batchnorm_stats(model: nn.Module):
    """The running means and variances of every BatchNorm in `model`, the
    flows' BatchNormFlow layers too, which a training-mode forward updates
    in place."""
    return [t for m in model.modules() if isinstance(m, RunningStats) for t in (m.mean, m.var)]


class BatchNorm2d(_BatchNorm):
    """torch.nn.BatchNorm2d's place on NCHW (momentum 0.1, eps 1e-5), with
    flax's statistics (JAX nets/conv.py BatchNorm2d, a flax BatchNorm named
    "bn" over axis 1)."""

    axis = 1
    jax_scope = ("bn",)


class BatchNorm(_BatchNorm):
    """flax nn.BatchNorm over the last axis; flax's momentum 0.9 is 0.1 here."""

    axis = -1


class Dropout(nn.Module):
    """flax nn.Dropout: in training each entry is kept with probability
    1 - rate and scaled by 1 / (1 - rate); the keep mask is u < 1 - rate for
    u uniform, drawn from `generator`. The identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of `model` from `generator`, module by module
    in registration order."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
