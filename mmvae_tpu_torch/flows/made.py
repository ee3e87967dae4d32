"""MADE: masked autoregressive MLP (mmvae_tpu/flows/made.py).

Sequential degree ordering, hidden masks m_i >= m_{i-1}, a strict output
mask m_hidden < d, and an output layer emitting [mu, log_var] with the mask
repeated (reference made_model.py:49-111). Masks are constant buffers in the
(in, out) layout of the JAX package, and so are the kernels: the fused solve
(ops/ar_flow.py) takes them as they are.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


def sequential_degrees(features: int, hidden_sizes: Sequence[int]):
    """Degrees for sequential ordering (made_model.py:72-75)."""
    degrees = [np.arange(features)]
    for h in hidden_sizes:
        degrees.append(np.arange(h) % (features - 1))
    return degrees


def build_masks(features: int, hidden_sizes: Sequence[int]):
    """Masks in (in, out) layout for `x @ kernel`."""
    degs = sequential_degrees(features, hidden_sizes)
    masks = []
    for prev, cur in zip(degs[:-1], degs[1:]):
        masks.append((cur[None, :] >= prev[:, None]).astype(np.float32))
    # strict output mask: hidden degree < output dim (made_model.py:88-93)
    out_mask = (degs[-1][:, None] < np.arange(features)[None, :]).astype(np.float32)
    return masks, out_mask


# flax lecun_normal: truncated_normal(-2, 2) scaled so the truncated
# distribution has variance 1/fan_in (0.8796... is the std of a standard
# normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


class MaskedDense(nn.Module):
    """Dense layer with a constant binary mask on its (in, out) kernel."""

    def __init__(self, in_features: int, features: int, mask: np.ndarray):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mask", torch.as_tensor(np.asarray(mask, np.float32)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        std = math.sqrt(1.0 / self.kernel.shape[0]) / _TRUNC_STD
        w = torch.empty(self.kernel.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.kernel.copy_(w)
        self.bias.zero_()

    def masked_kernel(self):
        return self.mask * self.kernel

    def forward(self, x):
        return x @ self.masked_kernel() + self.bias


class MADE(nn.Module):
    """Masked autoencoder emitting (mu, log_var) heads (made_model.py:97-111)."""

    def __init__(self, features: int, hidden_sizes: Sequence[int]):
        super().__init__()
        self.features = features
        masks, out_mask = build_masks(features, tuple(hidden_sizes))
        layers, in_f = [], features
        for h, m in zip(hidden_sizes, masks):
            layers.append(MaskedDense(in_f, h, m))
            in_f = h
        self.hidden = nn.ModuleList(layers)
        # [mu, log_var] heads share the strict mask (made_model.py:58-64)
        self.out = MaskedDense(in_f, 2 * features, np.concatenate([out_mask, out_mask], axis=1))

    def masked_layer_params(self):
        """[masked kernels], [biases] of the hidden layers and the head, for
        the fused solve."""
        layers = [*self.hidden, self.out]
        return [l.masked_kernel() for l in layers], [l.bias for l in layers]

    def forward(self, x):
        h = x
        for layer in self.hidden:
            h = torch.relu(layer(h))
        out = self.out(h)
        return out[..., : self.features], out[..., self.features:]
