"""IAF / MAF normalizing flows (mmvae_tpu/flows/autoregressive.py).

MAF: forward (density) is the parallel direction, inverse (sampling) the
sequential one. IAF: the other way round. The sequential direction goes
through the fused solve `ops.ar_flow.ar_solve` (the Hopper kernel on CUDA)
unless `use_fused` is False, which runs the plain unrolled solve. Both flows
flip the feature axis after each layer (reference iaf_model.py:78). With
`include_batch_norm` a BatchNormFlow follows each MADE block.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.ar_flow import ar_solve, unrolled_solve
from .layers import BatchNormFlow
from .made import MADE


class _ARFlowBase(nn.Module):
    """Shared stack-of-MADE machinery for IAF/MAF."""

    def __init__(self, features: int, n_made_blocks: int = 2, n_hidden_in_made: int = 3,
                 hidden_size: int = 128, include_batch_norm: bool = False,
                 use_fused: bool = True, s_bound: float = 0.0):
        super().__init__()
        self.features = features
        self.n_made_blocks = n_made_blocks
        self.use_fused = use_fused
        # bounded log-scale s -> s_bound * tanh(s / s_bound); 0 = off
        self.s_bound = s_bound
        self.made = nn.ModuleList(
            MADE(features, (hidden_size,) * n_hidden_in_made) for _ in range(n_made_blocks))
        self.bn = (nn.ModuleList(BatchNormFlow(features) for _ in range(n_made_blocks))
                   if include_batch_norm else None)

    def _parallel_shift_scale(self, made, v, sign: int):
        """One parallel MADE pass.

        sign=-1: v -> (v - mu) * exp(-s), logdet -sum(s)   (MAF density dir)
        sign=+1: v -> v * exp(s) + mu,    logdet +sum(s)   (IAF sampling dir)
        """
        mu, s = made(v)
        if self.s_bound > 0.0:
            s = self.s_bound * torch.tanh(s / self.s_bound)
        if sign < 0:
            out = (v - mu) * torch.exp(-s)
        else:
            out = v * torch.exp(s) + mu
        return out, sign * torch.sum(s, dim=-1)

    def _sequential_shift_scale(self, made, v, sign: int):
        """Autoregressive solve building the output one dim at a time.

        sign=-1: y_i = (v_i - mu_i(y)) * exp(-s_i(y))  (IAF density dir)
        sign=+1: y_i = v_i * exp(s_i(y)) + mu_i(y)     (MAF sampling dir)
        """
        ws, bs = made.masked_layer_params()
        solve = ar_solve if self.use_fused else unrolled_solve
        return solve(v, ws, bs, sign, self.s_bound)


def _run_blocks(flow: _ARFlowBase, x, *, reverse: bool, made_fn):
    """Apply the layers [made_0, bn_0, made_1, bn_1, ...] (the BatchNorm
    layers only with `include_batch_norm`) in order, flipping the features
    after each one. Reverse: layers reversed, the flip BEFORE each layer,
    and the BatchNorm layers inverted (iaf_model.py:91-107)."""
    logdet = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    kinds = ("made",) if flow.bn is None else ("made", "bn")
    layers = [(kind, i) for i in range(flow.n_made_blocks) for kind in kinds]
    for kind, i in (reversed(layers) if reverse else layers):
        if reverse:
            x = torch.flip(x, dims=(-1,))
        if kind == "made":
            x, ld = made_fn(flow.made[i], x)
        else:
            x, ld = flow.bn[i](x, inverse=reverse)
        logdet = logdet + ld
        if not reverse:
            x = torch.flip(x, dims=(-1,))
    return x, logdet


class IAF(_ARFlowBase):
    """Inverse Autoregressive Flow (iaf_model.py)."""

    def forward(self, x):
        """Data -> prior (density direction); sequential per block."""
        return _run_blocks(self, x, reverse=False,
                           made_fn=lambda m, v: self._sequential_shift_scale(m, v, -1))

    def inverse(self, y):
        """Prior -> data (sampling direction); parallel per block."""
        return _run_blocks(self, y, reverse=True,
                           made_fn=lambda m, v: self._parallel_shift_scale(m, v, +1))


class MAF(_ARFlowBase):
    """Masked Autoregressive Flow (external pythae MAF, mirrored directions)."""

    def forward(self, x):
        """Data -> prior (density direction); parallel per block."""
        return _run_blocks(self, x, reverse=False,
                           made_fn=lambda m, v: self._parallel_shift_scale(m, v, -1))

    def inverse(self, y):
        """Prior -> data (sampling direction); sequential per block."""
        return _run_blocks(self, y, reverse=True,
                           made_fn=lambda m, v: self._sequential_shift_scale(m, v, +1))
