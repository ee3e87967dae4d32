"""The invertible BatchNorm flow layer (mmvae_tpu/flows/layers.py;
reference normalizing_flows/layers.py:28-95)."""

from __future__ import annotations

import torch
from torch import nn

from ..nets.conv import RunningStats


class BatchNormFlow(RunningStats):
    """BatchNorm with a log-det, usable in both flow directions. In training
    the forward (density) direction normalizes by the batch's statistics
    over axis 0, the variance unbiased (ddof 1), and moves the running
    buffers `mean` and `var` by `momentum`; the inverse direction and eval
    mode use the running buffers. The log-det per row is
    sum(log_gamma - 0.5 log(var + eps)), negated in the inverse."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(features)
        self.eps, self.momentum = eps, momentum
        self.log_gamma = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for t, v in ((self.log_gamma, 0.0), (self.beta, 0.0), (self.mean, 0.0), (self.var, 1.0)):
            t.fill_(v)

    def forward(self, x, inverse: bool = False):
        if self.training and not inverse:
            if self.stats_block is None:
                mean = torch.mean(x, dim=0)
                var = torch.var(x, dim=0, correction=1)
            else:
                # the global batch's, from the ranks' summed sums and counts
                count = x.new_full((1,), x.shape[0])
                sums = self.stats_block.sum(torch.cat([x.sum(0), (x * x).sum(0), count]))
                n = sums[-1]
                mean, sq = sums[:-1].chunk(2)
                mean = mean / n
                var = (sq - n * mean * mean) / (n - 1)
            with torch.no_grad():
                self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var + self.momentum * var)
        else:
            mean, var = self.mean, self.var
        if inverse:
            y = (x - self.beta) * torch.exp(-self.log_gamma) * torch.sqrt(var + self.eps) + mean
            log_det = -self.log_gamma + 0.5 * torch.log(var + self.eps)
        else:
            y = (x - mean) / torch.sqrt(var + self.eps) * torch.exp(self.log_gamma) + self.beta
            log_det = self.log_gamma - 0.5 * torch.log(var + self.eps)
        return y, torch.sum(log_det * torch.ones_like(x), dim=-1)
