"""Small math helpers (mmvae_tpu/core/math.py)."""

from __future__ import annotations

import math

import torch


def log_mean_exp(value: torch.Tensor, dim: int = 0, keepdim: bool = False) -> torch.Tensor:
    """logsumexp - log(N) over `dim` (utils.py:143)."""
    return torch.logsumexp(value, dim=dim, keepdim=keepdim) - math.log(value.shape[dim])
