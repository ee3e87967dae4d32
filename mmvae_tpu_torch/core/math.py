"""Small math helpers (mmvae_tpu/core/math.py)."""

from __future__ import annotations

import math

import torch


def log_mean_exp(value: torch.Tensor, dim: int = 0, keepdim: bool = False) -> torch.Tensor:
    """logsumexp - log(N) over `dim` (utils.py:143)."""
    return torch.logsumexp(value, dim=dim, keepdim=keepdim) - math.log(value.shape[dim])


def chunked_logsumexp_mean(log_terms_fn, num_chunks: int, chunk_size: int) -> torch.Tensor:
    """log((1/K) sum_k exp(term_k)), K = num_chunks * chunk_size, in the
    reference's order (multi_vaes.py:242-248): a logsumexp per chunk, then
    one over the chunks, minus log K.

    log_terms_fn: chunk index -> (..., chunk_size) log-weights; the leading
    dims (datapoints) are kept."""
    per_chunk = torch.stack([torch.logsumexp(log_terms_fn(i), dim=-1) for i in range(num_chunks)])
    return torch.logsumexp(per_chunk, dim=0) - math.log(num_chunks * chunk_size)
