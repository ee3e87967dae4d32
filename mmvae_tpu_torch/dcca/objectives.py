"""DCCA objectives (mmvae_tpu/dcca/objectives.py; reference
dcca/objectives.py:4-108).

Two formulations of the sum of the top-k canonical correlations:

- `cca_corr`: the reference's eigendecomposition form, with the JAX
  package's eps floor on the eigenvalues. Its gradient is autograd through
  `torch.linalg.eigh`. It is the float64 CPU reference.
- `cca_corr_chol`: whitening by Cholesky factors and triangular solves; the
  only spectral op, the singular values of the small whitened matrix T,
  carries a hand-written backward (`_SumTopkSV`), JAX's custom VJP:
      corr = sum_k sqrt(sigma_k(T)^2 + r),  dcorr/dT = sum_k c_k u_k v_k^T,
      c_k = sigma_k / sqrt(sigma_k^2 + r), zero beyond the top k.
  It is the form that trains on the card, in float32.
"""

from __future__ import annotations

import torch


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def cca_corr(h1: torch.Tensor, h2: torch.Tensor, outdim_size: int,
             use_all_singular_values: bool = False,
             r1: float = 1e-3, r2: float = 1e-3, eps: float = 1e-9) -> torch.Tensor:
    """Sum of the top-k canonical correlations (the loss is its negation).
    h1, h2: (batch, features) network outputs."""
    H1, H2 = h1.T, h2.T
    o1, o2 = H1.shape[0], H2.shape[0]
    m = H1.shape[1]

    H1bar = H1 - H1.mean(dim=1, keepdim=True)
    H2bar = H2 - H2.mean(dim=1, keepdim=True)

    S12 = (1.0 / (m - 1)) * (H1bar @ H2bar.T)
    S11 = (1.0 / (m - 1)) * (H1bar @ H1bar.T) + r1 * _eye(o1, h1)
    S22 = (1.0 / (m - 1)) * (H2bar @ H2bar.T) + r2 * _eye(o2, h1)

    def root_inv(S):
        d, v = torch.linalg.eigh(S)
        d = torch.clamp(d, min=eps)  # stability floor (objectives.py:55-61)
        return (v * (d ** -0.5)) @ v.T

    Tval = root_inv(S11) @ S12 @ root_inv(S22)

    if use_all_singular_values:
        d = torch.linalg.eigh(Tval.T @ Tval)[0]
        return torch.sum(torch.sqrt(torch.clamp(d, min=eps)))
    d = torch.linalg.eigh(Tval.T @ Tval + r1 * _eye(Tval.shape[1], h1))[0]
    d = torch.clamp(d, min=eps)
    return torch.sum(torch.sqrt(torch.topk(d, outdim_size).values))


def cca_loss(h1, h2, outdim_size, use_all_singular_values=False):
    """Negative correlation, the training loss (objectives.py:85)."""
    return -cca_corr(h1, h2, outdim_size, use_all_singular_values)


def mcca_loss(h_list, outdim_size, use_all_singular_values=False):
    """Pairwise sum for >= 3 modalities (objectives.py:89-108)."""
    loss = 0.0
    for i in range(len(h_list)):
        for j in range(i + 1, len(h_list)):
            loss = loss + cca_loss(h_list[i], h_list[j], outdim_size, use_all_singular_values)
    return loss


class _SumTopkSV(torch.autograd.Function):
    """sum_k sqrt(s_k^2 + r) over the top k singular values of T, with JAX's
    `_sum_topk_sv_bwd` as the backward (no autograd through the SVD)."""

    @staticmethod
    def forward(ctx, T, k: int, r: float):
        u, s, vt = torch.linalg.svd(T, full_matrices=False)
        ctx.save_for_backward(u, s, vt)
        ctx.k, ctx.r = k, r
        return torch.sum(torch.sqrt(torch.topk(s ** 2 + r, k).values))

    @staticmethod
    def backward(ctx, g):
        u, s, vt = ctx.saved_tensors
        coef = s / torch.sqrt(s ** 2 + ctx.r)
        # zero the singular directions beyond the top k (s is sorted descending)
        keep = torch.arange(s.shape[0], device=s.device) < ctx.k
        coef = torch.where(keep, coef, torch.zeros_like(coef))
        return g * (u * coef[None, :]) @ vt, None, None


def sum_topk_sv(T: torch.Tensor, k: int, r: float) -> torch.Tensor:
    return _SumTopkSV.apply(T, k, r)


def cca_corr_chol(h1: torch.Tensor, h2: torch.Tensor, outdim_size: int,
                  use_all_singular_values: bool = False,
                  r1: float = 1e-3, r2: float = 1e-3) -> torch.Tensor:
    """Sum of the top-k canonical correlations through Cholesky whitening:
    T = L1^{-1} S12 L2^{-T} has the singular values of S11^{-1/2} S12
    S22^{-1/2}, since both whiten the two covariances."""
    m = h1.shape[0]
    h1b = h1 - h1.mean(dim=0, keepdim=True)
    h2b = h2 - h2.mean(dim=0, keepdim=True)
    S12 = (h1b.T @ h2b) / (m - 1)
    S11 = (h1b.T @ h1b) / (m - 1) + r1 * _eye(h1.shape[1], h1)
    S22 = (h2b.T @ h2b) / (m - 1) + r2 * _eye(h2.shape[1], h2)
    L1 = torch.linalg.cholesky(S11)
    L2 = torch.linalg.cholesky(S22)
    T = torch.linalg.solve_triangular(L1, S12, upper=False)
    T = torch.linalg.solve_triangular(L2, T.T, upper=False).T
    k = min(T.shape) if use_all_singular_values else outdim_size
    r = 0.0 if use_all_singular_values else r1
    return sum_topk_sv(T, k, r)


def cca_loss_chol(h1, h2, outdim_size, use_all_singular_values=False):
    return -cca_corr_chol(h1, h2, outdim_size, use_all_singular_values)


def mcca_loss_chol(h_list, outdim_size, use_all_singular_values=False):
    loss = 0.0
    for i in range(len(h_list)):
        for j in range(i + 1, len(h_list)):
            loss = loss + cca_loss_chol(h_list[i], h_list[j], outdim_size,
                                        use_all_singular_values)
    return loss
