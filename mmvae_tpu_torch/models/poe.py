"""Log-space product of Gaussian experts (mmvae_tpu/models/poe.py; reference
mvae.py:27-45, moepoe.py:20-70). Plain functions on tensors.
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Sequence, Tuple

import torch


def _poe(mus: Sequence[torch.Tensor], log_vars: Sequence[torch.Tensor], include_prior: bool):
    """(joint mu, joint log-variance) of the experts, with a standard-normal
    expert (mu 0, log_var 0) appended when `include_prior`."""
    mus, log_vars = list(mus), list(log_vars)
    if include_prior:
        mus.append(torch.zeros_like(mus[0]))
        log_vars.append(torch.zeros_like(log_vars[0]))
    ln_t = torch.stack([-lv for lv in log_vars])  # log precisions
    ln_v = -torch.logsumexp(ln_t, dim=0)          # log joint variance
    return torch.sum(torch.exp(ln_t) * torch.stack(mus), dim=0) * torch.exp(ln_v), ln_v


def poe(mus: Sequence[torch.Tensor], log_vars: Sequence[torch.Tensor], include_prior: bool = True):
    """Gaussian PoE in log space (mvae.py:27-45): (joint mu, joint std)."""
    mu, ln_v = _poe(mus, log_vars, include_prior)
    return mu, torch.exp(0.5 * ln_v)


def poe_log_var(mus, log_vars, subset: Sequence[int], include_prior: bool):
    """PoE over the experts in `subset`: (mu, log_var) (moepoe.py:62-66)."""
    return _poe([mus[i] for i in subset], [log_vars[i] for i in subset], include_prior)


def poe_for_all_subsets(mus, log_vars) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """PoE of every subset of at least two experts, in size then
    lexicographic order; the prior expert joins only the full subset
    (moepoe.py:43-70). Returns (poe_mus, poe_log_vars)."""
    n_mod = len(mus)
    poe_mus, poe_lvs = [], []
    for k in range(2, n_mod + 1):
        for subset in combinations(range(n_mod), k):
            mu, lv = poe_log_var(mus, log_vars, subset, include_prior=(k == n_mod))
            poe_mus.append(mu)
            poe_lvs.append(lv)
    return poe_mus, poe_lvs


def mixture_component_selection(mus, log_vars, block=None):
    """Stratified selection (moepoe.py:20-39): component k takes batch rows
    [k*(B//M), (k+1)*(B//M)), the last component the tail up to B. With
    `block` (parallel/mesh.py), the rows are this rank's block of a global
    batch, and the components split the global batch as one process would."""
    m, b = len(mus), mus[0].shape[0]
    first, rows = (0, b) if block is None else (block.start, block.rows)
    starts = [k * (rows // m) for k in range(m)]
    ends = starts[1:] + [rows]
    # each component's global rows, in this rank's coordinates
    cuts = [(max(s - first, 0), min(e - first, b)) for s, e in zip(starts, ends)]
    mu_sel = torch.cat([mus[k][lo:hi] for k, (lo, hi) in enumerate(cuts) if hi > lo], dim=0)
    lv_sel = torch.cat([log_vars[k][lo:hi] for k, (lo, hi) in enumerate(cuts) if hi > lo], dim=0)
    return mu_sel, lv_sel
