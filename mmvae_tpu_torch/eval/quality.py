"""Quality assessment harness (mmvae_tpu/eval/quality.py; reference
analysis/Quality_assess.py:21-170): the reference activations computed once
(and cached as .npy), then FID and PRD of generated batches through any
encoder.

The encoder returns numpy arrays or tensors; the FID is computed on the host
(scipy), the PRD in float64 on the device of the encoder's output (the CPU
for arrays), its clusterings seeded from the generator given to `score`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import prd
from .fid import activation_statistics, calculate_frechet_distance


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _device(a):
    return a.device if isinstance(a, torch.Tensor) else None


class QualityAssess:
    """Caches reference activations once, then scores generated data with
    FID and PRD (Quality_assess.py pattern)."""

    def __init__(self, encoder_fn: Callable, cache_path: Optional[str] = None):
        self.encoder_fn = encoder_fn
        self.cache_path = cache_path
        self.ref_acts: Optional[np.ndarray] = None

    def fit_reference(self, batches: Sequence):
        """Compute (or load the cached) activations of the real data."""
        if self.cache_path and os.path.exists(self.cache_path):
            self.ref_acts = np.load(self.cache_path)
            return self
        self.ref_acts = np.concatenate([_numpy(self.encoder_fn(b)) for b in batches])
        if self.cache_path:
            os.makedirs(os.path.dirname(self.cache_path) or ".", exist_ok=True)
            np.save(self.cache_path, self.ref_acts)
        return self

    def score(self, gen_batches: Sequence, num_clusters: int = 20, num_runs: int = 10,
              generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """fid, prd_f8 and prd_f1_8 of the generated batches against the
        first as many reference rows."""
        assert self.ref_acts is not None, "fit_reference first"
        outs = [self.encoder_fn(b) for b in gen_batches]
        gen_acts = np.concatenate([_numpy(o) for o in outs])
        n = min(len(gen_acts), len(self.ref_acts))
        ref, gen = self.ref_acts[:n], gen_acts[:n]
        mu1, s1 = activation_statistics(ref)
        mu2, s2 = activation_statistics(gen)
        metrics = {"fid": calculate_frechet_distance(mu1, s1, mu2, s2)}
        precision, recall = prd.compute_prd_from_embedding(
            gen, ref, num_clusters=num_clusters, num_runs=num_runs, generator=generator,
            device=_device(outs[0]))
        metrics["prd_f8"], metrics["prd_f1_8"] = prd.prd_to_max_f_beta_pair(precision, recall)
        return metrics
