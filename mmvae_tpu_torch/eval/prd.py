"""Precision and recall for distributions (mmvae_tpu/eval/prd.py; the
reference's analysis/prd/prd_score.py, the compare_gan algorithm), with the
same defaults: 20 clusters, 1001 angles, 10 clustering runs, balanced sets.

Computed in float64 on the device of the data (or the `device` given); the
clustering is the port's k-means (eval/cluster.py) in place of
scikit-learn's MiniBatchKMeans, and every run draws its seeds from an
explicit `torch.Generator`. The curves are drawn by `vis.line_plot`, without
text: the labels go beside the PNG in its JSON.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .cluster import as_float64 as _as64, kmeans


def _angles(num_angles: int, epsilon: float, device) -> torch.Tensor:
    """np.linspace(epsilon, pi/2 - epsilon, num_angles) bit for bit: start +
    i * step, the last point exactly the stop. (The slopes tan(angle) reach
    1e10, where an ulp of the angle is 1e-6 of the slope.)"""
    stop = math.pi / 2 - epsilon
    step = (stop - epsilon) / (num_angles - 1)
    angles = torch.arange(num_angles, dtype=torch.float64, device=device) * step + epsilon
    angles[-1] = stop
    return angles


def compute_prd(eval_dist, ref_dist, num_angles: int = 1001, epsilon: float = 1e-10):
    """The PRD curve (precision, recall) of two discrete distributions over
    the same bins (prd_score.py:48-106), float64 tensors of num_angles."""
    assert 0 < epsilon <= 0.1
    assert 3 <= num_angles <= 1e6
    eval_dist = _as64(eval_dist)
    ref_dist = _as64(ref_dist, eval_dist.device)
    slopes = torch.tan(_angles(num_angles, epsilon, eval_dist.device))
    precision = torch.minimum(ref_dist[None, :] * slopes[:, None], eval_dist[None, :]).sum(1)
    recall = precision / slopes
    if max(float(precision.max()), float(recall.max())) > 1.001:
        raise ValueError("Detected value > 1.001, this should not happen.")
    return torch.clamp(precision, 0, 1), torch.clamp(recall, 0, 1)


def _histogram_bins(labels: torch.Tensor, n_eval: int, num_clusters: int):
    """Each side's share of rows per cluster: np.histogram(labels, bins=k,
    range=[0, k], density=True) of the first `n_eval` labels and of the rest."""
    out = []
    for part in (labels[:n_eval], labels[n_eval:]):
        counts = torch.bincount(part, minlength=num_clusters).to(torch.float64)
        out.append(counts / counts.sum())
    return out[0], out[1]


def _cluster_into_bins(eval_data, ref_data, num_clusters: int,
                       generator: Optional[torch.Generator] = None):
    """Cluster the union with k-means (10 restarts), histogram each side
    (prd_score.py:109-139)."""
    eval_data = _as64(eval_data)
    data = torch.cat([eval_data, _as64(ref_data, eval_data.device)])
    labels = kmeans(data, num_clusters, n_init=10, generator=generator).labels
    return _histogram_bins(labels, len(eval_data), num_clusters)


def compute_prd_from_embedding(eval_data, ref_data, num_clusters: int = 20,
                               num_angles: int = 1001, num_runs: int = 10,
                               enforce_balance: bool = True,
                               generator: Optional[torch.Generator] = None,
                               device=None):
    """The PRD curve of two sets of embeddings, averaged over `num_runs`
    clusterings (prd_score.py:139-175), each seeded from `generator` (seeded
    0 on the data's device when None). Returns float64 tensors (precision,
    recall) on `device` (default: the data's)."""
    eval_data = _as64(eval_data, device)
    ref_data = _as64(ref_data, eval_data.device)
    if enforce_balance and len(eval_data) != len(ref_data):
        raise ValueError(
            "The number of points in eval_data %d is not equal to the number "
            "of points in ref_data %d." % (len(eval_data), len(ref_data)))
    if generator is None:
        generator = torch.Generator(device=eval_data.device).manual_seed(0)
    precisions, recalls = [], []
    for _ in range(num_runs):
        eval_dist, ref_dist = _cluster_into_bins(eval_data, ref_data, num_clusters, generator)
        p, r = compute_prd(eval_dist, ref_dist, num_angles)
        precisions.append(p)
        recalls.append(r)
    return torch.stack(precisions).mean(0), torch.stack(recalls).mean(0)


def _prd_to_f_beta(precision, recall, beta: float = 1, epsilon: float = 1e-10):
    return (1 + beta ** 2) * (precision * recall) / ((beta ** 2 * precision) + recall + epsilon)


def prd_to_max_f_beta_pair(precision, recall, beta: float = 8):
    """(max F_beta, max F_{1/beta}) summary pair, as floats (prd_score.py:230-264)."""
    precision = _as64(precision)
    recall = _as64(recall, precision.device)
    f_beta = float(torch.max(_prd_to_f_beta(precision, recall, beta)))
    f_beta_inv = float(torch.max(_prd_to_f_beta(precision, recall, 1.0 / beta)))
    return f_beta, f_beta_inv


def plot_prd_curves(curves, out_path: str):
    """PRD curves (prd_score.py:177-228 `plot`): recall on x, precision on y,
    on [0, 1] x [0, 1]. `curves` is a dict label -> (precision, recall) or a
    list of (label, precision, recall). Writes `out_path` (PNG) and the
    figure's JSON beside it (`vis.line_plot`); returns that JSON."""
    from ..vis import line_plot

    if isinstance(curves, dict):
        curves = [(lab, p, r) for lab, (p, r) in curves.items()]
    series = [{"label": label, "x": _as64(r).cpu().numpy(), "y": _as64(p).cpu().numpy()}
              for label, p, r in curves]
    return line_plot(series, out_path, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
                     xlabel="Recall", ylabel="Precision")
