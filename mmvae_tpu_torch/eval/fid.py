"""Conditional FID (mmvae_tpu/eval/fid.py, in part; reference
analysis/pytorch_fid/ and modalities/mnist_svhn.py:13-66).

The Frechet distance and the per-direction cross-modal FID over any
per-modality encoders: the port's encoders are the eval classifiers'
penultimate features (`classifiers.make_feature_fn`, the reference's
Quality_assess.py custom-encoder pattern). With `compute_prd` the same
activations also give each direction's PRD (eval/prd.py). The InceptionV3
FID network is not ported.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .generation import Noise, sample_from_conditional


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) (fid_score.py:148-200)."""
    import scipy.linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def activation_statistics(acts: np.ndarray):
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


def make_inception_fn(weights_path: Optional[str] = None):
    raise NotImplementedError(
        "the InceptionV3 FID network is not yet ported: its weights "
        "(pt_inception-2015-12-05-6726825d.pth) are not in the repository; "
        "use --fid-encoder classifier, or --skip-fid")


def cross_modal_fid(model, loader, noise_for_batch: Callable[[int], Noise],
                    encoder_fn, n_batches: Optional[int] = None, verbose: bool = False,
                    compute_prd: bool = False, prd_curve_dir: Optional[str] = None,
                    prd_generator: Optional[torch.Generator] = None):
    """Conditional FID over all ordered cross pairs: activations of the real
    test data against those of samples generated from the other modality,
    one conditional sample per datapoint, batch bi's from
    `noise_for_batch(bi)`. Keys as the reference: `fid_{target}` for two
    modalities, `fid_{src}_{target}` for more (modalities/trimodal.py:60-78).

    encoder_fn: one callable for every modality or a list of per-modality
    callables, each x -> (rows, features) numpy activations.
    n_batches=None takes the whole test loader (mnist_svhn.py:26-33).

    compute_prd adds `prd_f8_{suffix}` and `prd_f1_8_{suffix}` per
    direction, from the first min(generated, real) rows of the same
    activations (prd_score.py:139), the clusterings seeded from
    `prd_generator`, on the model's device. With `prd_curve_dir` the curve
    is saved as prd_curve_{suffix}.npz (precision, recall) and drawn as
    prd_curve_{suffix}.png with its JSON."""
    t0 = time.time()

    def _mark(msg):
        if verbose:
            print(f"  [fid +{time.time() - t0:8.3f}s] {msg}", flush=True)

    p = next(model.parameters())
    n_mod, enc = None, None
    ref_acts: List[List[np.ndarray]] = []
    gen_acts: dict = {}
    for bi, (xs, _) in enumerate(loader):
        if n_batches is not None and bi >= n_batches:
            break
        xs = [torch.as_tensor(np.asarray(x)).to(p.device, p.dtype) for x in xs]
        if n_mod is None:
            n_mod = len(xs)
            enc = (list(encoder_fn) if isinstance(encoder_fn, (list, tuple))
                   else [encoder_fn] * n_mod)
            if len(enc) != n_mod:
                raise ValueError(f"{len(enc)} encoders for {n_mod} modalities")
            ref_acts = [[] for _ in range(n_mod)]
            gen_acts = {(s, t): [] for s in range(n_mod) for t in range(n_mod) if s != t}
        for m in range(n_mod):
            ref_acts[m].append(enc[m](xs[m]))
        gen = sample_from_conditional(model, xs, noise_for_batch(bi), n=1)
        for (src, tgt), acc in gen_acts.items():
            acc.append(enc[tgt](gen[src][tgt][0]))
        _mark(f"batch {bi}: activations")

    ref_cat = [np.concatenate(r) for r in ref_acts]
    ref_stats = [activation_statistics(r) for r in ref_cat]
    fids = {}
    for (src, tgt), acc in gen_acts.items():
        gen_cat = np.concatenate(acc)
        mu1, s1 = ref_stats[tgt]
        mu2, s2 = activation_statistics(gen_cat)
        keysuf = f"{tgt}" if n_mod == 2 else f"{src}_{tgt}"
        fids[f"fid_{keysuf}"] = calculate_frechet_distance(mu1, s1, mu2, s2)
        _mark(f"frechet distance {keysuf}")
        if compute_prd:
            from . import prd

            n = min(len(gen_cat), len(ref_cat[tgt]))
            precision, recall = prd.compute_prd_from_embedding(
                gen_cat[:n], ref_cat[tgt][:n], generator=prd_generator, device=p.device)
            f8, f18 = prd.prd_to_max_f_beta_pair(precision, recall)
            fids[f"prd_f8_{keysuf}"] = f8
            fids[f"prd_f1_8_{keysuf}"] = f18
            if prd_curve_dir:
                os.makedirs(prd_curve_dir, exist_ok=True)
                base = os.path.join(prd_curve_dir, f"prd_curve_{keysuf}")
                np.savez(base + ".npz", precision=precision.cpu().numpy(),
                         recall=recall.cpu().numpy())
                prd.plot_prd_curves([(f"F8={f8:.3f} F1/8={f18:.3f}", precision, recall)],
                                    base + ".png")
            _mark(f"prd {keysuf}")
    return fids

