"""Latent-space analysis (mmvae_tpu/eval/latent_analysis.py; reference
multi_vaes.py:128-181 and jmvae_nf_circles.py:82-214): joint and unimodal
posterior samples, and circles-squares' radius analytics: the correlation of
true radii with radii read off cross-modal samples, the negative entropy of
the conditional radius distribution, and the product-of-posteriors figure
from Hamiltonian Monte Carlo.

`classify_latent` is the hinge-loss SGD probe (eval/linear.py, scikit-learn's
SGDClassifier in distribution) and `analyse` the latent scatter of the
joint and first unimodal posteriors through the in-repo UMAP; no CLI calls
them, in neither package.

Samplers take a `Noise` (eval/generation.py) or, for HMC, a generator.
Callers run these under `torch.no_grad()`; HMC turns gradients on for its
own density.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..vis import (
    extract_rayon, plot_embeddings_colorbars, plot_hist, reduce_latents, scatter_panels,
)
from .generation import Noise, sample_from_conditional


def classify_latent(z_train, t_train, z_test, t_test, generator: Optional[torch.Generator] = None,
                    device="cpu") -> float:
    """The hinge-loss SGD probe's accuracy (multi_vaes.py:160-164): fit on
    (z_train, t_train), scored on (z_test, t_test), on `device`, its
    shuffles from `generator` (default seed 0). The probe steps once per
    sample, a few small operations each, so it runs on the host: on the
    card every step is a handful of launches (PERF.md §5)."""
    from .linear import SGDClassifier

    z = [np.asarray(torch.as_tensor(a).detach().cpu()) for a in (z_train, z_test)]
    clf = SGDClassifier(generator=generator, device=device).fit(z[0], np.asarray(t_train))
    return clf.score(z[1], np.asarray(t_test))


def analyse_joint_posterior(model, data, noise=None, generator=None, n_samples: int = 10):
    """Joint posterior statistics and samples of the first `n_samples` rows
    (jmvae_nf.py:181-186, mmvae.py:88-96) -> (mu, std, z): JMVAE-NF's joint
    encoder (mu, std, z_xy); MMVAE's mean of the experts' means and the mean
    of their samples (None for std); a PoE model's joint sample alone.
    `noise`: what the model's forward takes."""
    bdata = [d[:n_samples] for d in data]
    if hasattr(model, "joint_encoder"):
        out = model(bdata, noise=noise, generator=generator)
        mu, std = out["qz_xy"]
        return mu, std, out["z_xy"].reshape(-1, out["z_xy"].shape[-1])
    out = model(bdata, K=1, noise=noise, generator=generator)
    if "zss" in out:
        zss = out["zss"]
        z = 0.5 * (zss[0] + zss[1])
        mus = [mu for mu, _ in out["qz_params"]]
        return sum(mus) / len(mus), None, z.reshape(-1, z.shape[-1])
    return None, None, out["z_joint"]


def analyse_uni_posterior(model, data, noise: Noise, n_samples: int):
    """A unimodal posterior sample of each of the first `n_samples` rows,
    per modality (multi_vaes.py:167-170); modality m's noise is drawn
    before modality m + 1's."""
    out = []
    for m, x in enumerate(data):
        x = x[:n_samples]
        eps = noise.draw(model.vaes[m].posterior, (x.shape[0], model.vaes[m].latent_dim))
        out.append(model.infer_latent_from_mod(m, x, noise=eps))
    return out


def analyse(model, data, classes, noise: Noise, run_path: str, epoch: int,
            train_latents=None, generator: Optional[torch.Generator] = None) -> Dict:
    """The latent scatter of every row of `data` (multi_vaes.py:133-158):
    joint_embedding_{epoch:03d}.png (and its .json) in `run_path`, the
    joint posterior's samples beside modality 0's unimodal ones, each
    reduced to 2-D by the in-repo UMAP on the model's device and colored by
    classes[0] and classes[1]. With `train_latents` (z, labels), also
    `latent_acc`, the SGD probe fitted on them and scored on the joint
    samples against classes[0]. The joint forward draws from `noise`'s
    first generator, the unimodal samples from `noise`; `generator` seeds
    the probe's shuffles."""
    device = next(model.parameters()).device
    n = len(data[0])
    _, _, zxy = analyse_joint_posterior(model, data, generator=noise.generators[0], n_samples=n)
    zx = analyse_uni_posterior(model, data, noise, n)
    metrics = {}
    if train_latents is not None:
        metrics["latent_acc"] = classify_latent(train_latents[0], train_latents[1], zxy,
                                                classes[0], generator=generator)
    zxy, zx0 = (z.detach().cpu().numpy() for z in (zxy, zx[0]))
    plot_embeddings_colorbars(reduce_latents(zxy, device=device), reduce_latents(zx0, device=device),
                              classes[0], classes[1],
                              os.path.join(run_path, f"joint_embedding_{epoch:03d}.png"))
    return metrics


def negative_entropy(rayons, rng, bins) -> float:
    """The mean over datapoints of sum p log p of each row's radius
    histogram (`bins` bins over `rng`, +1e-5 per bin, over the row's
    length) (utils.py:301-312). rayons: (n_data, n_samples)."""
    rayons = np.asarray(rayons)
    entropy = 0.0
    for row in rayons:
        p = np.histogram(row, range=rng, bins=bins, density=False)[0] + 1e-5
        p = p / len(row)
        entropy += np.sum(np.log(p) * p)
    return float(entropy / len(rayons))


def conditional_rdist_metrics(model, data, noise: Noise, run_path: Optional[str] = None,
                              epoch: int = 0, n: int = 100, n_data: int = 100) -> Dict:
    """circles-squares' conditional radius distribution
    (jmvae_nf_circles.py:94-129): the radii of n cross-modal samples of each
    of the first n_data rows in both directions, their `neg_entropy` over
    (0, 1) in 10 bins, and with `run_path` their histogram
    hist_{epoch:03d}.png."""
    samples = sample_from_conditional(model, [d[:n_data] for d in data], noise, n=n)
    r = np.concatenate([extract_rayon(samples[0][1].cpu().numpy()).T,
                        extract_rayon(samples[1][0].cpu().numpy()).T], axis=0)
    if run_path is not None:
        plot_hist(r.ravel(), os.path.join(run_path, f"hist_{epoch:03d}.png"))
    return {"neg_entropy": negative_entropy(r, (0, 1), 10)}


def rayon_metrics(model, data, r_squares, r_circles, noise: Noise):
    """One cross reconstruction of each row in both directions and the
    correlation of the radius read off it with the true radius of the
    other modality: ({"rayon_corr_01", "rayon_corr_10"}, each absent where
    either side is constant; {"01": radii, "10": radii})."""
    samples = sample_from_conditional(model, data, noise, n=1)
    metrics, radii = {}, {}
    for i, j, r_true in [(0, 1, r_circles), (1, 0, r_squares)]:
        r_est = extract_rayon(samples[i][j][0].cpu().numpy())
        r_true = np.asarray(r_true)[: len(r_est)]
        if np.std(r_est) > 0 and np.std(r_true) > 0:
            metrics[f"rayon_corr_{i}{j}"] = float(np.corrcoef(r_true, r_est)[0, 1])
        radii[f"{i}{j}"] = r_est
    return metrics, radii


def write_rayon_hists(radii, run_path: str, epoch: int) -> None:
    """hist_rayon_{ij}_{epoch:03d}.png of each direction's radii."""
    for ij, r in radii.items():
        plot_hist(r, os.path.join(run_path, f"hist_rayon_{ij}_{epoch:03d}.png"))


def analyse_rayons(model, data, r_squares, r_circles, noise: Noise, run_path: str,
                   epoch: int) -> Dict:
    """circles-squares' radius analytics (jmvae_nf_circles.py:82-132):
    `rayon_metrics` and their histograms."""
    metrics, radii = rayon_metrics(model, data, r_squares, r_circles, noise)
    write_rayon_hists(radii, run_path, epoch)
    return metrics


def visualize_poe(model, data, run_path: str, generator: torch.Generator, n_data: int = 4,
                  N: int = 30, divide_prior: bool = False, mcmc_steps: int = 100) -> str:
    """product_of_posteriors.png (jmvae_nf_circles.py:138-214): for each of
    the first n_data rows, N samples of each unimodal posterior beside N of
    the joint posterior (top row) and beside N HMC samples of the product
    of the unimodal posteriors (bottom row; 10 leapfrogs of 0.01). Draws
    from `generator`: the unimodal samples, the joint one, then HMC."""
    from .hmc import sample_from_poe_subset

    bdata = [torch.cat([d[:n_data]] * N) for d in data]
    noise = Noise([generator], dtype=bdata[0].dtype)
    u_z = [z.reshape(N, n_data, -1).cpu().numpy()
           for z in analyse_uni_posterior(model, bdata, noise, len(bdata[0]))]
    eps = noise.draw(model.posterior, (len(bdata[0]), u_z[0].shape[-1]))
    j_z = model(bdata, noise=eps)["z_xy"].reshape(N, n_data, -1).cpu().numpy()
    poe_z = sample_from_poe_subset(
        model, list(range(len(data))), [d[:n_data] for d in bdata], mcmc_steps=mcmc_steps,
        n_lf=10, eps_lf=0.01, K=N, divide_prior=divide_prior,
        generator=generator).cpu().numpy()  # (N, n_data, D)
    rows = []
    for other, label in [(j_z, "q(z|x,y)"), (poe_z, "PoE")]:
        rows.append([[{"label": "q(z|x)", "points": u_z[0][:, i, :2]},
                      {"label": "q(z|y)", "points": u_z[1][:, i, :2]},
                      {"label": label, "points": other[:, i, :2]}] for i in range(n_data)])
    path = os.path.join(run_path, "product_of_posteriors.png")
    scatter_panels(rows, path)
    return path
