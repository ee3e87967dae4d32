"""Per-dataset metrics (mmvae_tpu/eval/modalities.py; reference
models/modalities/*.py): CelebA's 40-attribute cross-coherences and its
attribute-agreement joint coherence (modalities/celeba.py:17-63), and the
trimodal PoE-subset conditional accuracies (modalities/trimodal.py:115-154).

The JAX module's `attributes_to_image` (text images of attribute vectors
for sample grids) has no caller there and is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..core import distributions as D
from ..core.distributions import LocScale
from .generation import Noise, generate, sample_from_conditional


def celeba_attribute_metrics(model, classifiers: Sequence[Callable], data, classes_attrs,
                             noise: Noise, spec, n_data: int = 100, ns: int = 30) -> Dict:
    """Bitwise attribute accuracy of the cross-modal generations against
    the true attributes, and joint coherence as the agreement of the two
    classifiers on prior samples (celeba.py:43-63). Each classifier gives
    40 logits, read as attributes where above 0 (as JAX reads them, though
    its pool trains them with a softmax over 40 classes on attribute 20).
    accuracy2: the attributes generated from the images; accuracy1: the
    images generated from the attributes. Noise: the conditional samples,
    then the ns * n_data prior samples."""
    n_data = min(n_data, len(data[0]))
    bdata = [d[:n_data] for d in data]
    samples = sample_from_conditional(model, bdata, noise, n=ns)
    true = torch.as_tensor(classes_attrs[:n_data], device=bdata[0].device)
    metrics = {}
    for i, j, name in ((0, 1, "accuracy2"), (1, 0, "accuracy1")):
        recon = samples[i][j]  # (ns, n_data, *event_j)
        preds = classifiers[j](recon.reshape(ns * n_data, *recon.shape[2:])) > 0
        preds = preds.reshape(ns, n_data, -1).transpose(0, 1)
        metrics[name] = float((preds.to(true.dtype) == true[:, None, :]).double().mean())
    gen = generate(model, noise, spec, N=ns * n_data)
    agree = (classifiers[0](gen[0]) > 0) == (classifiers[1](gen[1]) > 0)
    metrics["joint_coherence"] = float(agree.double().mean())
    return metrics


def celeba_batch_coherence(model, classifiers, data, labels, noise: Noise, spec,
                           n_data: int = 100, ns: int = 30) -> Dict:
    """`celeba_attribute_metrics` with `compute_accuracies`' arguments: the
    true attributes are the attribute modality itself, the labels unused."""
    return celeba_attribute_metrics(model, classifiers, data, data[1].reshape(len(data[1]), -1),
                                    noise, spec, n_data=n_data, ns=ns)


# datasets whose coherences come batch by batch only, from a function of
# `compute_accuracies`' arguments that stands in for it (`validate` takes
# its per-batch loop for them, even at --n-data all)
BATCH_COHERENCE = {"celeba": celeba_batch_coherence}


def poe_subset_accuracy(model, classifiers: Sequence[Callable], data, classes,
                        generator: Optional[torch.Generator] = None, n_data: int = 100,
                        ns: int = 100, mcmc_steps: int = 100,
                        draws: Optional[Sequence[dict]] = None) -> Dict:
    """For each 2-subset of the three modalities, ns latents per datapoint
    from the product of its experts, decoded into the held-out modality and
    classified against the true class: cond_acc_{m} (trimodal.py:115-154).
    MVAE samples its PoE with the prior analytically (`poe_subset_params`);
    a flow model runs Hamiltonian Monte Carlo over the product of its flow
    posteriors (`hmc.sample_from_poe_subset`, `mcmc_steps` steps), and
    hmc_acc_rate_{m} is its mean acceptance. Subset m's draws come from
    `generator`, or from draws[m]: MVAE's {"eps": (ns, n_data, D)}, HMC's
    keyword arguments {"z0", "rho", "u"}."""
    from ..models.mvae import MVAE
    from .hmc import sample_from_poe_subset

    n_data = min(n_data, len(data[0]))
    bdata = [d[:n_data] for d in data]
    true = torch.as_tensor(classes[0][:n_data], device=bdata[0].device).repeat(ns)
    metrics = {}
    for gen_mod, subset in enumerate(([1, 2], [0, 2], [0, 1])):
        kw = dict(draws[gen_mod]) if draws is not None else {}
        if isinstance(model, MVAE):
            mu, std = model.poe_subset_params(subset, bdata)
            zs = D.normal_sample(LocScale(mu, std), (ns,), eps=kw.get("eps"), generator=generator)
        else:
            zs, acc_rate = sample_from_poe_subset(model, subset, bdata, mcmc_steps=mcmc_steps,
                                                  K=ns, return_acceptance=True,
                                                  generator=generator, **kw)
            metrics[f"hmc_acc_rate_{gen_mod}"] = float(acc_rate)
        recon = model.decode_all(zs.reshape(ns * n_data, -1))[gen_mod]
        preds = torch.argmax(classifiers[gen_mod](recon), dim=1)
        metrics[f"cond_acc_{gen_mod}"] = float((preds == true).double().mean())
    return metrics
