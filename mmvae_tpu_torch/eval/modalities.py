"""Per-dataset metrics (mmvae_tpu/eval/modalities.py; reference
models/modalities/*.py): CelebA's 40-attribute cross-coherences and its
attribute-agreement joint coherence (modalities/celeba.py:17-63).

The JAX module's `attributes_to_image` (text images of attribute vectors
for sample grids) has no caller there and is not ported; nor are the
trimodal PoE-subset metrics, whose dataset is not.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

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
