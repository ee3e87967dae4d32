"""Classifier-based coherence metrics (mmvae_tpu/eval/coherence.py;
reference analysis/accuracies.py:12-68).

Cross-coherence: ns cross-modal generations per datapoint, classified by
the pretrained nets and compared with the true class. Joint coherence: all
modality classifiers agree on prior samples. Each function takes its noise
from a `generation.Noise`, the full-test-set one from one Noise per test
batch; callers run them under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .generation import Noise, generate, sample_from_conditional


def _labels(classifier, x):
    return torch.argmax(classifier(x), dim=1)


def conditional_labels(model, classifiers: Sequence[Callable], data, noise: Noise,
                       n_data: int = 8, ns: int = 30):
    """labels[i][j]: predicted class of modality-j generations conditioned on
    modality i, shape (n_data, ns) (accuracies.py:12-29)."""
    n_mod = len(data)
    samples = sample_from_conditional(model, [d[:n_data] for d in data], noise, n=ns)
    labels = [[None] * n_mod for _ in range(n_mod)]
    for i in range(n_mod):
        for j in range(n_mod):
            if i != j:
                recon = samples[i][j]  # (ns, n_data, *event_j)
                labels[i][j] = _labels(classifiers[j], recon.reshape(-1, *recon.shape[2:])
                                       ).reshape(ns, -1).T
    return labels


def _batch_sums(model, classifiers, bdata, true, w, noise: Noise, spec, ns: int):
    """One batch's weighted correct counts per ordered pair (acc_i_j), the
    count of prior samples all classifiers agree on (joint_s) and of prior
    samples (joint_n), as device tensors."""
    n_mod = len(bdata)
    samples = sample_from_conditional(model, bdata, noise, n=ns)
    out = {}
    for i in range(n_mod):
        for j in range(n_mod):
            if i != j:
                recon = samples[i][j]  # (ns, B, *event_j)
                pred = _labels(classifiers[j], recon.reshape(-1, *recon.shape[2:]))
                correct = (pred.reshape(ns, -1) == true[None, :]).to(w.dtype).mean(0)  # (B,)
                out[f"acc_{i}_{j}"] = torch.sum(w * correct)
    gen = generate(model, noise, spec, N=ns * true.shape[0])
    preds = [_labels(classifiers[m], gen[m]) for m in range(n_mod)]
    agree = torch.stack([preds[i] == preds[j] for i in range(n_mod) for j in range(n_mod)])
    out["joint_s"] = torch.sum(torch.all(agree, dim=0))
    out["joint_n"] = agree.shape[1]
    return out


def compute_accuracies(model, classifiers, data, classes, noise: Noise, spec,
                       n_data=20, ns: int = 100, sampler=None) -> Dict[str, float]:
    """Cross-coherence matrix acc_i_j and joint coherence over the first
    n_data rows of one batch (accuracies.py:31-62). Noise: each modality's
    conditional samples, then the ns*n_data prior samples, or with a fitted
    `sampler` its ns*n_data latents (the joint coherence of its samples)."""
    if n_data == "all" or n_data > len(data[0]):
        n_data = len(data[0])
    bdata = [d[:n_data] for d in data]
    true = torch.as_tensor(np.asarray(classes[0][:n_data]), device=bdata[0].device)
    if sampler is not None:
        labels = conditional_labels(model, classifiers, bdata, noise, n_data, ns)
        out = {f"acc_{i}_{j}": float((labels[i][j] == true[:, None]).double().mean())
               for i in range(len(bdata)) for j in range(len(bdata)) if i != j}
        gen = generate(model, noise, spec, N=ns * n_data, sampler=sampler)
        out["joint_coherence"] = compute_joint_accuracy(classifiers, gen)
        return out
    w = torch.ones(n_data, dtype=bdata[0].dtype, device=bdata[0].device)
    sums = _batch_sums(model, classifiers, bdata, true, w, noise, spec, ns)
    out = {k: float(v) / n_data for k, v in sums.items() if k.startswith("acc_")}
    out["joint_coherence"] = float(sums["joint_s"]) / sums["joint_n"]
    return out


def _staged_dataset(ds, batch: int, device, dtype=torch.float32):
    """Every modality padded and reshaped to (nb, batch, *event) on the
    device, with the true classes and row weights (nb, batch). The ragged
    tail batch is padded with copies of its first row at weight 0, so every
    batch has one shape and every test pair counts exactly once
    (validate.py:111-116 protocol)."""
    n = len(ds)
    nb = -(-n // batch)
    pad = nb * batch - n

    def padded(a):
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.repeat(a[(nb - 1) * batch:][:1], pad, axis=0)])
        return a.reshape((nb, batch) + a.shape[1:])

    stacks = [torch.as_tensor(padded(np.asarray(m, dtype=np.float32))).to(device, dtype)
              for m in ds.modalities]
    true = torch.as_tensor(padded(ds.labels[0])).to(device)
    w = torch.ones(nb * batch, dtype=dtype)
    w[n:] = 0.0
    return stacks, true, w.reshape(nb, batch).to(device), nb


def compute_accuracies_dataset(model, classifiers, loader, noise_for_batch: Callable[[int], Noise],
                               spec, ns: int = 1) -> Dict[str, float]:
    """Full-test-set coherence: the test set staged on the device once
    (`_staged_dataset`), every batch through the same computation with the
    Noise `noise_for_batch(bi)`, the sums kept on the device and read once."""
    ds = loader.dataset
    n = len(ds)
    batch = min(loader.batch_size, n)
    p = next(model.parameters())
    stacks, true_all, w_all, nb = _staged_dataset(ds, batch, p.device, p.dtype)
    acc: Dict[str, torch.Tensor] = {}
    for bi in range(nb):
        sums = _batch_sums(model, classifiers, [s[bi] for s in stacks], true_all[bi], w_all[bi],
                           noise_for_batch(bi), spec, ns)
        for k, v in sums.items():
            acc[k] = v if k not in acc else acc[k] + v
    w_sum = float(w_all.sum())
    out = {k: float(v) / w_sum for k, v in acc.items() if k.startswith("acc_")}
    out["joint_coherence"] = float(acc["joint_s"]) / float(acc["joint_n"])
    return out


def compute_joint_accuracy(classifiers, data) -> float:
    """Share of samples on which every pair of modality classifiers agrees
    (accuracies.py:64-68)."""
    labels = [_labels(classifiers[i], data[i]) for i in range(len(data))]
    n_mod = len(data)
    pairs = torch.stack([labels[i] == labels[j] for i in range(n_mod) for j in range(n_mod)])
    return float(torch.sum(torch.all(pairs, dim=0))) / data[0].shape[0]


def attribute_accuracies(classifiers, recon_attrs, true_attrs) -> float:
    """CelebA's 40-attribute accuracy (modalities/celeba.py:43-53)."""
    raise NotImplementedError("CelebA attribute accuracies not yet ported: the CelebA dataset "
                              "is not ported")
