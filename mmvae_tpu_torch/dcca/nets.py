"""DCCA encoder pairs and the linear-CCA-wrapped inference encoders
(mmvae_tpu/dcca/nets.py; reference dcca/models/*.py).

A trunk pair is trained with the CCA loss (dcca/train.py), then wrapped
with the fitted linear-CCA projection h -> ((h - m) @ w)[:, :dim] for use
inside TwoStepsEncoder (dcca/models/mnist_svhn.py:50-104). Every pair but
MNIST-SVHN-Fashion's is ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..nets import EncoderSVHN, MLPEncoder
from ..nets.resnets import celeba_encoder, medmnist_encoder


class LCCAWrappedEncoder(nn.Module):
    """Frozen DCCA trunk + the fitted linear-CCA projection. Emits one
    embedding. `m` (outdim,) and `w` (outdim, outdim) are registered
    buffers: never trained (the reference keeps them as buffers loaded from
    .npy), but moved and cast with the module and kept in its state dict."""

    def __init__(self, encoder: nn.Module, m, w, latent_dim: int):
        super().__init__()
        self.encoder = encoder
        self.latent_dim = latent_dim
        self.register_buffer("m", torch.as_tensor(np.asarray(m), dtype=torch.float32))
        self.register_buffer("w", torch.as_tensor(np.asarray(w), dtype=torch.float32))

    def forward(self, x):
        out = self.encoder(x)
        h = out[0] if isinstance(out, tuple) else out
        return ((h - self.m[None, :]) @ self.w)[:, : self.latent_dim]


def identity_lcca(outdim: int):
    """Untrained stand-in projection (used when no DCCA artifacts exist yet)."""
    return np.zeros(outdim, np.float32), np.eye(outdim, dtype=np.float32)


class DeepCCA(nn.Module):
    """Encoders producing correlated embeddings (dcca/models/mnist_svhn.py:
    13-35): each one's first output."""

    def __init__(self, encoders: Sequence[nn.Module]):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)

    def forward(self, xs):
        outs = []
        for enc, x in zip(self.encoders, xs):
            o = enc(x)
            outs.append(o[0] if isinstance(o, tuple) else o)
        return outs


def dcca_encoders_mnist_svhn(outdim: int = 16):
    """DeepCCA_MNIST_SVHN trunk pair (dcca/models/mnist_svhn.py:13-18): MLP
    for MNIST, conv for SVHN."""
    return [MLPEncoder(latent_dim=outdim, in_features=1 * 28 * 28),
            EncoderSVHN(latent_dim=outdim)]


def dcca_encoders_circles(outdim: int = 16):
    """The circles-squares trunk pair (dcca/models/circles.py): two
    one-channel SVHN conv encoders for 1x32x32."""
    return [EncoderSVHN(latent_dim=outdim, n_channels=1),
            EncoderSVHN(latent_dim=outdim, n_channels=1)]


def dcca_encoders_mnist_contour(outdim: int = 15):
    """DeepCCA_MNIST_CONTOUR (dcca/models/mnist_contour.py:12-15): two MLPs."""
    return [MLPEncoder(latent_dim=outdim, in_features=1 * 28 * 28),
            MLPEncoder(latent_dim=outdim, in_features=1 * 28 * 28)]


def dcca_encoders_celeba(outdim: int = 40):
    """DeepCCA_celeba (dcca/models/celeba.py:15-21): the CelebA ResNet
    encoder for the image, an MLP for the 1x1x40 attribute tensor."""
    return [celeba_encoder(outdim), MLPEncoder(latent_dim=outdim, in_features=40)]


def dcca_encoders_medmnist(outdim: int = 16):
    """DeepCCA_MedMNIST (dcca/models/medmnist.py:16-21): MedMNIST ResNet
    encoders for the 1x28x28 pneumonia and the 3x28x28 blood images."""
    return [medmnist_encoder(outdim, 1), medmnist_encoder(outdim, 3)]


def dcca_encoders_chest_svhn(outdim: int = 16):
    """DeepCCA chest-SVHN (dcca/models/chest_svhn.py:16-21): the MedMNIST
    ResNet for the chest X-ray, the SVHN conv encoder for the digit."""
    return [medmnist_encoder(outdim, 1), EncoderSVHN(latent_dim=outdim)]


def _later(dataset: str):
    def build(outdim: int):
        raise NotImplementedError(f"DCCA trunks for {dataset!r} not yet ported")
    return build


# dataset key -> (builder, default trunk outdim), the JAX package's table
DCCA_BUILDERS = {
    "mnist_svhn": (dcca_encoders_mnist_svhn, 16),
    "circles_squares": (dcca_encoders_circles, 16),
    "celeba": (dcca_encoders_celeba, 40),
    "medmnist": (dcca_encoders_medmnist, 16),
    "chest_svhn": (dcca_encoders_chest_svhn, 16),
    "mnist_contour": (dcca_encoders_mnist_contour, 15),
    "mnist_svhn_fashion": (_later("mnist_svhn_fashion"), 16),
}
