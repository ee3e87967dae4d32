"""Evaluation classifiers (mmvae_tpu/eval/classifiers.py; reference
analysis/classifiers/*): the MNIST classifier (also used for Fashion and
MedMNIST's pneumonia) and the SVHN classifier (also MedMNIST's blood, at
3x28x28), valid-padding 4x4 convs with BatchNorm and dropout MLP heads,
the circles-squares classifier (an MLP), CelebA's image and attribute
classifiers (40 logits each), their training loop and the classifier
pool's files.

Submodule names follow the JAX tree (`Conv2d_0`, `BatchNorm2d_0`,
`BatchNorm_0`, `Linear_0`, ...), so that bridge.py maps a JAX classifier's
params and batch_stats one to one. Pool files are torch state dicts,
`<key><variant>.pt`.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..cli.common import torch_device
from ..nets.conv import BatchNorm, BatchNorm2d, Conv2d, Dropout, Linear, init_parameters
from ..train.optim import Adam


def _conv_out(size: int, n_convs: int) -> int:
    return size - 3 * n_convs  # 4x4 kernels, stride 1, no padding


class MnistClassifier(nn.Module):
    """2 conv(BN, ReLU) + dropout MLP head (classifier_mnist.py:19-48)."""

    def __init__(self, num_classes: int = 10, in_shape: Sequence[int] = (1, 28, 28)):
        super().__init__()
        c, h, w = in_shape
        self.Conv2d_0, self.BatchNorm2d_0 = Conv2d(c, 32, 4, 1), BatchNorm2d(32)
        self.Conv2d_1, self.BatchNorm2d_1 = Conv2d(32, 64, 4, 1), BatchNorm2d(64)
        self.Linear_0 = Linear(64 * _conv_out(h, 2) * _conv_out(w, 2), 512)  # 30976 at 28x28
        self.Dropout_0 = Dropout(0.5)
        self.Linear_1 = Linear(512, num_classes)

    def forward(self, x, features: bool = False, generator=None):
        """Logits, or with `features` the 512-wide penultimate embedding
        (the custom-encoder FID pattern, Quality_assess.py:21-170).
        `generator` draws the dropout masks in training."""
        h = torch.relu(self.BatchNorm2d_0(self.Conv2d_0(x)))
        h = torch.relu(self.BatchNorm2d_1(self.Conv2d_1(h)))
        h = self.Linear_0(h.reshape(h.shape[0], -1))
        if features:
            return h
        return self.Linear_1(self.Dropout_0(h, generator))


class SVHNClassifier(nn.Module):
    """3 conv(BN, ReLU) + BN/dropout MLP head (classifier_SVHN.py:21-58);
    69 M parameters, 67,712 x 1,024 of them in Linear_0."""

    def __init__(self, num_classes: int = 10, in_shape: Sequence[int] = (3, 32, 32)):
        super().__init__()
        c, h, w = in_shape
        self.Conv2d_0, self.BatchNorm2d_0 = Conv2d(c, 32, 4, 1), BatchNorm2d(32)
        self.Conv2d_1, self.BatchNorm2d_1 = Conv2d(32, 64, 4, 1), BatchNorm2d(64)
        self.Conv2d_2, self.BatchNorm2d_2 = Conv2d(64, 128, 4, 1), BatchNorm2d(128)
        self.Linear_0 = Linear(128 * _conv_out(h, 3) * _conv_out(w, 3), 1024)  # 67712 at 32x32
        self.BatchNorm_0, self.Dropout_0 = BatchNorm(1024), Dropout(0.5)
        self.Linear_1, self.BatchNorm_1 = Linear(1024, 512), BatchNorm(512)
        self.Dropout_1 = Dropout(0.5)
        self.Linear_2 = Linear(512, num_classes)

    def forward(self, x, features: bool = False, generator=None):
        h = torch.relu(self.BatchNorm2d_0(self.Conv2d_0(x)))
        h = torch.relu(self.BatchNorm2d_1(self.Conv2d_1(h)))
        h = torch.relu(self.BatchNorm2d_2(self.Conv2d_2(h)))
        h = self.BatchNorm_0(self.Linear_0(h.reshape(h.shape[0], -1)))
        h = self.BatchNorm_1(self.Linear_1(self.Dropout_0(h, generator)))
        if features:
            return h
        return self.Linear_2(self.Dropout_1(h, generator))


class CirclesClassifier(nn.Module):
    """Flatten -> Linear 512, ReLU -> a 10-way head
    (classifier_empty_full.py:65-89): trained on full (1) / empty (0), with
    the reference's 10-way head."""

    def __init__(self, num_classes: int = 10, in_shape: Sequence[int] = (1, 32, 32)):
        super().__init__()
        self.Linear_0 = Linear(int(np.prod(in_shape)), 512)
        self.Linear_1 = Linear(512, num_classes)

    def forward(self, x, features: bool = False, generator=None):
        h = torch.relu(self.Linear_0(x.reshape(x.shape[0], -1)))
        if features:
            return h
        return self.Linear_1(h)


class CelebAImgClassifier(nn.Module):
    """Three strided 4x4 convs (BatchNorm, ReLU), a spatial mean, then 40
    logits: the JAX package's stand-in for the reference's finetuned ResNet
    (CelebA_classifier.py:16-47)."""

    def __init__(self, num_attrs: int = 40, in_shape: Sequence[int] = (3, 64, 64)):
        super().__init__()
        c = in_shape[0]
        self.Conv2d_0, self.BatchNorm2d_0 = Conv2d(c, 32, 4, 2, padding=1), BatchNorm2d(32)
        self.Conv2d_1, self.BatchNorm2d_1 = Conv2d(32, 64, 4, 2, padding=1), BatchNorm2d(64)
        self.Conv2d_2, self.BatchNorm2d_2 = Conv2d(64, 128, 4, 2, padding=1), BatchNorm2d(128)
        self.Linear_0 = Linear(128, num_attrs)

    def forward(self, x, features: bool = False, generator=None):
        h = torch.relu(self.BatchNorm2d_0(self.Conv2d_0(x)))
        h = torch.relu(self.BatchNorm2d_1(self.Conv2d_1(h)))
        h = torch.relu(self.BatchNorm2d_2(self.Conv2d_2(h)))
        h = h.mean(dim=(2, 3))
        if features:
            return h
        return self.Linear_0(h)


class AttributesClassifier(nn.Module):
    """CelebA's attribute-vector classifier: flatten, Linear 512, ReLU, then
    `num_attrs` logits (CelebA_classifier.py's attribute MLP)."""

    def __init__(self, num_attrs: int = 40, in_shape: Sequence[int] = (1, 1, 40)):
        super().__init__()
        self.Linear_0 = Linear(int(np.prod(in_shape)), 512)
        self.Linear_1 = Linear(512, num_attrs)

    def forward(self, x, features: bool = False, generator=None):
        h = torch.relu(self.Linear_0(x.reshape(x.shape[0], -1)))
        if features:
            return h
        return self.Linear_1(h)


# the pool's key of each modality's classifier; the medmnist classifiers are
# the MNIST and SVHN architectures, blood's at its 3x28x28
ARCHS = {
    "mnist": MnistClassifier,
    "fashion": MnistClassifier,
    "svhn": SVHNClassifier,
    "empty_full": CirclesClassifier,
    "pneumonia": MnistClassifier,
    "blood": SVHNClassifier,
    "celeba_img": CelebAImgClassifier,
    "celeba_attr": AttributesClassifier,
}


def train_classifier(model: nn.Module, images: np.ndarray, labels: np.ndarray, seed: int,
                     epochs: int = 3, batch_size: int = 256, lr: float = 1e-3,
                     device="cuda") -> nn.Module:
    """Fit `model` (JAX train_classifier) on `device` (`cli.common.torch_device`:
    CUDA raises where there is none): parameters drawn from `seed`, the
    data shuffled once with default_rng(0) and put on the device, each
    epoch's batches at offsets strided by half a batch per epoch, softmax
    cross-entropy, Adam (optax.adam) at `lr`; the dropout masks from a
    generator seeded with `seed`. Returns the model in eval mode."""
    device = torch_device(device)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device).train()
    params = list(model.parameters())
    dtype = params[0].dtype
    opt = Adam(params, amsgrad=False)
    gen = torch.Generator(device=device).manual_seed(seed)

    n = len(images)
    batch_size = min(batch_size, n)
    perm = np.random.default_rng(0).permutation(n)
    data = torch.as_tensor(np.asarray(images)[perm]).to(device, dtype)
    labs = torch.as_tensor(np.asarray(labels)[perm], dtype=torch.long).to(device)
    steps_per_epoch = max(1, n // batch_size)
    max_off = n - batch_size
    for e in range(epochs):
        # stride the epoch start so batch boundaries differ across epochs
        base = (e * (batch_size // 2)) % (max_off + 1) if max_off else 0
        for s in range(steps_per_epoch):
            off = (base + s * batch_size) % (max_off + 1) if max_off else 0
            logits = model(data[off: off + batch_size], generator=gen)
            loss = F.cross_entropy(logits, labs[off: off + batch_size])
            opt.step(torch.autograd.grad(loss, params), lr)
    return model.eval()


def make_apply(model: nn.Module) -> Callable:
    """Inference-mode logits of `model` (classifier.eval()); the module is
    at `fn.model`."""
    model.eval()

    @torch.no_grad()
    def fn(x):
        return model(x)

    fn.model = model
    return fn


def make_feature_fn(model: nn.Module) -> Callable:
    """Penultimate-embedding encoder for classifier-featurized FID
    (Quality_assess.py:21-170): float64 numpy activations."""
    model.eval()

    @torch.no_grad()
    def fn(x):
        return model(x, features=True).double().cpu().numpy()

    fn.model = model
    return fn


def save_classifier(model: nn.Module, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path)


def load_classifier(model: nn.Module, path: str, device="cuda") -> nn.Module:
    """`model` with the state dict at `path` (FileNotFoundError if none), in
    eval mode on `device` (`cli.common.torch_device`)."""
    device = torch_device(device)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model.to(device).eval()
