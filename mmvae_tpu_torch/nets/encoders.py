"""Per-modality encoder/decoder architectures (mmvae_tpu/nets/encoders.py).

Encoders return (embedding, log_var); decoders return the reconstruction
mean. Submodule names follow the JAX parameter tree (`Linear_0`,
`Conv2d_1`, `c1`, ...) so that bridge.py maps the two one to one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .conv import BatchNorm2d, Conv2d, ConvTranspose2d, Linear


def hidden_stack(module: nn.Module, in_features: int, hidden_dim: int, n: int) -> None:
    """`n` Linear layers named Linear_0..Linear_{n-1}, as flax names them."""
    for i in range(n):
        setattr(module, f"Linear_{i}", Linear(in_features if i == 0 else hidden_dim, hidden_dim))


def run_hidden(module: nn.Module, h, n: int):
    """h through the `n` layers of `hidden_stack`, each followed by a ReLU."""
    for i in range(n):
        h = torch.relu(getattr(module, f"Linear_{i}")(h))
    return h


class MLPEncoder(nn.Module):
    """pythae default Encoder_VAE_MLP: flatten -> Linear(512) ReLU -> heads."""

    def __init__(self, latent_dim: int, in_features: int, hidden_dim: int = 512):
        super().__init__()
        self.Linear_0 = Linear(in_features, hidden_dim)
        self.embedding = Linear(hidden_dim, latent_dim)
        self.log_var = Linear(hidden_dim, latent_dim)

    def forward(self, x):
        h = torch.relu(self.Linear_0(x.reshape(x.shape[0], -1)))
        return self.embedding(h), self.log_var(h)


class MLPDecoder(nn.Module):
    """pythae default Decoder_AE_MLP: Linear(512) ReLU -> Linear(prod) Sigmoid."""

    def __init__(self, latent_dim: int, output_shape: Sequence[int], hidden_dim: int = 512):
        super().__init__()
        self.output_shape = tuple(output_shape)
        self.Linear_0 = Linear(latent_dim, hidden_dim)
        self.Linear_1 = Linear(hidden_dim, int(np.prod(self.output_shape)))

    def forward(self, z):
        lead = z.shape[:-1]
        h = torch.relu(self.Linear_0(z.reshape(-1, z.shape[-1])))
        out = torch.sigmoid(self.Linear_1(h))
        return out.reshape(*lead, *self.output_shape)


class EncoderMNIST(nn.Module):
    """3 conv(BN, ReLU) -> 2 linear heads (encoders.py:8-41). Input
    (B, 1, 28, 28). The BatchNorms follow the module's mode: batch
    statistics in training, running ones in eval."""

    def __init__(self, latent_dim: int, f_base: int = 32):
        super().__init__()
        f = f_base
        self.Conv2d_0, self.BatchNorm2d_0 = Conv2d(1, f, 4, 2, padding=1), BatchNorm2d(f)  # 14x14
        self.Conv2d_1, self.BatchNorm2d_1 = Conv2d(f, 2 * f, 4, 2, padding=1), BatchNorm2d(2 * f)  # 7x7
        self.Conv2d_2, self.BatchNorm2d_2 = Conv2d(2 * f, 4 * f, 5, 2, padding=1), BatchNorm2d(4 * f)  # 3x3
        self.embedding = Linear(4 * f * 3 * 3, latent_dim)
        self.log_var = Linear(4 * f * 3 * 3, latent_dim)

    def forward(self, x):
        h = torch.relu(self.BatchNorm2d_0(self.Conv2d_0(x)))
        h = torch.relu(self.BatchNorm2d_1(self.Conv2d_1(h)))
        h = torch.relu(self.BatchNorm2d_2(self.Conv2d_2(h)))
        h = h.reshape(h.shape[0], -1)
        return self.embedding(h), self.log_var(h)


class DecoderMNIST(nn.Module):
    """fc -> 3 deconv (BN, ReLU on the first two) -> sigmoid
    (encoders.py:44-68). Output (B, n_channels, 28, 28)."""

    def __init__(self, latent_dim: int, f_base: int = 32, n_channels: int = 1):
        super().__init__()
        f = f_base
        self.f_base = f
        self.fc = Linear(latent_dim, f * 4 * 4 * 4)
        self.ConvTranspose2d_0 = ConvTranspose2d(4 * f, 2 * f, 3, 2, padding=1)  # 7x7
        self.BatchNorm2d_0 = BatchNorm2d(2 * f)
        self.ConvTranspose2d_1 = ConvTranspose2d(2 * f, f, 3, 2, padding=1, output_padding=1)  # 14x14
        self.BatchNorm2d_1 = BatchNorm2d(f)
        # head: the sigmoid output is the likelihood's parameter
        self.ConvTranspose2d_2 = ConvTranspose2d(f, n_channels, 3, 2, padding=1, output_padding=1,
                                                 head=True)  # 28x28

    def forward(self, z):
        lead = z.shape[:-1]
        h = self.fc(z.reshape(-1, z.shape[-1])).reshape(-1, 4 * self.f_base, 4, 4)
        h = torch.relu(self.BatchNorm2d_0(self.ConvTranspose2d_0(h)))
        h = torch.relu(self.BatchNorm2d_1(self.ConvTranspose2d_1(h)))
        h = torch.sigmoid(self.ConvTranspose2d_2(h))
        return h.reshape(*lead, *h.shape[1:])


class EncoderSVHN(nn.Module):
    """3 conv(ReLU) + 2 conv heads (encoders.py:72-105). Input (B,C,32,32)."""

    def __init__(self, latent_dim: int, n_channels: int = 3, f_base: int = 32):
        super().__init__()
        f = f_base
        self.latent_dim = latent_dim
        self.Conv2d_0 = Conv2d(n_channels, f, 4, 2, padding=1)   # 16x16
        self.Conv2d_1 = Conv2d(f, f * 2, 4, 2, padding=1)        # 8x8
        self.Conv2d_2 = Conv2d(f * 2, f * 4, 4, 2, padding=1)    # 4x4
        # heads: the posterior's parameters stay out of the activation downcast
        self.c1 = Conv2d(f * 4, latent_dim, 4, 2, padding=0, head=True)
        self.c2 = Conv2d(f * 4, latent_dim, 4, 2, padding=0, head=True)

    def forward(self, x):
        h = torch.relu(self.Conv2d_0(x))
        h = torch.relu(self.Conv2d_1(h))
        h = torch.relu(self.Conv2d_2(h))
        return (self.c1(h).reshape(-1, self.latent_dim),
                self.c2(h).reshape(-1, self.latent_dim))


class TwoStepsEncoder(nn.Module):
    """Frozen pretrained trunk -> trainable MLP -> heads (encoders.py:163-187;
    reference encoders.py:176-210). The trunk runs without a gradient, as
    JAX's stop_gradient and the reference's requires_grad_(False) + no_grad;
    its parameters are also left out of the optimizer by the freezing
    prefix "first_encoder" (train/freezing.py). `in_features`: the trunk's
    output width."""

    def __init__(self, first_encoder: nn.Module, latent_dim: int, in_features: int,
                 hidden_dim: int = 512, num_hidden: int = 3):
        super().__init__()
        self.first_encoder = first_encoder
        self.num_hidden = num_hidden
        hidden_stack(self, in_features, hidden_dim, num_hidden)
        width = hidden_dim if num_hidden else in_features
        self.embedding = Linear(width, latent_dim)
        self.log_var = Linear(width, latent_dim)

    def forward(self, x):
        with torch.no_grad():
            h = self.first_encoder(x)
            if isinstance(h, tuple):
                h = h[0]  # embedding
        h = run_hidden(self, h, self.num_hidden)
        return self.embedding(h), self.log_var(h)


class DecoderSVHN(nn.Module):
    """4 deconv(ReLU) -> Sigmoid (encoders.py:108-136). Output (B,C,32,32)."""

    def __init__(self, latent_dim: int, n_channels: int = 3, f_base: int = 32):
        super().__init__()
        f = f_base
        self.ConvTranspose2d_0 = ConvTranspose2d(latent_dim, f * 4, 4, 1, padding=0)  # 4x4
        self.ConvTranspose2d_1 = ConvTranspose2d(f * 4, f * 2, 4, 2, padding=1)       # 8x8
        self.ConvTranspose2d_2 = ConvTranspose2d(f * 2, f, 4, 2, padding=1)           # 16x16
        # head: the sigmoid output is the likelihood's parameter
        self.ConvTranspose2d_3 = ConvTranspose2d(f, n_channels, 4, 2, padding=1, head=True)  # 32x32

    def forward(self, z):
        lead = z.shape[:-1]
        h = z.reshape(-1, z.shape[-1], 1, 1)
        h = torch.relu(self.ConvTranspose2d_0(h))
        h = torch.relu(self.ConvTranspose2d_1(h))
        h = torch.relu(self.ConvTranspose2d_2(h))
        h = torch.sigmoid(self.ConvTranspose2d_3(h))
        return h.reshape(*lead, *h.shape[1:])
