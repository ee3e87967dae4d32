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

from .conv import Conv2d, ConvTranspose2d, Linear


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


class EncoderSVHN(nn.Module):
    """3 conv(ReLU) + 2 conv heads (encoders.py:72-105). Input (B,C,32,32)."""

    def __init__(self, latent_dim: int, n_channels: int = 3, f_base: int = 32):
        super().__init__()
        f = f_base
        self.latent_dim = latent_dim
        self.Conv2d_0 = Conv2d(n_channels, f, 4, 2, padding=1)   # 16x16
        self.Conv2d_1 = Conv2d(f, f * 2, 4, 2, padding=1)        # 8x8
        self.Conv2d_2 = Conv2d(f * 2, f * 4, 4, 2, padding=1)    # 4x4
        self.c1 = Conv2d(f * 4, latent_dim, 4, 2, padding=0)
        self.c2 = Conv2d(f * 4, latent_dim, 4, 2, padding=0)

    def forward(self, x):
        h = torch.relu(self.Conv2d_0(x))
        h = torch.relu(self.Conv2d_1(h))
        h = torch.relu(self.Conv2d_2(h))
        return (self.c1(h).reshape(-1, self.latent_dim),
                self.c2(h).reshape(-1, self.latent_dim))


class DecoderSVHN(nn.Module):
    """4 deconv(ReLU) -> Sigmoid (encoders.py:108-136). Output (B,C,32,32)."""

    def __init__(self, latent_dim: int, n_channels: int = 3, f_base: int = 32):
        super().__init__()
        f = f_base
        self.ConvTranspose2d_0 = ConvTranspose2d(latent_dim, f * 4, 4, 1, padding=0)  # 4x4
        self.ConvTranspose2d_1 = ConvTranspose2d(f * 4, f * 2, 4, 2, padding=1)       # 8x8
        self.ConvTranspose2d_2 = ConvTranspose2d(f * 2, f, 4, 2, padding=1)           # 16x16
        self.ConvTranspose2d_3 = ConvTranspose2d(f, n_channels, 4, 2, padding=1)      # 32x32

    def forward(self, z):
        lead = z.shape[:-1]
        h = z.reshape(-1, z.shape[-1], 1, 1)
        h = torch.relu(self.ConvTranspose2d_0(h))
        h = torch.relu(self.ConvTranspose2d_1(h))
        h = torch.relu(self.ConvTranspose2d_2(h))
        h = torch.sigmoid(self.ConvTranspose2d_3(h))
        return h.reshape(*lead, *h.shape[1:])
