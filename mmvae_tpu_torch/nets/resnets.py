"""ResNet encoders and decoders for MedMNIST (28x28) and CelebA (64x64)
(mmvae_tpu/nets/resnets.py; the reference's models/nn/medmnist.py:100-430
and the pythae CelebA benchmark nets).

Three strided convs down to a small feature map, pythae's ResBlocks
(ReLU, conv 3x3, ReLU, conv 1x1, additive skip), then the linear heads; the
decoders mirror them with ConvTranspose stages and a sigmoid output.
Submodule names follow the JAX tree (`Conv2d_0`, `ResBlock_0`,
`ConvTranspose2d_2`, ...), so that bridge.py maps the two one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv2d, ConvTranspose2d, Linear


class ResBlock(nn.Module):
    """pythae's ResBlock: x + conv1x1(relu(conv3x3(relu(x))))."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Conv2d_0 = Conv2d(in_channels, out_channels, 3, 1, padding=1)
        self.Conv2d_1 = Conv2d(out_channels, in_channels, 1, 1, padding=0)

    def forward(self, x):
        h = self.Conv2d_0(torch.relu(x))
        return x + self.Conv2d_1(torch.relu(h))


class EncoderResNetVAE(nn.Module):
    """The shared ResNet VAE encoder: convs of 64, 128 and 128 channels (no
    activation between them, as in the JAX package), `n_res_blocks`
    ResBlocks, then the `embedding` and `log_var` heads on the flattened
    128 x feature_map^2 map (4 for 28x28 MedMNIST, 8 for 64x64 CelebA)."""

    def __init__(self, latent_dim: int, n_channels: int = 1, feature_map: int = 4,
                 n_res_blocks: int = 3):
        super().__init__()
        self.Conv2d_0 = Conv2d(n_channels, 64, 4, 2, padding=1)
        self.Conv2d_1 = Conv2d(64, 128, 4, 2, padding=1)
        self.Conv2d_2 = Conv2d(128, 128, 3, 2, padding=1)
        self.n_res_blocks = n_res_blocks
        for i in range(n_res_blocks):
            setattr(self, f"ResBlock_{i}", ResBlock(128, 32))
        self.embedding = Linear(128 * feature_map ** 2, latent_dim)
        self.log_var = Linear(128 * feature_map ** 2, latent_dim)

    def forward(self, x):
        h = self.Conv2d_2(self.Conv2d_1(self.Conv2d_0(x)))
        for i in range(self.n_res_blocks):
            h = getattr(self, f"ResBlock_{i}")(h)
        h = h.reshape(h.shape[0], -1)
        return self.embedding(h), self.log_var(h)


class DecoderResNetAE(nn.Module):
    """The shared ResNet decoder: a Linear to 128 x feature_map^2, a
    ConvTranspose of 128 (`first_output_padding` 0: 4 -> 7 for MedMNIST, 1:
    8 -> 16 for CelebA), the ResBlocks, then ConvTransposes of 64 and
    `n_channels` with a sigmoid. The last is a head: its output, the
    likelihood's parameter, stays out of the activation downcast."""

    def __init__(self, latent_dim: int, n_channels: int = 1, feature_map: int = 4,
                 n_res_blocks: int = 3, first_output_padding: int = 0):
        super().__init__()
        self.feature_map, self.n_res_blocks = feature_map, n_res_blocks
        self.Linear_0 = Linear(latent_dim, 128 * feature_map ** 2)
        self.ConvTranspose2d_0 = ConvTranspose2d(128, 128, 3, 2, padding=1,
                                                 output_padding=first_output_padding)
        for i in range(n_res_blocks):
            setattr(self, f"ResBlock_{i}", ResBlock(128, 32))
        self.ConvTranspose2d_1 = ConvTranspose2d(128, 64, 3, 2, padding=1, output_padding=1)
        self.ConvTranspose2d_2 = ConvTranspose2d(64, n_channels, 3, 2, padding=1,
                                                 output_padding=1, head=True)

    def forward(self, z):
        lead = z.shape[:-1]
        fm = self.feature_map
        h = self.Linear_0(z.reshape(-1, z.shape[-1])).reshape(-1, 128, fm, fm)
        h = self.ConvTranspose2d_0(h)
        for i in range(self.n_res_blocks):
            h = getattr(self, f"ResBlock_{i}")(h)
        h = torch.relu(self.ConvTranspose2d_1(torch.relu(h)))
        h = torch.sigmoid(self.ConvTranspose2d_2(h))
        return h.reshape(*lead, *h.shape[1:])


def medmnist_encoder(latent_dim: int, n_channels: int = 1):
    """Encoder_ResNet_VAE_medmnist (medmnist.py:173-316): 28x28 -> 4x4."""
    return EncoderResNetVAE(latent_dim, n_channels, feature_map=4)


def medmnist_decoder(latent_dim: int, n_channels: int = 1):
    """Decoder_ResNet_AE_medmnist (medmnist.py:318-430): 4x4 -> 28x28."""
    return DecoderResNetAE(latent_dim, n_channels, feature_map=4)


def celeba_encoder(latent_dim: int):
    """pythae's Encoder_ResNet_VAE_CELEBA in shape: 3x64x64 -> 8x8, 2 ResBlocks."""
    return EncoderResNetVAE(latent_dim, 3, feature_map=8, n_res_blocks=2)


def celeba_decoder(latent_dim: int):
    """8x8 -> 3x64x64, 2 ResBlocks."""
    return DecoderResNetAE(latent_dim, 3, feature_map=8, n_res_blocks=2, first_output_padding=1)
