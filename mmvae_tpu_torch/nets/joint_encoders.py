"""Joint encoders q(z|x,y) for JMVAE(-NF) models
(mmvae_tpu/nets/joint_encoders.py; reference models/nn/joint_encoders.py).

All return (mu, std): they emit the STD directly, with the reference's
parameterizations, not a log-variance. Submodule names follow the JAX
parameter tree (`encoders_0`, `Linear_0`, `fc21`, ...), so bridge.py maps
the two one to one. PyTorch layers need their input widths, which the JAX
modules infer at init: each constructor takes them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core import distributions as D
from .conv import Linear
from .encoders import hidden_stack, run_hidden


class JointMLPEncoder(nn.Module):
    """Concat-flatten MLP joint encoder with the softmax-std
    (joint_encoders.py:14-30). `in_features`: the flattened widths of all
    modalities together."""

    def __init__(self, latent_dim: int, hidden_dim: int, in_features: int,
                 num_hidden_layers: int = 1):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        hidden_stack(self, in_features, hidden_dim, num_hidden_layers)
        width = hidden_dim if num_hidden_layers else in_features
        self.fc21 = Linear(width, latent_dim)
        self.fc22 = Linear(width, latent_dim)

    def forward(self, xs):
        h = torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)
        h = run_hidden(self, h, self.num_hidden_layers)
        return self.fc21(h), D.std_softmax_trick(self.fc22(h))


class DoubleHeadMLP(nn.Module):
    """Per-modality linear head -> shared MLP (joint_encoders.py:34-54).
    `in_features`: the two modalities' flattened widths."""

    def __init__(self, latent_dim: int, hidden_dim: int, in_features: Sequence[int],
                 num_hidden_layers: int = 1):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        self.input1 = Linear(in_features[0], hidden_dim)
        self.input2 = Linear(in_features[1], hidden_dim)
        hidden_stack(self, 2 * hidden_dim, hidden_dim, num_hidden_layers)
        width = hidden_dim if num_hidden_layers else 2 * hidden_dim
        self.fc21 = Linear(width, latent_dim)
        self.fc22 = Linear(width, latent_dim)

    def forward(self, xs):
        h0 = torch.relu(self.input1(xs[0].reshape(xs[0].shape[0], -1)))
        h1 = torch.relu(self.input2(xs[1].reshape(xs[1].shape[0], -1)))
        h = run_hidden(self, torch.cat([h0, h1], dim=1), self.num_hidden_layers)
        return self.fc21(h), D.std_joint_encoder(self.fc22(h))


class MultipleHeadJoint(nn.Module):
    """N-modality conv/MLP heads -> shared MLP (joint_encoders.py:56-108).
    Each head's first output (its embedding) feeds the trunk.
    `in_features`: the heads' embedding widths together."""

    def __init__(self, encoders: Sequence[nn.Module], latent_dim: int, hidden_dim: int,
                 in_features: int, num_hidden_layers: int = 1):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)
        self.num_hidden_layers = num_hidden_layers
        hidden_stack(self, in_features, hidden_dim, num_hidden_layers)
        width = hidden_dim if num_hidden_layers else in_features
        self.fc21 = Linear(width, latent_dim)
        self.fc22 = Linear(width, latent_dim)

    def forward(self, xs):
        heads = []
        for enc, x in zip(self.encoders, xs):
            out = enc(x)
            heads.append(out[0] if isinstance(out, tuple) else out)
        h = run_hidden(self, torch.cat(heads, dim=1), self.num_hidden_layers)
        return self.fc21(h), D.std_joint_encoder(self.fc22(h))


# DoubleHeadJoint (joint_encoders.py:56-82) is MultipleHeadJoint with 2 heads.
DoubleHeadJoint = MultipleHeadJoint
