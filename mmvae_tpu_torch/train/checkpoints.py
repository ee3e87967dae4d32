"""Best-val checkpoint (mmvae_tpu/train/checkpoints.py) as a torch state
dict in `model.pt`, with the reference's `.old` backup before overwrite
(utils.py:58-66)."""

from __future__ import annotations

import os
import shutil

import torch
from torch import nn


def save_model(model: nn.Module, run_path: str, name: str = "model") -> str:
    os.makedirs(run_path, exist_ok=True)
    path = os.path.join(run_path, f"{name}.pt")
    if os.path.exists(path):
        shutil.copyfile(path, path + ".old")
    torch.save(model.state_dict(), path)
    return path
