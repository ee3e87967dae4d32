"""Checkpoints (mmvae_tpu/train/checkpoints.py) as torch state dicts: the
best-val `model.pt`, with the reference's `.old` backup before overwrite
(utils.py:58-66), and the shared joint-encoder pool that skip_warmup
starts from (utils.py:84-101)."""

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


def _pool_parts(model: nn.Module):
    """(file name, module) of what the shared pool holds: the joint encoder
    and every unimodal decoder (utils.py:84-101)."""
    parts = [("model_joint_encoder.pt", model.joint_encoder)]
    parts += [(f"model_vaes_{i}_decoder.pt", vae.decoder) for i, vae in enumerate(model.vaes)]
    return parts


def save_joint_vae(model: nn.Module, pool_path: str) -> None:
    """Publish the joint encoder and decoders to the shared pool, moving
    the files they replace to <pool>/old (utils.py:92-101, main.py:255-261)."""
    os.makedirs(os.path.join(pool_path, "old"), exist_ok=True)
    for fname, module in _pool_parts(model):
        dst = os.path.join(pool_path, fname)
        if os.path.exists(dst):
            os.replace(dst, os.path.join(pool_path, "old", fname))
        torch.save(module.state_dict(), dst)


def load_joint_vae(model: nn.Module, pool_path: str) -> None:
    """skip_warmup warm start (utils.py:84-90): the joint encoder and
    decoders from the pool, in place. FileNotFoundError when the model has
    no joint encoder or the pool lacks a file, so that the caller trains
    from scratch."""
    if not hasattr(model, "joint_encoder"):
        raise FileNotFoundError(f"no joint encoder in model for pool {pool_path}")
    parts = _pool_parts(model)
    states = [torch.load(os.path.join(pool_path, fname), map_location="cpu", weights_only=True)
              for fname, _ in parts]
    for (_, module), state in zip(parts, states):
        module.load_state_dict(state)
