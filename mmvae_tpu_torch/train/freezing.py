"""Phase-based parameter freezing (mmvae_tpu/train/freezing.py).

A parameter is frozen iff its name contains one of the phase's frozen
prefixes; frozen parameters get no update and hold no optimizer state, as
the reference's requires_grad_(False) plus optimizer rebuild
(objectives.py:180-183, main.py:241-245).
"""

from __future__ import annotations

from typing import Dict, Sequence

from torch import nn

# objectives that toggle requires_grad_ in the reference; all others train
# every parameter regardless of the fix_* flags
FREEZING_OBJECTIVES = {"m_jmvae_nf", "m_telbo_nf", "m_jmvae"}


def frozen_prefixes_for_phase(obj_name: str, past_warmup: bool,
                              fix_jencoder: bool, fix_decoders: bool,
                              always_frozen=("first_encoder",)):
    """Which submodule paths are frozen in the current phase."""
    frozen = list(always_frozen)
    if past_warmup and obj_name in FREEZING_OBJECTIVES:
        if obj_name == "m_jmvae":
            frozen.append("joint_encoder")
        else:
            if fix_jencoder:
                frozen.append("joint_encoder")
            if fix_decoders:
                frozen.append("decoder")
    return tuple(frozen)


def trainable_parameters(model: nn.Module, frozen_prefixes: Sequence[str]) -> Dict[str, nn.Parameter]:
    """name -> parameter for every parameter not frozen."""
    return {name: p for name, p in model.named_parameters()
            if not any(f in name for f in frozen_prefixes)}
