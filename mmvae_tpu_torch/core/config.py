"""Experiment configuration (mmvae_tpu/core/config.py): the reference's JSON
schema with the same keys and defaults. Unknown keys land in `extra`, so
every config file under configs/ loads unchanged."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    # identity
    experiment: str = ""
    model: str = ""
    wandb_experiment: str = ""

    # objective
    obj: str = "elbo"
    K: int = 1
    looser: bool = False
    recon_losses: Tuple[str, ...] = ("normal", "normal")
    llik_scaling: float = 0.0
    beta_prior: float = 1.0
    beta_kl: float = 1.0
    decrease_beta_kl: float = 1.0
    beta: float = 1000.0

    # model
    latent_dim: int = 20
    num_hidden_layers: int = 1
    dist: str = "normal"
    no_nf: bool = True
    flow: str = "maf"
    n_made_blocks: Optional[int] = None
    # bounded flow log-scale s -> b*tanh(s/b); 0 = unbounded MADE s head
    s_bound_flow: float = 0.0
    # global-norm gradient clipping; 0 = none
    clip_grad_norm: float = 0.0
    dcca: bool = False
    dim_dcca: int = 16
    learn_prior: bool = False

    # training
    batch_size: int = 128
    learning_rate: float = 1e-3
    epochs: int = 30
    warmup: int = 0
    skip_warmup: bool = False
    fix_decoders: bool = True
    fix_jencoder: bool = True
    no_recon: bool = False
    linear_warmup: bool = False
    use_pretrain: str = ""
    use_gen: bool = False
    len_gen: int = 0
    len_train: Optional[int] = None
    seed: int = 1
    save_joint: bool = False

    # io / tracking
    data_path: str = "../data/"
    print_freq: int = 0
    no_analytics: bool = False
    freq_analytics: int = 5
    no_cuda: bool = False
    device: str = "tpu"
    logp: bool = False

    # the data-parallel mesh (parallel/mesh.py): data ranks (None: every
    # rank) and k replicas of each
    mesh_data: Optional[int] = None
    mesh_k: int = 1

    # skip param/optimizer updates on steps whose loss or grads are not
    # finite; finite steps are unchanged either way
    nan_guard: bool = True

    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in raw.items() if k in fields}
        extra = {k: v for k, v in raw.items() if k not in fields}
        if "recon_losses" in known:
            known["recon_losses"] = tuple(known["recon_losses"])
        cfg = cls(**known)
        cfg.extra = extra
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        d["recon_losses"] = list(self.recon_losses)
        return d
