"""Model registry: config -> built model + spec + dataset wiring
(mmvae_tpu/models/registry.py). Only MMVAE-NF on MNIST-SVHN is ported so
far; every other model name of the JAX registry raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from torch import nn

from ..core.config import ExperimentConfig
from ..flows import IAF, MAF
from ..nets import DecoderSVHN, EncoderSVHN, MLPDecoder, MLPEncoder
from ..objectives import ModelSpec
from .mmvae_nf import MMVAE_NF
from .vae import UnimodalVAE


@dataclasses.dataclass
class ModelBundle:
    model: nn.Module
    spec: ModelSpec
    dataset: str                  # data.loaders.DATASETS key
    model_name: str


def _flow(cfg: ExperimentConfig):
    """Unimodal posterior flow per config (n_made_blocks defaults to 2)."""
    if cfg.no_nf:
        return None
    if cfg.flow == "lin_nf":
        raise NotImplementedError("LinearNF not yet ported")
    n_blocks = cfg.n_made_blocks if cfg.n_made_blocks is not None else 2
    flow_cls = IAF if cfg.flow == "iaf" else MAF
    return flow_cls(features=cfg.latent_dim, n_made_blocks=n_blocks, s_bound=cfg.s_bound_flow)


def _vae(cfg, encoder, decoder, name, posterior=None, with_flow=False):
    return UnimodalVAE(
        encoder=encoder, decoder=decoder, latent_dim=cfg.latent_dim,
        flow=_flow(cfg) if with_flow else None,
        posterior=posterior or ("laplace" if cfg.dist == "laplace" else "normal"),
        model_name=name,
    )


def _ms_lik_scaling(cfg) -> Tuple[float, float]:
    """((3*32*32)/(1*28*28), 1) unless overridden (mmvae_mnist_svhn.py:54)."""
    return ((3 * 32 * 32) / (1 * 28 * 28), 1.0) if cfg.llik_scaling == 0 else (cfg.llik_scaling, 1.0)


def mmvae_nf_mnist_svhn(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE-NF (mmvae_nf/mnist_svhn.py): flow VAEs, normal posteriors."""
    vaes = [
        _vae(cfg, MLPEncoder(latent_dim=cfg.latent_dim, in_features=1 * 28 * 28),
             MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 28, 28)),
             "mnist", posterior="normal", with_flow=True),
        _vae(cfg, EncoderSVHN(latent_dim=cfg.latent_dim),
             DecoderSVHN(latent_dim=cfg.latent_dim), "svhn",
             posterior="normal", with_flow=True),
    ]
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior="normal",
                     recon_dists=tuple(cfg.recon_losses),
                     lik_scaling=_ms_lik_scaling(cfg))
    return ModelBundle(MMVAE_NF(vaes), spec, "mnist_svhn", "mmvae_nf_mnist_svhn")


REGISTRY: Dict[str, Callable[[ExperimentConfig], ModelBundle]] = {
    "mmvae_nf_mnist_svhn": mmvae_nf_mnist_svhn,
}


def build(cfg: ExperimentConfig) -> ModelBundle:
    """getattr(models, 'VAE_'+args.model)(args) equivalent (main.py:70-71)."""
    if cfg.model not in REGISTRY:
        raise NotImplementedError(f"model {cfg.model!r} not yet ported")
    return REGISTRY[cfg.model](cfg)
