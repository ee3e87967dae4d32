"""Model registry: config -> built model + spec + dataset wiring
(mmvae_tpu/models/registry.py). The MNIST-SVHN models are ported: MMVAE,
MMVAE-NF, JMVAE-NF(-DCCA), MVAE and MoE-PoE; every other model name of the
JAX registry raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import ExperimentConfig
from ..dcca.nets import LCCAWrappedEncoder, dcca_encoders_mnist_svhn, identity_lcca
from ..flows import IAF, MAF
from ..nets import (
    DecoderSVHN, DoubleHeadJoint, EncoderSVHN, MLPDecoder, MLPEncoder, TwoStepsEncoder,
)
from ..objectives import ModelSpec
from .jmvae_nf import JMVAE_NF
from .mmvae import MMVAE
from .mmvae_nf import MMVAE_NF
from .moepoe import MOEPOE
from .mvae import MVAE
from .vae import UnimodalVAE


@dataclasses.dataclass
class ModelBundle:
    model: nn.Module
    spec: ModelSpec
    dataset: str                  # data.loaders.DATASETS key
    model_name: str
    shape_mods: Tuple[Tuple[int, ...], ...] = ()
    classifier_keys: Tuple[str, ...] = ()  # eval classifier per modality (eval/classifiers.py)


# the MNIST-SVHN builders' modality shapes and eval classifiers
_MS = dict(shape_mods=((1, 28, 28), (3, 32, 32)), classifier_keys=("mnist", "svhn"))


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


def mnist_svhn(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE on MNIST-SVHN (mmvae/mmvae_mnist_svhn.py:31-63): MLP enc/dec for
    MNIST, conv enc/dec for SVHN, Laplace or Normal posteriors."""
    vaes = [
        _vae(cfg, MLPEncoder(latent_dim=cfg.latent_dim, in_features=1 * 28 * 28),
             MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 28, 28)), "mnist"),
        _vae(cfg, EncoderSVHN(latent_dim=cfg.latent_dim),
             DecoderSVHN(latent_dim=cfg.latent_dim), "svhn"),
    ]
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=tuple(cfg.recon_losses),
                     lik_scaling=_ms_lik_scaling(cfg))
    return ModelBundle(MMVAE(vaes, posterior=cfg.dist), spec, "mnist_svhn", "mmvae_mnist_svhn",
                       **_MS)


def _gaussian_ms_vaes(cfg, with_flow: bool = False):
    """The MNIST-SVHN VAEs with normal posteriors, with the config's flow or none."""
    return [
        _vae(cfg, MLPEncoder(latent_dim=cfg.latent_dim, in_features=1 * 28 * 28),
             MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 28, 28)),
             "mnist", posterior="normal", with_flow=with_flow),
        _vae(cfg, EncoderSVHN(latent_dim=cfg.latent_dim),
             DecoderSVHN(latent_dim=cfg.latent_dim), "svhn", posterior="normal",
             with_flow=with_flow),
    ]


def _gaussian_ms_spec(cfg) -> ModelSpec:
    return ModelSpec(latent_dim=cfg.latent_dim, posterior="normal",
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=_ms_lik_scaling(cfg))


def mmvae_nf_mnist_svhn(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE-NF (mmvae_nf/mnist_svhn.py): flow VAEs, normal posteriors."""
    return ModelBundle(MMVAE_NF(_gaussian_ms_vaes(cfg, with_flow=True)), _gaussian_ms_spec(cfg),
                       "mnist_svhn", "mmvae_nf_mnist_svhn", **_MS)


def mvae_mnist_svhn(cfg: ExperimentConfig) -> ModelBundle:
    """MVAE (mvae/mnist_svhn.py): MMVAE's nets, normal posteriors."""
    model = MVAE(_gaussian_ms_vaes(cfg), lik_scaling=_ms_lik_scaling(cfg))
    return ModelBundle(model, _gaussian_ms_spec(cfg), "mnist_svhn", "mvae_mnist_svhn", **_MS)


def moepoe_mnist_svhn(cfg: ExperimentConfig) -> ModelBundle:
    """MoE-PoE (moepoe/mnist_svhn.py): MMVAE's nets and likelihood scaling
    (moepoe/mnist_svhn.py:52), normal posteriors; the KL weight is the
    config's beta_kl, fixed here (the Trainer's per-epoch beta_kl does not
    reach it)."""
    model = MOEPOE(_gaussian_ms_vaes(cfg), lik_scaling=_ms_lik_scaling(cfg),
                   recon_dists=tuple(cfg.recon_losses), beta_kl=cfg.beta_kl)
    return ModelBundle(model, _gaussian_ms_spec(cfg), "mnist_svhn", "moepoe_mnist_svhn", **_MS)


def _dcca_pair(cfg, builders, dim_first: int = 16, artifacts=None):
    """DCCA-wrapped frozen trunks (dcca/models/mnist_svhn.py:97-104).
    artifacts: optional (m_list, w_list) of a fitted LinearCCA; when given,
    the trunk width follows it."""
    if artifacts is not None:
        dim_first = int(np.asarray(artifacts[0][0]).shape[0])
    wrapped = []
    for i, enc in enumerate(builders(dim_first)):
        if artifacts is not None and i < len(artifacts[0]):
            m, w = artifacts[0][i], artifacts[1][i]
        else:
            # the LCCA covers the first two views only
            m, w = identity_lcca(dim_first)
        wrapped.append(LCCAWrappedEncoder(enc, m, w, latent_dim=cfg.dim_dcca))
    return wrapped


def _jnf_mnist_svhn(cfg: ExperimentConfig, use_dcca: bool, dcca_artifacts=None) -> ModelBundle:
    """JMVAE-NF(-DCCA) on MNIST-SVHN (jmvae_nf_mnist_svhn_dcca.py:38-101).
    The joint encoder's heads are 20 wide whatever the latent width, as in
    the JAX package (registry.py:125)."""
    joint = DoubleHeadJoint(
        encoders=[MLPEncoder(latent_dim=20, in_features=1 * 28 * 28), EncoderSVHN(latent_dim=20)],
        latent_dim=cfg.latent_dim, hidden_dim=512, in_features=20 + 20,
        num_hidden_layers=cfg.num_hidden_layers,
    )
    dcca = _dcca_pair(cfg, dcca_encoders_mnist_svhn, 16, dcca_artifacts) if use_dcca else None
    if use_dcca:
        enc1 = TwoStepsEncoder(dcca[0], latent_dim=cfg.latent_dim, in_features=cfg.dim_dcca)
        enc2 = TwoStepsEncoder(dcca[1], latent_dim=cfg.latent_dim, in_features=cfg.dim_dcca)
    else:
        enc1 = MLPEncoder(latent_dim=cfg.latent_dim, in_features=1 * 28 * 28)
        enc2 = EncoderSVHN(latent_dim=cfg.latent_dim)
    vaes = [
        _vae(cfg, enc1, MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 28, 28)),
             "mnist", posterior="normal", with_flow=True),
        _vae(cfg, enc2, DecoderSVHN(latent_dim=cfg.latent_dim), "svhn",
             posterior="normal", with_flow=True),
    ]
    model = JMVAE_NF(joint, vaes, posterior=cfg.dist, dcca_encoders=dcca)
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=_ms_lik_scaling(cfg),
                     no_recon=cfg.no_recon, linear_warmup=cfg.linear_warmup)
    return ModelBundle(model, spec, "mnist_svhn",
                       "jmvae_nf_dcca_mnist_svhn" if use_dcca else "jmvae_nf_mnist_svhn", **_MS)


def _load_dcca_artifacts(cfg: ExperimentConfig, dataset: str):
    """The linear-CCA arrays (m_list, w_list) of a DCCA artifact, or None
    where there is none (dcca/models/mnist_svhn.py:97-104): the config's
    `dcca_path`, else experiments/dcca/<dataset>/dcca.npz. Reads the port's
    artifacts and the JAX package's alike: both keep m0, m1, w0, w1."""
    path = cfg.extra.get("dcca_path", os.path.join("experiments", "dcca", dataset, "dcca.npz"))
    if not os.path.exists(path):
        return None
    with np.load(path) as npz:
        return [npz["m0"], npz["m1"]], [npz["w0"], npz["w1"]]


def jnf_mnist_svhn_dcca(cfg: ExperimentConfig) -> ModelBundle:
    artifacts = _load_dcca_artifacts(cfg, "mnist_svhn") if cfg.dcca else None
    return _jnf_mnist_svhn(cfg, use_dcca=cfg.dcca, dcca_artifacts=artifacts)


def graft_dcca_params(model: nn.Module, dcca_npz_path: str) -> None:
    """Load the pretrained DCCA trunks of a Solver artifact into every
    first_encoder site of `model`, in place (the reference loads
    model{1,2}.pt at construction, dcca/models/mnist_svhn.py:55-58):
    trunk i and its linear-CCA projection (m_i, w_i) go to modality i."""
    from ..bridge import load_jax_params
    from ..dcca.train import load_trunk_params

    trunks = load_trunk_params(dcca_npz_path)
    dcca = getattr(model, "dcca_encoders", None)
    with np.load(dcca_npz_path) as npz, torch.no_grad():
        for i, vae in enumerate(model.vaes):
            # the TwoStepsEncoder's trunk and the DCCA encoder are one module
            # where the registry built them; both are loaded all the same
            sites = [vae.encoder.first_encoder] if isinstance(vae.encoder, TwoStepsEncoder) else []
            sites += [dcca[i]] if dcca is not None else []
            for site in sites:
                load_jax_params(site.encoder, trunks[f"encoders_{i}"])
                site.m.copy_(torch.as_tensor(npz[f"m{i}"]))
                site.w.copy_(torch.as_tensor(npz[f"w{i}"]))


REGISTRY: Dict[str, Callable[[ExperimentConfig], ModelBundle]] = {
    "mnist_svhn": mnist_svhn,
    "mmvae_nf_mnist_svhn": mmvae_nf_mnist_svhn,
    "jnf_mnist_svhn_dcca": jnf_mnist_svhn_dcca,
    "mvae_mnist_svhn": mvae_mnist_svhn,
    "moepoe_mnist_svhn": moepoe_mnist_svhn,
}


def build(cfg: ExperimentConfig) -> ModelBundle:
    """getattr(models, 'VAE_'+args.model)(args) equivalent (main.py:70-71)."""
    if cfg.model not in REGISTRY:
        raise NotImplementedError(f"model {cfg.model!r} not yet ported")
    return REGISTRY[cfg.model](cfg)
