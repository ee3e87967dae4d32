"""Model registry: config -> built model + spec + dataset wiring
(mmvae_tpu/models/registry.py). Ported: the MNIST-SVHN models (MMVAE,
MMVAE-NF, JMVAE-NF(-DCCA), MVAE and MoE-PoE), circles-squares' MMVAE and
JMVAE-NF(-DCCA), MNIST-Fashion's MMVAE and JMVAE-NF, MNIST-Contour's
JMVAE-NF, trimodal MNIST-SVHN-Fashion's MMVAE, JMVAE-NF(-DCCA) and MVAE,
MedMNIST's MMVAE, JMVAE-NF(-DCCA) and MVAE, chest-SVHN's JMVAE-NF, and
CelebA's MMVAE, MMVAE-NF, JMVAE-NF(-DCCA), MVAE and MoE-PoE: every builder
of the JAX package's registry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import ExperimentConfig
from ..dcca.nets import (
    LCCAWrappedEncoder, dcca_encoders_celeba, dcca_encoders_circles, dcca_encoders_medmnist,
    dcca_encoders_mnist_svhn, dcca_encoders_msf, identity_lcca,
)
from ..flows import IAF, LinearNF, MAF
from ..nets import (
    DecoderMNIST, DecoderSVHN, DoubleHeadJoint, DoubleHeadMLP, EncoderMNIST, EncoderSVHN,
    MLPDecoder, MLPEncoder, MultipleHeadJoint, TwoStepsEncoder,
)
from ..nets.resnets import celeba_decoder, celeba_encoder, medmnist_decoder, medmnist_encoder
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
        return LinearNF(features=cfg.latent_dim)
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


def _dcca_pair(cfg, builders, dim_first: int = 16, artifacts=None, fitted_lcca: bool = True):
    """DCCA-wrapped frozen trunks (dcca/models/mnist_svhn.py:97-104).
    artifacts: optional (m_list, w_list) of a fitted LinearCCA; when given,
    the trunk width follows it. `fitted_lcca` False: the identity
    projection for good, the artifact's trunks alone grafted."""
    if artifacts is not None:
        dim_first = int(np.asarray(artifacts[0][0]).shape[0])
    wrapped = []
    for i, enc in enumerate(builders(dim_first)):
        if artifacts is not None and i < len(artifacts[0]):
            m, w = artifacts[0][i], artifacts[1][i]
        else:
            # the LCCA covers the first two views only
            m, w = identity_lcca(dim_first)
        wrapped.append(LCCAWrappedEncoder(enc, m, w, latent_dim=cfg.dim_dcca,
                                          fitted_lcca=fitted_lcca))
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
    trunk i and, where the model reads one (`fitted_lcca`), its linear-CCA
    projection (m_i, w_i) go to modality i. The trimodal trunks keep their
    identity projection, as in the JAX package, which grafts the trunks
    alone."""
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
                if site.fitted_lcca:
                    site.m.copy_(torch.as_tensor(npz[f"m{i}"]))
                    site.w.copy_(torch.as_tensor(npz[f"w{i}"]))


# ---------------------------------------------------------------------------
# circles-squares, MNIST-Fashion, MNIST-Contour: one-channel images
# ---------------------------------------------------------------------------

_CIRCLES = dict(shape_mods=((1, 32, 32), (1, 32, 32)),
                classifier_keys=("empty_full", "empty_full"))


def _circles_vae(cfg, encoder, name, with_flow=False):
    """A circles-squares VAE: 1x32x32 SVHN-style conv nets, normal posterior."""
    return _vae(cfg, encoder, DecoderSVHN(latent_dim=cfg.latent_dim, n_channels=1), name,
                posterior="normal", with_flow=with_flow)


def _jnf_spec(cfg) -> ModelSpec:
    """JMVAE-NF's spec on the one-channel datasets: likelihood scaling (1, 1)."""
    return ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=(1.0, 1.0),
                     no_recon=cfg.no_recon, linear_warmup=cfg.linear_warmup)


def circles_squares(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE on circles-squares (mmvae/mmvae_circles.py): one-channel SVHN
    conv encoders and decoders, normal posteriors, likelihood scaling (1, 1)."""
    vaes = [_circles_vae(cfg, EncoderSVHN(latent_dim=cfg.latent_dim, n_channels=1), name)
            for name in ("squares", "circles")]
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=(1.0, 1.0))
    return ModelBundle(MMVAE(vaes, posterior=cfg.dist), spec, "circles_squares", "mmvae_circles",
                       **_CIRCLES)


def jnf_circles_squares(cfg: ExperimentConfig) -> ModelBundle:
    """JMVAE-NF on circles-squares (jmvae_nf_circles.py:40-70): the
    DoubleHeadMLP joint encoder on the flattened images; with `dcca`, each
    unimodal encoder is a TwoStepsEncoder on a DCCA trunk. The reference
    passes num_hidden=1 to it, which TwoStepsEncoder ignores: it builds 3
    hidden layers of 512 (nn/encoders.py:183-184), as here."""
    joint = DoubleHeadMLP(latent_dim=cfg.latent_dim, hidden_dim=512, in_features=(1024, 1024),
                          num_hidden_layers=cfg.num_hidden_layers)
    if cfg.dcca:
        dcca = _dcca_pair(cfg, dcca_encoders_circles, 16,
                          _load_dcca_artifacts(cfg, "circles_squares"))
        encs = [TwoStepsEncoder(d, latent_dim=cfg.latent_dim, in_features=cfg.dim_dcca)
                for d in dcca]
    else:
        dcca = None
        encs = [EncoderSVHN(latent_dim=cfg.latent_dim, n_channels=1) for _ in range(2)]
    vaes = [_circles_vae(cfg, enc, name, with_flow=True)
            for enc, name in zip(encs, ("squares", "circles"))]
    model = JMVAE_NF(joint, vaes, posterior=cfg.dist, dcca_encoders=dcca)
    return ModelBundle(model, _jnf_spec(cfg), "circles_squares", "jmvae_nf_circles", **_CIRCLES)


def _mnist1ch_vaes(cfg, names, posterior=None, with_flow=False):
    """Conv MNIST VAEs (EncoderMNIST, DecoderMNIST) for 1x28x28 modalities."""
    return [_vae(cfg, EncoderMNIST(latent_dim=cfg.latent_dim),
                 DecoderMNIST(latent_dim=cfg.latent_dim), name, posterior=posterior,
                 with_flow=with_flow) for name in names]


def mnist_fashion(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE on MNIST-Fashion (mmvae/mmave_mnist.py): conv MNIST nets;
    likelihood scaling (1, 1), or (llik_scaling, 1) where it is set
    (mmave_mnist.py:57)."""
    ls = (1.0, 1.0) if cfg.llik_scaling == 0 else (cfg.llik_scaling, 1.0)
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=ls)
    model = MMVAE(_mnist1ch_vaes(cfg, ("mnist", "fashion")), posterior=cfg.dist)
    return ModelBundle(model, spec, "mnist_fashion", "mmvae_mnist_fashion",
                       shape_mods=((1, 28, 28), (1, 28, 28)), classifier_keys=("mnist", "fashion"))


def _jnf_mnist1ch(cfg, names, num_hidden_layers: int):
    joint = DoubleHeadMLP(latent_dim=cfg.latent_dim, hidden_dim=512, in_features=(784, 784),
                          num_hidden_layers=num_hidden_layers)
    vaes = _mnist1ch_vaes(cfg, names, posterior="normal", with_flow=True)
    return JMVAE_NF(joint, vaes, posterior=cfg.dist)


def jnf_mnist_fashion(cfg: ExperimentConfig) -> ModelBundle:
    """JMVAE-NF on MNIST-Fashion (jmvae_nf_mnist.py:40-60): the
    DoubleHeadMLP joint encoder with one hidden layer whatever the config
    says, conv MNIST VAEs."""
    return ModelBundle(_jnf_mnist1ch(cfg, ("mnist", "fashion"), 1), _jnf_spec(cfg),
                       "mnist_fashion", "jmvae_nf_mnist_fashion",
                       shape_mods=((1, 28, 28), (1, 28, 28)), classifier_keys=("mnist", "fashion"))


def jnf_mnist_contour(cfg: ExperimentConfig) -> ModelBundle:
    """JMVAE-NF on MNIST image <-> Canny contour pairs
    (jmvae_nf/mnist_contour.py); both modalities scored by the MNIST
    classifier."""
    return ModelBundle(_jnf_mnist1ch(cfg, ("mnist", "contour"), cfg.num_hidden_layers),
                       _jnf_spec(cfg), "mnist_contour", "jmvae_nf_mnist_contour",
                       shape_mods=((1, 28, 28), (1, 28, 28)), classifier_keys=("mnist", "mnist"))


# ---------------------------------------------------------------------------
# Trimodal MNIST-SVHN-Fashion
# ---------------------------------------------------------------------------

_MSF = dict(shape_mods=((1, 28, 28), (3, 32, 32), (1, 28, 28)),
            classifier_keys=("mnist", "svhn", "fashion"))


def _msf_vaes(cfg, posterior=None, with_flow=False, encoders=None):
    """MLP VAEs for MNIST and Fashion, the conv VAE for SVHN; `encoders`
    replaces the three encoders (DCCA's TwoStepsEncoders)."""
    if encoders is None:
        encoders = [MLPEncoder(latent_dim=cfg.latent_dim, in_features=1 * 28 * 28),
                    EncoderSVHN(latent_dim=cfg.latent_dim),
                    MLPEncoder(latent_dim=cfg.latent_dim, in_features=1 * 28 * 28)]
    return [
        _vae(cfg, encoders[0], MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 28, 28)),
             "mnist", posterior=posterior, with_flow=with_flow),
        _vae(cfg, encoders[1], DecoderSVHN(latent_dim=cfg.latent_dim), "svhn",
             posterior=posterior, with_flow=with_flow),
        _vae(cfg, encoders[2], MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 28, 28)),
             "fashion", posterior=posterior, with_flow=with_flow),
    ]


def _msf_scaling(cfg, family: str = "mvae") -> Tuple[float, float, float]:
    """(r, 1, r) at llik_scaling 0, r = 3*32*32 / (28*28), for both
    families; otherwise (1, 1, 1) for MMVAE
    (mmvae/mnist_svhn_fashion.py:52) and (llik, 1, llik) for MVAE
    (mvae/msf.py:56)."""
    r = (3 * 32 * 32) / (28 * 28)
    if cfg.llik_scaling == 0:
        return (r, 1.0, r)
    if family == "mmvae":
        return (1.0, 1.0, 1.0)
    return (cfg.llik_scaling, 1.0, cfg.llik_scaling)


def _msf_recon_dists(cfg):
    return tuple(cfg.recon_losses) if len(cfg.recon_losses) == 3 else ("normal",) * 3


def mmvae_msf(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE on MNIST-SVHN-Fashion (mmvae/mnist_svhn_fashion.py)."""
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=_msf_recon_dists(cfg), lik_scaling=_msf_scaling(cfg, "mmvae"))
    return ModelBundle(MMVAE(_msf_vaes(cfg), posterior=cfg.dist), spec, "mnist_svhn_fashion",
                       "mmvae_msf", **_MSF)


def jnf_msf(cfg: ExperimentConfig) -> ModelBundle:
    """Trimodal JMVAE-NF(-DCCA) (jmvae_nf/mnist_svhn_fashion.py:50-88): a
    MultipleHeadJoint over three 20-wide heads. With `dcca`, the three raw
    DCCA trunks behind the identity projection, no linear CCA
    (main_mnist_svhn_fashion.py:180), under TwoStepsEncoders. Likelihood
    scaling (1, 1, 1) whatever the config (mnist_svhn_fashion.py:88).
    TELBO's unimodal VAEs take the squared error for all three modalities
    (vae_model_adapted.py:104-124): the JAX package's spec names two, so
    that its m_telbo_nf stops with an IndexError past warmup here."""
    joint = MultipleHeadJoint(
        [MLPEncoder(latent_dim=20, in_features=1 * 28 * 28), EncoderSVHN(latent_dim=20),
         MLPEncoder(latent_dim=20, in_features=1 * 28 * 28)],
        latent_dim=cfg.latent_dim, hidden_dim=512, in_features=3 * 20,
        num_hidden_layers=cfg.num_hidden_layers)
    dcca, encoders = None, None
    if cfg.dcca:
        dcca = _dcca_pair(cfg, dcca_encoders_msf, 16, None, fitted_lcca=False)
        encoders = [TwoStepsEncoder(d, latent_dim=cfg.latent_dim, in_features=cfg.dim_dcca)
                    for d in dcca]
    model = JMVAE_NF(joint, _msf_vaes(cfg, "normal", True, encoders), posterior=cfg.dist,
                     dcca_encoders=dcca)
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior=cfg.dist,
                     recon_dists=_msf_recon_dists(cfg), lik_scaling=(1.0, 1.0, 1.0),
                     vae_recon_losses=("mse",) * 3, no_recon=cfg.no_recon,
                     linear_warmup=cfg.linear_warmup)
    return ModelBundle(model, spec, "mnist_svhn_fashion", "jmvae_nf_msf", **_MSF)


def mvae_msf(cfg: ExperimentConfig) -> ModelBundle:
    """Trimodal MVAE with subset subsampling, one 2-subset a step (mvae/msf.py)."""
    model = MVAE(_msf_vaes(cfg, "normal"), lik_scaling=_msf_scaling(cfg), subsampling=True,
                 k_subsample=1)
    spec = ModelSpec(latent_dim=cfg.latent_dim, posterior="normal",
                     recon_dists=("normal",) * 3, lik_scaling=_msf_scaling(cfg))
    return ModelBundle(model, spec, "mnist_svhn_fashion", "mvae_msf", **_MSF)


# ---------------------------------------------------------------------------
# MedMNIST (pneumonia <-> blood), chest-X-ray <-> SVHN, CelebA: ResNet nets
# ---------------------------------------------------------------------------

_MEDMNIST = dict(shape_mods=((1, 28, 28), (3, 28, 28)), classifier_keys=("pneumonia", "blood"))


def _medmnist_vaes(cfg, posterior=None, with_flow=False, encoders=None):
    """MedMNIST ResNet VAEs for pneumonia (1x28x28) and blood (3x28x28);
    `encoders` replaces the ResNet encoders (DCCA's TwoStepsEncoders)."""
    if encoders is None:
        encoders = [medmnist_encoder(cfg.latent_dim, 1), medmnist_encoder(cfg.latent_dim, 3)]
    return [_vae(cfg, enc, medmnist_decoder(cfg.latent_dim, c), name, posterior=posterior,
                 with_flow=with_flow)
            for enc, c, name in zip(encoders, (1, 3), ("pneumonia", "blood"))]


def _medmnist_scaling(cfg) -> Tuple[float, float]:
    """modalities/medmnist.py:31: (3, 1) at llik_scaling 0, else (1, 1). It
    holds for MMVAE and MVAE only: JMVAE-NF's constructor runs after it and
    sets (1, 1) (jmvae_nf.py:29, jmvae_nf/medmnist.py:37-40)."""
    return (3.0, 1.0) if cfg.llik_scaling == 0 else (1.0, 1.0)


def _medmnist_spec(cfg, posterior) -> ModelSpec:
    return ModelSpec(latent_dim=cfg.latent_dim, posterior=posterior,
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=_medmnist_scaling(cfg))


def mmvae_medmnist(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE on MedMNIST (mmvae/medmnist.py): ResNet VAEs."""
    return ModelBundle(MMVAE(_medmnist_vaes(cfg), posterior=cfg.dist),
                       _medmnist_spec(cfg, cfg.dist), "medmnist", "mmvae_medmnist", **_MEDMNIST)


def _jnf_dcca_encoders(cfg, builders, dataset: str, dim_first: int):
    """JMVAE-NF-DCCA's DCCA trunks (from the dataset's artifact where there
    is one) and the unimodal TwoStepsEncoders on them."""
    dcca = _dcca_pair(cfg, builders, dim_first, _load_dcca_artifacts(cfg, dataset))
    return dcca, [TwoStepsEncoder(d, latent_dim=cfg.latent_dim, in_features=cfg.dim_dcca)
                  for d in dcca]


def jnf_medmnist(cfg: ExperimentConfig) -> ModelBundle:
    """JMVAE-NF(-DCCA) on MedMNIST (jmvae_nf/medmnist.py): a joint encoder
    on two 20-wide ResNet heads; with `dcca`, the ResNet DCCA trunks under
    TwoStepsEncoders (modalities/medmnist.py:48-56). Likelihood scaling
    (1, 1), as `_medmnist_scaling` says."""
    joint = DoubleHeadJoint([medmnist_encoder(20, 1), medmnist_encoder(20, 3)],
                            latent_dim=cfg.latent_dim, hidden_dim=512, in_features=20 + 20,
                            num_hidden_layers=cfg.num_hidden_layers)
    dcca, encoders = (_jnf_dcca_encoders(cfg, dcca_encoders_medmnist, "medmnist", 16)
                      if cfg.dcca else (None, None))
    model = JMVAE_NF(joint, _medmnist_vaes(cfg, "normal", True, encoders), posterior=cfg.dist,
                     dcca_encoders=dcca)
    return ModelBundle(model, _jnf_spec(cfg), "medmnist", "jmvae_nf_medmnist", **_MEDMNIST)


def mvae_medmnist(cfg: ExperimentConfig) -> ModelBundle:
    """MVAE on MedMNIST (mvae/medmnist.py): ResNet VAEs, normal posteriors."""
    model = MVAE(_medmnist_vaes(cfg, "normal"), lik_scaling=_medmnist_scaling(cfg))
    return ModelBundle(model, _medmnist_spec(cfg, "normal"), "medmnist", "mvae_medmnist",
                       **_MEDMNIST)


def jnf_chest_svhn(cfg: ExperimentConfig) -> ModelBundle:
    """JMVAE-NF on chest-X-ray <-> SVHN (jmvae_nf/chest_svhn.py): the
    MedMNIST ResNet for the X-ray, the SVHN conv nets for the digit. The
    utilities' scaling (3*32*32/(28*28), 1) is overwritten by JMVAE-NF's
    constructor to (1, 1) (chest_svhn.py:41-44), as executed here."""
    joint = DoubleHeadJoint([medmnist_encoder(20, 1), EncoderSVHN(latent_dim=20)],
                            latent_dim=cfg.latent_dim, hidden_dim=512, in_features=20 + 20,
                            num_hidden_layers=cfg.num_hidden_layers)
    vaes = [
        _vae(cfg, medmnist_encoder(cfg.latent_dim, 1), medmnist_decoder(cfg.latent_dim, 1),
             "chest", posterior="normal", with_flow=True),
        _vae(cfg, EncoderSVHN(latent_dim=cfg.latent_dim), DecoderSVHN(latent_dim=cfg.latent_dim),
             "svhn", posterior="normal", with_flow=True),
    ]
    return ModelBundle(JMVAE_NF(joint, vaes, posterior=cfg.dist), _jnf_spec(cfg), "chest_svhn",
                       "jmvae_nf_chest_svhn", shape_mods=((1, 28, 28), (3, 32, 32)),
                       classifier_keys=("pneumonia", "svhn"))


_CELEBA = dict(shape_mods=((3, 64, 64), (1, 1, 40)), classifier_keys=("celeba_img", "celeba_attr"))
_CELEBA_R = (3 * 64 * 64) / 40.0  # the image's size over the attribute vector's


def _celeba_vaes(cfg, posterior=None, with_flow=False, encoders=None):
    """The image's ResNet VAE (jmvae_nf/celeba.py:23, pythae's nets) and the
    attributes' MLP VAE over the 1x1x40 tensor (datasets.py:419);
    `encoders` replaces both encoders (DCCA's TwoStepsEncoders)."""
    if encoders is None:
        encoders = [celeba_encoder(cfg.latent_dim),
                    MLPEncoder(latent_dim=cfg.latent_dim, in_features=40)]
    return [
        _vae(cfg, encoders[0], celeba_decoder(cfg.latent_dim), "celeb", posterior=posterior,
             with_flow=with_flow),
        _vae(cfg, encoders[1], MLPDecoder(latent_dim=cfg.latent_dim, output_shape=(1, 1, 40)),
             "attributes", posterior=posterior, with_flow=with_flow),
    ]


def _celeba_spec(cfg, posterior, lik_scaling, **kw) -> ModelSpec:
    return ModelSpec(latent_dim=cfg.latent_dim, posterior=posterior,
                     recon_dists=tuple(cfg.recon_losses), lik_scaling=lik_scaling, **kw)


def mmvae_celeba(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE on CelebA (mmvae_celeba.py:60): at llik_scaling 0 the
    ATTRIBUTES' reconstruction is weighted up, (1, image/attributes)."""
    ls = (1.0, _CELEBA_R) if cfg.llik_scaling == 0 else (cfg.llik_scaling, 1.0)
    return ModelBundle(MMVAE(_celeba_vaes(cfg), posterior=cfg.dist),
                       _celeba_spec(cfg, cfg.dist, ls), "celeba", "mmvae_celeba", **_CELEBA)


def jnf_celeba(cfg: ExperimentConfig) -> ModelBundle:
    """JMVAE-NF(-DCCA) on CelebA (jmvae_nf/celeba.py:62-101): a joint
    encoder of hidden width 1024 on a 128-wide ResNet image head and a
    40-wide MLP attribute head; with `dcca`, the DCCA trunks (ResNet image,
    MLP attributes, LCCA latent 40) under TwoStepsEncoders. Scaling
    (attributes/image, 1) at llik_scaling 0."""
    joint = DoubleHeadJoint([celeba_encoder(128), MLPEncoder(latent_dim=40, in_features=40)],
                            latent_dim=cfg.latent_dim, hidden_dim=1024, in_features=128 + 40,
                            num_hidden_layers=cfg.num_hidden_layers)
    dcca, encoders = (_jnf_dcca_encoders(cfg, dcca_encoders_celeba, "celeba", 40)
                      if cfg.dcca else (None, None))
    model = JMVAE_NF(joint, _celeba_vaes(cfg, "normal", True, encoders), posterior=cfg.dist,
                     dcca_encoders=dcca)
    ls = (1.0 / _CELEBA_R, 1.0) if cfg.llik_scaling == 0 else (cfg.llik_scaling, 1.0)
    spec = _celeba_spec(cfg, cfg.dist, ls, no_recon=cfg.no_recon,
                        linear_warmup=cfg.linear_warmup)
    return ModelBundle(model, spec, "celeba", "jmvae_nf_celeba", **_CELEBA)


def mvae_celeba(cfg: ExperimentConfig) -> ModelBundle:
    """MVAE on CelebA (mvae/celeba.py:47): (1, 50) at llik_scaling 0, the
    paper's setting, else (1, llik_scaling)."""
    ls = (1.0, 50.0) if cfg.llik_scaling == 0 else (1.0, cfg.llik_scaling)
    return ModelBundle(MVAE(_celeba_vaes(cfg, "normal"), lik_scaling=ls),
                       _celeba_spec(cfg, "normal", ls), "celeba", "mvae_celeba", **_CELEBA)


def moepoe_celeba(cfg: ExperimentConfig) -> ModelBundle:
    """MoE-PoE on CelebA (moepoe/celeba.py:60): (attributes/image, 1) at
    llik_scaling 0, else (1, llik_scaling); the KL weight is beta_kl."""
    ls = (1.0 / _CELEBA_R, 1.0) if cfg.llik_scaling == 0 else (1.0, cfg.llik_scaling)
    model = MOEPOE(_celeba_vaes(cfg, "normal"), lik_scaling=ls,
                   recon_dists=tuple(cfg.recon_losses), beta_kl=cfg.beta_kl)
    return ModelBundle(model, _celeba_spec(cfg, "normal", ls), "celeba", "moepoe_celeba",
                       **_CELEBA)


def mmvae_nf_celeba(cfg: ExperimentConfig) -> ModelBundle:
    """MMVAE-NF on CelebA (mmvae_nf/celeba.py:59): flow VAEs, normal
    posteriors, (1, image/attributes) at llik_scaling 0, else
    (1, llik_scaling)."""
    ls = (1.0, _CELEBA_R) if cfg.llik_scaling == 0 else (1.0, cfg.llik_scaling)
    return ModelBundle(MMVAE_NF(_celeba_vaes(cfg, "normal", True)),
                       _celeba_spec(cfg, "normal", ls), "celeba", "mmvae_nf_celeba", **_CELEBA)


REGISTRY: Dict[str, Callable[[ExperimentConfig], ModelBundle]] = {
    "mnist_svhn": mnist_svhn,
    "circles_squares": circles_squares,
    "jnf_circles_squares": jnf_circles_squares,
    "mnist_fashion": mnist_fashion,
    "jnf_mnist_fashion": jnf_mnist_fashion,
    "jnf_mnist_contour": jnf_mnist_contour,
    "mmvae_nf_mnist_svhn": mmvae_nf_mnist_svhn,
    "jnf_mnist_svhn_dcca": jnf_mnist_svhn_dcca,
    "mvae_mnist_svhn": mvae_mnist_svhn,
    "moepoe_mnist_svhn": moepoe_mnist_svhn,
    "mmvae_medmnist": mmvae_medmnist,
    "jnf_medmnist": jnf_medmnist,
    "mvae_medmnist": mvae_medmnist,
    "jnf_chest_svhn": jnf_chest_svhn,
    "mmvae_celeba": mmvae_celeba,
    "jnf_celeba": jnf_celeba,
    "mvae_celeba": mvae_celeba,
    "moepoe_celeba": moepoe_celeba,
    "mmvae_nf_celeba": mmvae_nf_celeba,
    "jnf_msf": jnf_msf,
    "mmvae_msf": mmvae_msf,
    "mvae_msf": mvae_msf,
}


def build(cfg: ExperimentConfig) -> ModelBundle:
    """getattr(models, 'VAE_'+args.model)(args) equivalent (main.py:70-71)."""
    if cfg.model not in REGISTRY:
        raise NotImplementedError(f"model {cfg.model!r} not yet ported")
    return REGISTRY[cfg.model](cfg)
