from .mmvae_nf import MMVAE_NF  # noqa: F401
from .vae import UnimodalVAE  # noqa: F401
