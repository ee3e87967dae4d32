from .jmvae_nf import JMVAE_NF  # noqa: F401
from .mmvae import MMVAE  # noqa: F401
from .mmvae_nf import MMVAE_NF  # noqa: F401
from .moepoe import MOEPOE  # noqa: F401
from .mvae import MVAE  # noqa: F401
from .vae import UnimodalVAE  # noqa: F401
