"""Deep CCA pretraining of the JMVAE-NF-DCCA trunks (mmvae_tpu/dcca)."""

from .linear_cca import LinearCCA  # noqa: F401
from .nets import DCCA_BUILDERS, DeepCCA, LCCAWrappedEncoder, identity_lcca  # noqa: F401
from .objectives import cca_corr, cca_corr_chol, cca_loss, cca_loss_chol, mcca_loss  # noqa: F401
