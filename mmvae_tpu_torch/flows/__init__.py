from .autoregressive import IAF, MAF  # noqa: F401
from .made import MADE, MaskedDense, build_masks  # noqa: F401
