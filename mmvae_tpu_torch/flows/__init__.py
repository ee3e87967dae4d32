from .made import MADE, MaskedDense, build_masks  # noqa: F401
from .layers import BatchNormFlow  # noqa: F401
from .autoregressive import IAF, MAF  # noqa: F401
from .linear import LinearNF, PlanarFlow, RadialFlow  # noqa: F401
