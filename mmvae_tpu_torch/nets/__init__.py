from .conv import Conv2d, ConvTranspose2d, Linear, init_parameters  # noqa: F401
from .encoders import DecoderSVHN, EncoderSVHN, MLPDecoder, MLPEncoder  # noqa: F401
