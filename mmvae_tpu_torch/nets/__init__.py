from .conv import Conv2d, ConvTranspose2d, Linear, init_parameters  # noqa: F401
from .encoders import (  # noqa: F401
    DecoderSVHN, EncoderSVHN, MLPDecoder, MLPEncoder, TwoStepsEncoder,
)
from .joint_encoders import (  # noqa: F401
    DoubleHeadJoint, DoubleHeadMLP, JointMLPEncoder, MultipleHeadJoint,
)
