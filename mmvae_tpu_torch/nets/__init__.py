from .conv import (  # noqa: F401
    BatchNorm, BatchNorm2d, Conv2d, ConvTranspose2d, Dropout, Linear, init_parameters,
)
from .encoders import (  # noqa: F401
    DecoderMNIST, DecoderSVHN, EncoderMNIST, EncoderSVHN, MLPDecoder, MLPEncoder,
    TwoStepsEncoder,
)
from .joint_encoders import (  # noqa: F401
    DoubleHeadJoint, DoubleHeadMLP, JointMLPEncoder, MultipleHeadJoint,
)
