"""Models of the port: NestedUNet (custom or ResNet50 encoder), SimpleUNet,
LightweightNestedUNet with its six encoders, NestedUNet's BN-folded fast
forward (fast_forward) and calibrated int8 forward (quantized), and the
weight converters (convert)."""

from unet_tpu_torch.models.unetpp import NestedUNet  # noqa: F401
from unet_tpu_torch.models.simple_unet import SimpleUNet  # noqa: F401
from unet_tpu_torch.models.unetpp_lightweight import (  # noqa: F401
    ENCODER_CHANNELS, LightweightNestedUNet, create_lightweight_unet)
