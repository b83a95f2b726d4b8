"""Models of the port: NestedUNet (custom encoder), its BN-folded fast
forward (fast_forward) and calibrated int8 forward (quantized), and the
flax -> torch weight converter."""

from unet_tpu_torch.models.unetpp import NestedUNet  # noqa: F401
