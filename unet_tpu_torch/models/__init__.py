"""Models of the port: NestedUNet (custom encoder) and the flax -> torch
weight converter."""

from unet_tpu_torch.models.unetpp import NestedUNet  # noqa: F401
