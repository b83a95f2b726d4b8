"""SimpleUNet, the legacy-checkpoint plain U-Net without BatchNorm
(counterpart of unet_tpu/models/simple_unet.py; reference
src/models/simple_unet.py:20-128).

enc1-4 double convs (64..512) with 2x2/2 max pools, ConvTranspose2d(k=2,
s=2) upsamples, `[up, skip]` concatenation (NestedUNet's is `[skip, up]`),
dec3-1 and a final 1x1 conv; logits at the input's size. State-dict keys are
the reference's (`enc1.0.weight`, `up3.weight`, `dec3.2.bias`, ...), so the
7-class checkpoint family loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from unet_tpu_torch.models.blocks import ComputeDtype, DoubleConv, max_pool2


class SimpleUNet(ComputeDtype):
    """`dtype` is the compute type (models.blocks.ComputeDtype)."""

    def __init__(self, num_classes: int = 7, num_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc1 = DoubleConv(num_channels, 64)
        self.enc2 = DoubleConv(64, 128)
        self.enc3 = DoubleConv(128, 256)
        self.enc4 = DoubleConv(256, 512)
        self.up3 = nn.ConvTranspose2d(512, 256, 2, 2)
        self.up2 = nn.ConvTranspose2d(256, 128, 2, 2)
        self.up1 = nn.ConvTranspose2d(128, 64, 2, 2)
        self.dec3 = DoubleConv(512, 256)
        self.dec2 = DoubleConv(256, 128)
        self.dec1 = DoubleConv(128, 64)
        self.final = nn.Conv2d(64, num_classes, 1)
        self.dtype = dtype

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool2(e1))
        e3 = self.enc3(max_pool2(e2))
        e4 = self.enc4(max_pool2(e3))
        d3 = self.dec3(torch.cat([self.up3(e4), e3], 1))
        d2 = self.dec2(torch.cat([self.up2(d3), e2], 1))
        d1 = self.dec1(torch.cat([self.up1(d2), e1], 1))
        return self.final(d1)
