"""UNet++ ("NestedUNet"), custom encoder (counterpart of
unet_tpu/models/unetpp.py:38-95; reference src/models/unetpp.py:29-135).

As in the reference, the decoder is a plain U-Net chain
(x3_1 -> x2_2 -> x1_3 -> x0_4) with `[skip, up]` concatenation and a
bilinear x2 align-corners upsample. State-dict keys are the reference's
(`conv0_0.conv1.weight`, ..., `final.weight`), so a reference `.pth` loads
with `load_state_dict`, and `models.convert.state_dict_from_flax` carries
the JAX package's weights across.
"""
from __future__ import annotations

from typing import List, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from unet_tpu_torch.models.blocks import ConvBlock, max_pool2

NB_FILTER = (32, 64, 128, 256, 512)


class NestedUNet(nn.Module):
    """Args mirror the reference constructor (src/models/unetpp.py:40-46).
    In eval mode the forward returns the (B, num_classes, H, W) logits; in
    train mode with deep supervision, [out, ds1_3, ds2_2, ds3_1].

    `dtype` is the compute type, as flax's `dtype` is
    (unet_tpu/models/unetpp.py:44): the parameters stay float32, and a
    forward in another type runs on copies of them cast to it, input
    included. The BN-folded and int8 forwards (models/fast_forward.py,
    models/quantized.py) read the float32 parameters and compute in
    `dtype`."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = True, pretrained_encoder: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pretrained_encoder:
            raise NotImplementedError(
                "the ResNet50 encoder is ROADMAP item A13 (other models)")
        self.deep_supervision = deep_supervision
        f = NB_FILTER
        self.conv0_0 = ConvBlock(input_channels, f[0])
        self.conv1_0 = ConvBlock(f[0], f[1])
        self.conv2_0 = ConvBlock(f[1], f[2])
        self.conv3_0 = ConvBlock(f[2], f[3])
        self.conv4_0 = ConvBlock(f[3], f[4])
        self.conv3_1 = ConvBlock(f[3] + f[4], f[3])
        self.conv2_2 = ConvBlock(f[2] + f[3], f[2])
        self.conv1_3 = ConvBlock(f[1] + f[2], f[1])
        self.conv0_4 = ConvBlock(f[0] + f[1], f[0])
        self.final = nn.Conv2d(f[0], num_classes, 1)
        if deep_supervision:
            self.ds3_1 = nn.Conv2d(f[3], num_classes, 1)
            self.ds2_2 = nn.Conv2d(f[2], num_classes, 1)
            self.ds1_3 = nn.Conv2d(f[1], num_classes, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        if self.final.weight.dtype != self.dtype:   # not yet inside the cast call
            state = {k: v.to(self.dtype) if v.is_floating_point() else v
                     for k, v in self.state_dict().items()}
            return functional_call(self, state, (x.to(self.dtype),))
        up = lambda t: F.interpolate(t, scale_factor=2, mode="bilinear",
                                     align_corners=True)
        x0_0 = self.conv0_0(x)
        x1_0 = self.conv1_0(max_pool2(x0_0))
        x2_0 = self.conv2_0(max_pool2(x1_0))
        x3_0 = self.conv3_0(max_pool2(x2_0))
        x4_0 = self.conv4_0(max_pool2(x3_0))
        x3_1 = self.conv3_1(torch.cat([x3_0, up(x4_0)], 1))
        x2_2 = self.conv2_2(torch.cat([x2_0, up(x3_1)], 1))
        x1_3 = self.conv1_3(torch.cat([x1_0, up(x2_2)], 1))
        x0_4 = self.conv0_4(torch.cat([x0_0, up(x1_3)], 1))
        out = self.final(x0_4)
        if self.deep_supervision and self.training:
            rs = lambda t: F.interpolate(t, size=x.shape[2:], mode="bilinear",
                                         align_corners=True)
            return [out, rs(self.ds1_3(x1_3)), rs(self.ds2_2(x2_2)),
                    rs(self.ds3_1(x3_1))]
        return out
