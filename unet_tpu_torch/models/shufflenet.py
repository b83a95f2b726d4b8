"""ShuffleNetV2 x1.0 feature encoder (counterpart of
unet_tpu/models/shufflenet.py; reference unetpp_lightweight.py:152-160,
211-217).

torchvision's layout and keys: `conv1` = Sequential(conv, bn, relu), then
`stage2` ... `stage4` of inverted-residual units with `branch1` (stride 2
only) and `branch2`. As in the reference's forward, stage4 is max-pooled
once more (a fifth stage at stride 64), and conv5 never runs, so the last
stages are 464 wide. NCHW.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.models.blocks import BatchNorm2d, max_pool2

STAGE_REPEATS = (4, 8, 4)
STAGE_CHANNELS = (116, 232, 464)  # x1.0


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave `groups` channel groups of (B, C, H, W): output channel
    j * groups + g is input channel g * C / groups + j, the permutation of
    the JAX package's NHWC reshape-swap (unet_tpu/models/shufflenet.py:25-31)
    and torchvision's."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _dw(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, groups=c, bias=False)


class _Unit(nn.Module):
    """The ShuffleNetV2 inverted-residual unit (shufflenet.py:43-79): stride
    1 splits the channels in halves and runs branch2 on the second; stride 2
    runs branch1 and branch2 on the whole input. Then the channel shuffle."""

    def __init__(self, cin: int, out_channels: int, stride: int):
        super().__init__()
        half = out_channels // 2
        self.stride = stride
        if stride > 1:
            self.branch1 = nn.Sequential(_dw(cin, stride), BatchNorm2d(cin),
                                         nn.Conv2d(cin, half, 1, bias=False),
                                         BatchNorm2d(half), nn.ReLU())
        self.branch2 = nn.Sequential(
            nn.Conv2d(cin if stride > 1 else half, half, 1, bias=False), BatchNorm2d(half),
            nn.ReLU(), _dw(half, stride), BatchNorm2d(half),
            nn.Conv2d(half, half, 1, bias=False), BatchNorm2d(half), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            left, right = x.chunk(2, dim=1)
            out = torch.cat([left, self.branch2(right)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


class ShuffleNetV2Encoder(nn.Module):
    """Five stages (shufflenet.py:82-105): conv1 (/2, 24) and max pool (/4),
    stage2 (/8, 116), stage3 (/16, 232), stage4 (/32, 464), and the extra
    2x2 max pool (/64, 464)."""
    out_channels = (24,) + STAGE_CHANNELS + (STAGE_CHANNELS[-1],)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(3, 24, 3, 2, 1, bias=False), BatchNorm2d(24),
                                   nn.ReLU())
        cin = 24
        for s, (reps, ch) in enumerate(zip(STAGE_REPEATS, STAGE_CHANNELS)):
            setattr(self, f"stage{s + 2}", nn.Sequential(
                *[_Unit(cin if i == 0 else ch, ch, 2 if i == 0 else 1) for i in range(reps)]))
            cin = ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x0 = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x1 = self.stage2(x0)
        x2 = self.stage3(x1)
        x3 = self.stage4(x2)
        return x0, x1, x2, x3, max_pool2(x3)
