"""ResNet encoders with torchvision's topology and key layout (counterpart
of unet_tpu/models/resnet.py; reference src/models/unetpp.py:56-66,
src/models/unetpp_lightweight.py:164-177).

Blocks keep torchvision's names (`conv1`, `bn1`, ..., `downsample.0`,
`downsample.1`), BatchNorm eps 1e-5, so torchvision and reference state
dicts load as they are. NCHW.

On H stripes (`striped`, eval mode; models.blocks.on_stripes): each 3x3
conv on its halo slab (1 row at stride 1, 2 at stride 2), the stem's 7x7/2
conv on 4 and its 3x3/2 max pool on 2, the 1x1 convs (the shortcut's
projection at stride 2 too), BatchNorm, ReLU and the residual add
row-local.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.models.blocks import BatchNorm2d, on_stripes, striped_op


def _projection(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    """resnet18/34 block: 3x3 -> 3x3 with an identity or projection
    shortcut."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = _projection(cin, features, stride) if project else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + r)

    def striped(self, x: torch.Tensor, st) -> torch.Tensor:
        r = x if self.downsample is None else on_stripes(self.downsample, x, st)
        y = F.relu(self.bn1(on_stripes(self.conv1, x, st)))
        return F.relu(self.bn2(on_stripes(self.conv2, y, st)) + r)


class Bottleneck(nn.Module):
    """resnet50 block: 1x1 -> 3x3 (stride) -> 1x1 (x4) with a shortcut."""
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1, project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = _projection(cin, width * 4, stride) if project else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + r)

    def striped(self, x: torch.Tensor, st) -> torch.Tensor:
        r = x if self.downsample is None else on_stripes(self.downsample, x, st)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(on_stripes(self.conv2, y, st)))
        return F.relu(self.bn3(self.conv3(y)) + r)


def stem() -> nn.Sequential:
    """conv 7x7/2, BN, ReLU, max pool 3x3/2 with padding 1 (torchvision's
    stem), as one Sequential: the reference's `conv0_0` layout."""
    return nn.Sequential(nn.Conv2d(3, 64, 7, 2, 3, bias=False), BatchNorm2d(64),
                         nn.ReLU(), nn.MaxPool2d(3, 2, 1))


def stage(block, cin: int, n_blocks: int, features: int, stride: int,
          first_project: bool = True) -> nn.Sequential:
    """One torchvision `layerN`. torchvision projects the shortcut only where
    the stride or the channel count changes, so resnet18/34's layer1 has no
    projection (`first_project=False`)."""
    cout = features * block.expansion
    return nn.Sequential(*[block(cin if i == 0 else cout, features, stride if i == 0 else 1,
                                 project=(i == 0 and first_project)) for i in range(n_blocks)])


def resnet50_stages() -> Tuple[nn.Module, ...]:
    """The five feature stages of ResNet50Encoder (unet_tpu/models/resnet.py:
    100-119): the stem (maxpool included) and layer1-4, with channels (64,
    256, 512, 1024, 2048) at strides (4, 4, 8, 16, 32). NestedUNet keeps them
    as `conv0_0` ... `conv4_0`, the reference's keys."""
    return (stem(), stage(Bottleneck, 64, 3, 64, 1), stage(Bottleneck, 256, 4, 128, 2),
            stage(Bottleneck, 512, 6, 256, 2), stage(Bottleneck, 1024, 3, 512, 2))


class ResNetBasicEncoder(nn.Module):
    """resnet18 (layers (2, 2, 2, 2)) or resnet34 ((3, 4, 6, 3)) stages for
    LightweightNestedUNet (unet_tpu/models/resnet.py:122-137), torchvision's
    keys: `conv1`, `bn1`, `layer1` ... `layer4`. Returns the stem's output
    (after its max pool) and the four layers' outputs: channels (64, 64,
    128, 256, 512) at strides (4, 4, 8, 16, 32)."""
    out_channels = (64, 64, 128, 256, 512)

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        l1, l2, l3, l4 = layers
        self.layer1 = stage(BasicBlock, 64, l1, 64, 1, first_project=False)
        self.layer2 = stage(BasicBlock, 64, l2, 128, 2)
        self.layer3 = stage(BasicBlock, 128, l3, 256, 2)
        self.layer4 = stage(BasicBlock, 256, l4, 512, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x0 = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        return x0, x1, x2, x3, self.layer4(x3)

    def striped(self, x: torch.Tensor, st) -> Tuple[torch.Tensor, ...]:
        y = F.relu(self.bn1(on_stripes(self.conv1, x, st)))
        x0 = striped_op(lambda t: F.max_pool2d(t, 3, 2, 1), y, st, 3, 2, 1)
        x1 = on_stripes(self.layer1, x0, st)
        x2 = on_stripes(self.layer2, x1, st)
        x3 = on_stripes(self.layer3, x2, st)
        return x0, x1, x2, x3, on_stripes(self.layer4, x3, st)
