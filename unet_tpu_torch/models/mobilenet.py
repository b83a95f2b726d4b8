"""MobileNetV3 Small/Large feature encoders (counterpart of
unet_tpu/models/mobilenet.py; reference unetpp_lightweight.py:122-151,
which slices torchvision's mobilenet_v3_{small,large}.features into five
stages).

The modules keep torchvision's layout, `features.N` and
`features.N.block.M` (Conv2dNormActivation as Sequential(conv, bn, act),
squeeze-excitation with `fc1`/`fc2`), so a torchvision state dict loads into
the encoder as it is (models.convert.mobilenet_encoder_state_dict, the
counterpart of the JAX package's convert_mobilenet_encoder). BatchNorm is
torchvision's MobileNetV3 one: eps 1e-3. NCHW.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.models.blocks import BatchNorm2d


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (kernel, expanded, out, use_se, activation, stride) per features[i], i >= 1
SMALL_SPEC = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hs", 2),
    (5, 240, 40, True, "hs", 1),
    (5, 240, 40, True, "hs", 1),
    (5, 120, 48, True, "hs", 1),
    (5, 144, 48, True, "hs", 1),
    (5, 288, 96, True, "hs", 2),
    (5, 576, 96, True, "hs", 1),
    (5, 576, 96, True, "hs", 1),
]
SMALL_LAST = 576
# the reference's stage split: features[:2], [2:4], [4:7], [7:9], [9:]
SMALL_STAGES = (2, 4, 7, 9)

LARGE_SPEC = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hs", 2),
    (3, 200, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1),
    (3, 480, 112, True, "hs", 1),
    (3, 672, 112, True, "hs", 1),
    (5, 672, 160, True, "hs", 2),
    (5, 960, 160, True, "hs", 1),
    (5, 960, 160, True, "hs", 1),
]
LARGE_LAST = 960
LARGE_STAGES = (2, 4, 7, 9)

_ACTS = {"hs": nn.Hardswish, "relu": nn.ReLU}


class _CNA(nn.Sequential):
    """Conv2dNormActivation: conv (no bias), BN (eps 1e-3), activation
    (`none`: no activation)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                 activation: str = "hs"):
        layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups,
                            bias=False),
                  BatchNorm2d(cout, eps=1e-3, momentum=0.01)]
        if activation != "none":
            layers.append(_ACTS[activation]())
        super().__init__(*layers)


class _SE(nn.Module):
    """Squeeze-excitation (torchvision's): spatial mean, fc1, ReLU, fc2,
    hard sigmoid, times the input."""

    def __init__(self, channels: int):
        super().__init__()
        squeeze = _make_divisible(channels // 4)
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))


class _InvertedResidual(nn.Module):
    """expand (where the width changes), depthwise, squeeze-excitation,
    project; the residual where the stride is 1 and the width is kept."""

    def __init__(self, cin: int, kernel: int, expanded: int, out: int, use_se: bool,
                 activation: str, stride: int):
        super().__init__()
        layers: List[nn.Module] = []
        if expanded != cin:
            layers.append(_CNA(cin, expanded, 1, activation=activation))
        layers.append(_CNA(expanded, expanded, kernel, stride, groups=expanded,
                           activation=activation))
        if use_se:
            layers.append(_SE(expanded))
        layers.append(_CNA(expanded, out, 1, activation="none"))
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return y + x if self.use_res else y


class MobileNetV3Encoder(nn.Module):
    """Five-stage feature pyramid (unet_tpu/models/mobilenet.py:134-161), cut
    after features[idx] where idx + 1 is in the variant's stage table:
    small -> (16, 24, 40, 48, 576) at strides (4, 8, 16, 16, 32), large ->
    (16, 24, 40, 80, 960) at strides (2, 4, 8, 16, 32)."""

    def __init__(self, variant: str = "small"):
        super().__init__()
        spec, last, self.cuts = ((SMALL_SPEC, SMALL_LAST, SMALL_STAGES) if variant == "small"
                                 else (LARGE_SPEC, LARGE_LAST, LARGE_STAGES))
        layers: List[nn.Module] = [_CNA(3, 16, 3, 2, activation="hs")]
        cin, chans = 16, [16] if 1 in self.cuts else []
        for i, cfg in enumerate(spec):
            layers.append(_InvertedResidual(cin, *cfg))
            cin = cfg[2]
            if i + 2 in self.cuts:
                chans.append(cin)
        layers.append(_CNA(cin, last, 1, activation="hs"))
        self.features = nn.Sequential(*layers)
        self.out_channels = tuple(chans + [last])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx + 1 in self.cuts:
                feats.append(x)
        feats.append(x)
        return tuple(feats)
