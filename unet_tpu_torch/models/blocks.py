"""Building blocks of the UNet family (counterpart of
unet_tpu/models/blocks.py:14-30, 47-49), NCHW."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBlock(nn.Module):
    """conv3x3 -> BN -> ReLU, twice — the reference's basic block
    (reference src/models/unetpp.py:13-26); BatchNorm eps 1e-5."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (torch nn.MaxPool2d(2, 2))."""
    return F.max_pool2d(x, 2, 2)
