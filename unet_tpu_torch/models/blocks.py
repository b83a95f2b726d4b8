"""Building blocks of the UNet family (counterpart of
unet_tpu/models/blocks.py:14-30, 47-49), NCHW; and `fp32_convs`, the
cuDNN precision pin of the float32 forwards."""
from __future__ import annotations

import contextlib
import threading

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


# the cuDNN conv precision is process-wide: one forward sets and restores it
# at a time, so that concurrent forwards cannot leave it set
_precision_lock = threading.Lock()


@contextlib.contextmanager
def fp32_convs():
    """Run cuDNN's float32 convolutions in full fp32 inside the block,
    whatever the process-wide setting, which is restored on exit. PyTorch's
    default runs them in TF32 (10-bit mantissa), outside the gates the fp32
    forwards are held to. Only the per-operator API is used: mixing it with
    the legacy `allow_tf32` flag can raise. Blocks from several threads run
    one at a time (their launches; the card's work stays asynchronous).
    bf16 and int8 work inside the block is unaffected."""
    conv = torch.backends.cudnn.conv
    with _precision_lock:
        old = conv.fp32_precision
        conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision = old
