"""Building blocks of the UNet family (counterpart of
unet_tpu/models/blocks.py), NCHW; `ComputeDtype`, the compute type of every
model of the port; and `fp32_convs`, the cuDNN precision pin of the float32
forwards."""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call


class ComputeDtype(nn.Module):
    """A model whose `dtype` is its compute type, as flax's `dtype` is: the
    parameters stay float32, and a forward in another type runs on copies of
    them (and of the BN statistics) cast to it, input included. Subclasses
    write `compute(x)`; `forward` casts and calls it."""

    dtype: torch.dtype = torch.float32

    def forward(self, x: torch.Tensor):
        if next(self.parameters()).dtype != self.dtype:   # not yet inside the cast call
            state = {k: v.to(self.dtype) if v.is_floating_point() else v
                     for k, v in self.state_dict().items()}
            return functional_call(self, state, (x.to(self.dtype),))
        return self.compute(x)

    def compute(self, x: torch.Tensor):
        raise NotImplementedError


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


class DoubleConv(nn.Sequential):
    """conv3x3 -> ReLU, twice, no BN: SimpleUNet's block (counterpart of
    unet_tpu/models/blocks.py:33-44; reference src/models/simple_unet.py:31-38),
    with the reference's keys `0` and `2`."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(cout, cout, 3, padding=1), nn.ReLU())


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
