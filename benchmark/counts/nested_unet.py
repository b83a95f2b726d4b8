"""The NestedUNet's work counted from its shapes: its 18 3x3 convs and
the 1x1 head at a model input, and the inputs that the int8 forward hands
`qconv` (NHWC int8; a decoder block's first conv takes its skip and its
upsampled input as a pair, split along the input channels).

Operations are 2 x multiply-adds.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

from ..inputs import BLOCKS


class Conv(NamedTuple):
    name: str                   # e.g. "conv1_3.conv1"
    hw: Tuple[int, int]         # the plane it runs on
    cin: Tuple[int, ...]        # input widths: one source, or the (skip, up) pair
    cout: int
    k: int                      # kernel side


def convs(model: dict, model_hw: Tuple[int, int]) -> List[Conv]:
    """The 18 3x3 convs, in forward order, and the 1x1 `final` head."""
    f, h, w = model["nb_filter"], model_hw[0], model_hw[1]
    out = []
    for name, level, srcs in BLOCKS:
        widths = tuple(model["input_channels"] if s == "in" else f[s] for s in srcs)
        hw = (h >> level, w >> level)
        out.append(Conv(f"{name}.conv1", hw, widths, f[level], 3))
        out.append(Conv(f"{name}.conv2", hw, (f[level],), f[level], 3))
    out.append(Conv("final", (h, w), (f[0],), model["num_classes"], 1))
    return out


def ops(c: Conv, batch: int = 1) -> int:
    return 2 * batch * c.hw[0] * c.hw[1] * c.cout * c.k * c.k * sum(c.cin)


def frame_ops(model: dict, model_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(operations of the 18 3x3 convs, operations of the head) of one frame."""
    cs = convs(model, model_hw)
    return sum(ops(c) for c in cs if c.k == 3), sum(ops(c) for c in cs if c.k == 1)
