"""Color-space conversions (counterpart of unet_tpu/ops/color.py:16-40).

Float32 arithmetic runs in the reference's left-to-right order, with each
weight rounded to float32, so float results are bit-identical; integer
inputs are rounded like cv2.
"""
from __future__ import annotations

import torch

# ITU-R BT.601 luma weights, identical to OpenCV's RGB2GRAY constants.
_R_W, _G_W, _B_W = 0.299, 0.587, 0.114


def bgr2rgb(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> RGB (pure channel flip)."""
    return img.flip(-1)


def rgb2gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) luma, cv2.COLOR_RGB2GRAY semantics:
    float32 arithmetic, rounded iff the input is an integer type."""
    r, g, b = (img[..., i].to(torch.float32) for i in range(3))
    gray = _R_W * r + _G_W * g + _B_W * b
    if not img.dtype.is_floating_point:
        return torch.round(gray).to(img.dtype)
    return gray.to(img.dtype)


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> luma (cv2.COLOR_BGR2GRAY)."""
    return rgb2gray(bgr2rgb(img))
