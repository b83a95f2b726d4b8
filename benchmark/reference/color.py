"""Frozen copy of the port's `ops/color.py`, run on its plain routes, for the
benchmark's reference; it imports nothing of the port.

Color-space conversions (counterpart of unet_tpu/ops/color.py:16-52,
59-119).

Float32 arithmetic runs in the reference's left-to-right order, with each
weight rounded to float32, so gray is bit-identical; integer inputs are
rounded like cv2. CIELAB goes through `pow`, whose last bit differs between
PyTorch and XLA, so Lab is equal within a stated tolerance
(tests/test_torch_enhance.py).
"""
from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# CIELAB (cv2 8-bit conventions: L in [0,255], a/b offset by 128)
# ---------------------------------------------------------------------------

# sRGB (linear, no gamma -- cv2's 8U path) -> XYZ, D65
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_XN, _ZN = 0.950456, 1.088754
_LAB_DELTA = 0.008856


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative float32 tensor as a float32 `pow`. XLA's
    `cbrt` is not correctly rounded, and this form matches it more often
    than a correctly rounded root does: over all 2**24 BGR colours, round(L)
    differs from the JAX package's for 104 colours with this form and for
    122 with a float64 root rounded to float32 (tests/torch_lab_sweep.py)."""
    return torch.pow(t, 1.0 / 3.0)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _LAB_DELTA, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92, torch.pow((x + 0.055) / 1.055, 2.4))


def _linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)


def _mix(m: np.ndarray, row: int, p, q, r) -> torch.Tensor:
    """m[row, 0] * p + m[row, 1] * q + m[row, 2] * r with float32 weights."""
    return float(m[row, 0]) * p + float(m[row, 1]) * q + float(m[row, 2]) * r


def bgr2lab(bgr: torch.Tensor):
    """cv2.COLOR_BGR2LAB for 8-bit inputs in float carriers; returns the
    (L, a, b) planes, L on 0-255, a/b offset by 128."""
    x = _srgb_to_linear(bgr.to(torch.float32) / 255.0)
    r, g, b = x[..., 2], x[..., 1], x[..., 0]
    X = _mix(_RGB2XYZ, 0, r, g, b) / _XN
    Y = _mix(_RGB2XYZ, 1, r, g, b)
    Z = _mix(_RGB2XYZ, 2, r, g, b) / _ZN
    fy = _lab_f(Y)
    L = torch.where(Y > _LAB_DELTA, 116.0 * _cbrt(Y) - 16.0, 903.3 * Y)
    a = 500.0 * (_lab_f(X) - fy) + 128.0
    bb = 200.0 * (fy - _lab_f(Z)) + 128.0
    return L * (255.0 / 100.0), a, bb


def lab2bgr(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse of bgr2lab (cv2.COLOR_LAB2BGR 8-bit): float BGR (..., 3) in
    [0, 255]."""
    Lp = L * (100.0 / 255.0)
    fy = (Lp + 16.0) / 116.0
    fx = fy + (a - 128.0) / 500.0
    fz = fy - (b - 128.0) / 200.0

    def finv(f):
        f3 = f * f * f
        return torch.where(f3 > _LAB_DELTA, f3, (f - 16.0 / 116.0) / 7.787)

    Y = torch.where(Lp > 903.3 * _LAB_DELTA, fy * fy * fy, Lp / 903.3)
    X = finv(fx) * _XN
    Z = finv(fz) * _ZN
    r = _mix(_XYZ2RGB, 0, X, Y, Z)
    g = _mix(_XYZ2RGB, 1, X, Y, Z)
    bl = _mix(_XYZ2RGB, 2, X, Y, Z)
    out = _linear_to_srgb(torch.stack([bl, g, r], dim=-1))
    return torch.clamp(out * 255.0, 0.0, 255.0)
