"""Geometric and filtering image ops with OpenCV-matching semantics
(counterpart of unet_tpu/ops/image.py:32-92, 95-134, 163-168, 219-313,
325-355). The fp32 NestedUNet's decoder upsamples with F.interpolate
(models/unetpp.py); the bf16 and int8 forwards with
`upsample2x_align_corners`.

Conventions, as in the reference:
  * INTER_LINEAR uses half-pixel centers: src = (dst + 0.5) * scale - 0.5;
    the tap INDICES are clamped and `frac` keeps its value.
    F.interpolate(align_corners=False) clamps the source COORDINATE instead,
    which differs on an upscale's first row, so it is not used here.
  * INTER_NEAREST uses src = floor(dst * scale), clipped
  * the filters' border is BORDER_REFLECT_101

Index and weight tables are computed with numpy in float64 exactly as the
reference computes them, then moved to the tensor's device.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _channel_axes(img: torch.Tensor, channel_dim) -> int:
    if channel_dim is None:
        channel_dim = img.shape[-1] <= 4 and img.ndim >= 3
    return img.ndim - (3 if channel_dim else 2)


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def recip32(c: float) -> float:
    """1 / c in float32. Inside a jitted JAX step XLA computes `x / c`, c a
    Python constant, as `x * recip32(c)`; the port multiplies by this
    wherever the JAX package divides by a constant."""
    return float(np.float32(1.0) / np.float32(c))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _linear_index_weights(out_size: int, in_size: int):
    """Half-pixel-center source indices + lerp weights (cv2 INTER_LINEAR)."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    i0 = np.clip(i0, 0, in_size - 1)
    return i0, i1, frac


def _resize_axis_linear(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, frac = _linear_index_weights(out_size, in_size)
    shape = [1] * x.ndim
    shape[axis] = out_size
    frac = torch.from_numpy(frac).to(x.device).reshape(shape)
    a = x.index_select(axis, _idx(i0, x.device))
    b = x.index_select(axis, _idx(i1, x.device))
    return a * (1.0 - frac) + b * frac


def resize_bilinear(img: torch.Tensor, out_hw: Sequence[int],
                    channel_dim: bool = None) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) parity. `out_hw` = (H, W). A trailing
    axis of size <= 4 counts as channels unless `channel_dim` says."""
    h_ax = _channel_axes(img, channel_dim)
    x = img.to(torch.float32)
    x = _resize_axis_linear(x, int(out_hw[0]), h_ax)
    x = _resize_axis_linear(x, int(out_hw[1]), h_ax + 1)
    if not img.dtype.is_floating_point:
        info = torch.iinfo(img.dtype)
        return torch.clamp(torch.round(x), info.min, info.max).to(img.dtype)
    return x.to(img.dtype)


def _nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    scale = in_size / out_size
    return np.minimum(np.floor(np.arange(out_size) * scale),
                      in_size - 1).astype(np.int64)


def resize_nearest(img: torch.Tensor, out_hw: Sequence[int],
                   channel_dim: bool = None) -> torch.Tensor:
    """cv2.resize(..., INTER_NEAREST) parity (src = floor(dst * scale))."""
    h_ax = _channel_axes(img, channel_dim)
    x = img.index_select(h_ax, _idx(_nearest_indices(int(out_hw[0]),
                                                     img.shape[h_ax]), img.device))
    return x.index_select(h_ax + 1, _idx(_nearest_indices(
        int(out_hw[1]), img.shape[h_ax + 1]), img.device))


def _upsample2x_taps(n: int):
    """The two taps of each row of the JAX package's (2n, n) align-corners
    x2 matrix (`_upsample2x_matrix`): row j holds 1-frac at column i0 and
    frac at i1 for src = j*(n-1)/(2n-1); on the last row i0 == i1 and the
    two add up to 1. Returns (i0, i1, w0, w1), w1 = 0 where i0 == i1."""
    out = 2 * n
    src = np.arange(out, dtype=np.float64) * (n - 1) / (out - 1)
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, n - 1)
    m = np.zeros((out, n), np.float32)
    np.add.at(m, (np.arange(out), i0), 1.0 - frac)
    np.add.at(m, (np.arange(out), i1), frac)
    rows = np.arange(out)
    return i0, i1, m[rows, i0], np.where(i1 > i0, m[rows, i1], np.float32(0))


def upsample2x_align_corners(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True), as
    the JAX package computes it (unet_tpu/ops/image.py:114-134): one axis at
    a time, each output the two-term sum of `_upsample2x_matrix`'s row with
    the weights cast to x.dtype, summed in float32 and rounded to x.dtype
    after each axis. Computed as a gather-lerp, not a matrix product: the
    row's other entries are exact zeros. In bf16 the products of bf16 values
    and bf16 weights are exact in float32, so the result is bit-identical to
    the JAX package's; F.interpolate in bf16 is not (it differs on 11-17 % of
    int8 codes). In float32 it equals F.interpolate up to the last bit."""
    def axis_up(t, axis):
        n = t.shape[axis]
        if n == 1:
            return t.repeat_interleave(2, dim=axis)
        i0, i1, w0, w1 = _upsample2x_taps(n)
        shape = [1] * t.ndim
        shape[axis] = 2 * n
        w0, w1 = (torch.from_numpy(w).to(t.dtype).to(torch.float32)
                  .reshape(shape).to(t.device) for w in (w0, w1))
        a = t.index_select(axis, _idx(i0, t.device)).to(torch.float32)
        b = t.index_select(axis, _idx(i1, t.device)).to(torch.float32)
        return (a * w0 + b * w1).to(t.dtype)

    return axis_up(axis_up(x, h_axis), w_axis)


def rotate90_ccw(img: torch.Tensor, channel_dim: bool = None) -> torch.Tensor:
    """cv2.ROTATE_90_COUNTERCLOCKWISE (reference infer_two_stage_burr.py:276)."""
    h_ax = _channel_axes(img, channel_dim)
    return img.transpose(h_ax, h_ax + 1).flip(h_ax)


# ---------------------------------------------------------------------------
# separable filters
# ---------------------------------------------------------------------------

def _reflect101_indices(n: int, before: int, after: int) -> np.ndarray:
    i = np.arange(-before, n + after)
    i = np.where(i < 0, -i, i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def filter1d(x: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate along one axis with BORDER_REFLECT_101; the terms are summed
    in kernel order, as the reference sums them."""
    k = np.asarray(kernel, dtype=np.float32)
    r_before = (len(k) - 1) // 2
    r_after = len(k) - 1 - r_before
    n = x.shape[axis]
    xp = x.to(torch.float32).index_select(
        axis, _idx(_reflect101_indices(n, r_before, r_after), x.device))
    out = None
    for i, w in enumerate(k):
        term = xp.narrow(axis, i, n) * float(w)
        out = term if out is None else out + term
    return out


def sep_filter2d(img: torch.Tensor, kx, ky, channel_dim: bool = None) -> torch.Tensor:
    """Separable 2-D correlation (rows with ky, cols with kx), REFLECT_101."""
    h_ax = _channel_axes(img, channel_dim)
    return filter1d(filter1d(img, ky, h_ax), kx, h_ax + 1)


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel parity, including the fixed small-kernel table
    used when sigma <= 0 and the sigma-from-ksize formula."""
    small_tab = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if sigma <= 0 and ksize in small_tab:
        return np.asarray(small_tab[ksize], dtype=np.float32)
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((x - c) ** 2) / (2 * s * s))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize, sigma: float,
                  channel_dim: bool = None) -> torch.Tensor:
    """cv2.GaussianBlur parity (separable, REFLECT_101). `ksize` may be an int
    or (kw, kh) like cv2; returns float32 (round yourself for uint8 parity)."""
    kw, kh = ksize if isinstance(ksize, (tuple, list)) else (ksize, ksize)
    one = np.asarray([1.0], np.float32)
    kx = gaussian_kernel1d(int(kw), sigma) if kw > 1 else one
    ky = gaussian_kernel1d(int(kh), sigma) if kh > 1 else one
    return sep_filter2d(img, kx, ky, channel_dim)


def _pad_hw_reflect101(x: torch.Tensor, h_ax: int, rt: int, rb: int,
                       rl: int, rr: int) -> torch.Tensor:
    x = x.index_select(h_ax, _idx(_reflect101_indices(x.shape[h_ax], rt, rb), x.device))
    return x.index_select(h_ax + 1, _idx(_reflect101_indices(x.shape[h_ax + 1], rl, rr),
                                         x.device))


def filter2d(img: torch.Tensor, kernel, channel_dim: bool = None) -> torch.Tensor:
    """Small dense 2-D correlation with BORDER_REFLECT_101 (cv2.filter2D).
    Zero taps are skipped; the rest are summed in row-major kernel order, as
    the reference sums them."""
    h_ax = _channel_axes(img, channel_dim)
    k = np.asarray(kernel, dtype=np.float32)
    kh, kw = k.shape
    rt, rl = (kh - 1) // 2, (kw - 1) // 2
    xp = _pad_hw_reflect101(img.to(torch.float32), h_ax, rt, kh - 1 - rt, rl, kw - 1 - rl)
    H, W = img.shape[h_ax], img.shape[h_ax + 1]
    out = None
    for i in range(kh):
        row = xp.narrow(h_ax, i, H)
        for j in range(kw):
            if k[i, j] == 0.0:
                continue
            term = row.narrow(h_ax + 1, j, W) * float(k[i, j])
            out = term if out is None else out + term
    if out is None:
        out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    return out


def sharpen(img: torch.Tensor, channel_dim: bool = None) -> torch.Tensor:
    """3x3 sharpen of the enhanced preprocessing preset
    (reference infer_enhanced_burr.py:60-63)."""
    k = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], dtype=np.float32)
    return filter2d(img, k, channel_dim)


def bilateral_filter(img: torch.Tensor, d: int = 7, sigma_color: float = 25.0,
                     sigma_space: float = 5.0, channel_dim: bool = None) -> torch.Tensor:
    """cv2.bilateralFilter semantics (REFLECT_101 border, colour distance =
    L1 over channels, circular window of radius d // 2) as a window sum, in
    the JAX package's order: the reference's configurable substitute for
    non-local means (reference src/refactor/config.py:49-53)."""
    h_ax = _channel_axes(img, channel_dim)
    channels = h_ax == img.ndim - 3
    r = d // 2
    x = img.to(torch.float32)
    xp = _pad_hw_reflect101(x, h_ax, r, r, r, r)
    H, W = img.shape[h_ax], img.shape[h_ax + 1]
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x[..., :1]) if channels else torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            nb = xp.narrow(h_ax, dy + r, H).narrow(h_ax + 1, dx + r, W)
            diff = (nb - x).abs()
            if channels:
                cdist = diff[..., 0:1]
                for c in range(1, diff.shape[-1]):
                    cdist = cdist + diff[..., c:c + 1]
            else:
                cdist = diff
            w = math.exp(gs * (dy * dy + dx * dx)) * torch.exp(gc * cdist * cdist)
            num = num + w * nb
            den = den + w
    return num / den
