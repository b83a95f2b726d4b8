"""Frozen copy of the port's `ops/image.py`, run on its plain routes, for the
benchmark's reference; it imports nothing of the port.

Geometric and filtering image ops with OpenCV-matching semantics
(counterpart of unet_tpu/ops/image.py:32-92, 95-156, 163-216, 219-313,
325-446). The fp32 NestedUNet's decoder upsamples with F.interpolate
(models/unetpp.py); the bf16 and int8 forwards and the lightweight UNet++
with `upsample2x_align_corners`, whose deep-supervision heads and odd-sized
skips use `resize_bilinear_align_corners`.

Conventions, as in the reference:
  * INTER_LINEAR uses half-pixel centers: src = (dst + 0.5) * scale - 0.5;
    the tap INDICES are clamped and `frac` keeps its value.
    F.interpolate(align_corners=False) clamps the source COORDINATE instead,
    which differs on an upscale's first row, so it is not used here.
  * INTER_NEAREST uses src = floor(dst * scale), clipped
  * the filters' border is BORDER_REFLECT_101

Index and weight tables are computed with numpy in float64 exactly as the
reference computes them, then moved to the tensor's device once per
(sizes, device) and kept (`_table`): a copy from pageable host memory on
every call would wait for the device's queue.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def _channel_axes(img: torch.Tensor, channel_dim) -> int:
    if channel_dim is None:
        channel_dim = img.shape[-1] <= 4 and img.ndim >= 3
    return img.ndim - (3 if channel_dim else 2)


@functools.lru_cache(maxsize=512)
def _table(make, *key):
    """The numpy arrays of `make(*key[:-1])` as tensors on the device
    `key[-1]`, built once per key. Built outside inference mode, so that a
    table also serves a forward that keeps gradients."""
    *args, device = key
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in make(*args))


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
    i0, i1, frac = _table(_linear_index_weights, out_size, in_size, x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    frac = frac.reshape(shape)
    a = x.index_select(axis, i0)
    b = x.index_select(axis, i1)
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


def _nearest_indices(out_size: int, in_size: int):
    scale = in_size / out_size
    return (np.minimum(np.floor(np.arange(out_size) * scale),
                       in_size - 1).astype(np.int64),)


def resize_nearest(img: torch.Tensor, out_hw: Sequence[int],
                   channel_dim: bool = None) -> torch.Tensor:
    """cv2.resize(..., INTER_NEAREST) parity (src = floor(dst * scale))."""
    h_ax = _channel_axes(img, channel_dim)
    x = img.index_select(h_ax, _table(_nearest_indices, int(out_hw[0]),
                                      img.shape[h_ax], img.device)[0])
    return x.index_select(h_ax + 1, _table(_nearest_indices, int(out_hw[1]),
                                           img.shape[h_ax + 1], img.device)[0])


def rotate90_ccw(img: torch.Tensor, channel_dim: bool = None) -> torch.Tensor:
    """cv2.ROTATE_90_COUNTERCLOCKWISE (reference infer_two_stage_burr.py:276)."""
    h_ax = _channel_axes(img, channel_dim)
    return img.transpose(h_ax, h_ax + 1).flip(h_ax)


def _reflect101_indices(n: int, before: int, after: int):
    i = np.arange(-before, n + after, dtype=np.int64)
    i = np.where(i < 0, -i, i)
    return (np.where(i >= n, 2 * (n - 1) - i, i),)


def filter1d(x: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate along one axis with BORDER_REFLECT_101; the terms are summed
    in kernel order, as the reference sums them."""
    k = np.asarray(kernel, dtype=np.float32)
    r_before = (len(k) - 1) // 2
    r_after = len(k) - 1 - r_before
    n = x.shape[axis]
    xp = x.to(torch.float32).index_select(
        axis, _table(_reflect101_indices, n, r_before, r_after, x.device)[0])
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
    x = x.index_select(h_ax, _table(_reflect101_indices, x.shape[h_ax], rt, rb, x.device)[0])
    return x.index_select(h_ax + 1,
                          _table(_reflect101_indices, x.shape[h_ax + 1], rl, rr, x.device)[0])


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
