"""Geometric and filtering image ops with OpenCV-matching semantics
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
import math
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
    return _up2x_axis(_up2x_axis(x, h_axis), w_axis)


def _up2x_axis(t: torch.Tensor, axis: int) -> torch.Tensor:
    """One axis of `upsample2x_align_corners`."""
    n = t.shape[axis]
    if n == 1:
        return t.repeat_interleave(2, dim=axis)
    return _lerp(t, axis, *_table(_upsample2x_taps, n, t.device))


def _lerp(t: torch.Tensor, axis: int, i0: torch.Tensor, i1: torch.Tensor, w0: torch.Tensor,
          w1: torch.Tensor) -> torch.Tensor:
    """Rows i0 and i1 of `t` along `axis`, weighted by w0 and w1 cast to
    t.dtype, summed in float32, rounded to t.dtype."""
    shape = [1] * t.ndim
    shape[axis] = i0.shape[0]
    w0, w1 = (w.to(t.dtype).to(torch.float32).reshape(shape) for w in (w0, w1))
    a = t.index_select(axis, i0).to(torch.float32)
    b = t.index_select(axis, i1).to(torch.float32)
    return (a * w0 + b * w1).to(t.dtype)


def upsample2x_align_corners_rows(slab: torch.Tensor, lo: int, n: int, rows, h_axis: int,
                                  w_axis: int) -> torch.Tensor:
    """Rows [s, e) = `rows` along `h_axis` of `upsample2x_align_corners` of
    an n-row plane, bit for bit, from `slab`, which holds the plane's rows
    [lo, lo + slab rows) (the rows that the output rows' taps read): the
    global tap table sliced at the output rows. The H stripes of the bf16
    and int8 forwards (parallel.spatial.up2x)."""
    s, e = rows
    if n == 1:
        y = slab.narrow(h_axis, 0, 1).repeat_interleave(e - s, dim=h_axis)
    else:
        i0, i1, w0, w1 = _table(_upsample2x_taps, n, slab.device)
        y = _lerp(slab, h_axis, i0[s:e] - lo, i1[s:e] - lo, w0[s:e], w1[s:e])
    return _up2x_axis(y, w_axis)


def _align_corners_taps(out: int, n: int):
    """Source rows and lerp weight of an align-corners resize from n to out
    (n, out > 1): src = i * (n - 1) / (out - 1)."""
    src = np.arange(out, dtype=np.float64) * (n - 1) / (out - 1)
    i0 = np.floor(src).astype(np.int64)
    return i0, np.minimum(i0 + 1, n - 1), (src - i0).astype(np.float32)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Sequence[int], h_axis: int,
                                  w_axis: int) -> torch.Tensor:
    """F.interpolate(..., mode='bilinear', align_corners=True) to any size,
    as the JAX package computes it (unet_tpu/ops/image.py:137-156): one
    axis at a time, `a * (1 - w) + b * w` with the weight cast to x.dtype
    and every operation rounded to x.dtype, so the result is bit-identical
    to the JAX function in float32 and in bf16 (F.interpolate in bf16 is
    not). An axis of size 1, or resized to 1, takes row 0."""
    def axis_rs(t, axis, out):
        n = t.shape[axis]
        if n == out:
            return t
        if out == 1 or n == 1:
            return t.index_select(axis, torch.zeros(out, dtype=torch.int64, device=t.device))
        i0, i1, w = _table(_align_corners_taps, out, n, t.device)
        shape = [1] * t.ndim
        shape[axis] = out
        w = w.to(t.dtype).reshape(shape)
        return t.index_select(axis, i0) * (1 - w) + t.index_select(axis, i1) * w

    return axis_rs(axis_rs(x, h_axis, int(out_hw[0])), w_axis, int(out_hw[1]))


def rotate90_ccw(img: torch.Tensor, channel_dim: bool = None) -> torch.Tensor:
    """cv2.ROTATE_90_COUNTERCLOCKWISE (reference infer_two_stage_burr.py:276)."""
    h_ax = _channel_axes(img, channel_dim)
    return img.transpose(h_ax, h_ax + 1).flip(h_ax)


def rotate90_cw(img: torch.Tensor, channel_dim: bool = None) -> torch.Tensor:
    """cv2.ROTATE_90_CLOCKWISE."""
    h_ax = _channel_axes(img, channel_dim)
    return img.transpose(h_ax, h_ax + 1).flip(h_ax + 1)


def letterbox_params(src_hw: Sequence[int], dst_hw: Sequence[int]):
    """Aspect-preserving resize geometry (reference
    src/refactor/preprocess.py:147-172, infer_video_robust.py:40-61):
    (new_h, new_w, pad_top, pad_left)."""
    sh, sw = src_hw
    dh, dw = dst_hw
    scale = min(dh / sh, dw / sw)
    new_h, new_w = int(round(sh * scale)), int(round(sw * scale))
    return new_h, new_w, (dh - new_h) // 2, (dw - new_w) // 2


def letterbox(img: torch.Tensor, dst_hw: Sequence[int], pad_value: float = 0.0,
              channel_dim: bool = None) -> torch.Tensor:
    """Resize keeping the aspect, then centre-pad to `dst_hw`."""
    h_ax = _channel_axes(img, channel_dim)
    new_h, new_w, pt, pl = letterbox_params(img.shape[h_ax:h_ax + 2], dst_hw)
    x = resize_bilinear(img, (new_h, new_w), channel_dim)
    # F.pad's widths run from the last axis back: the trailing axes, W, H
    pad = (0, 0) * (img.ndim - h_ax - 2) + (pl, int(dst_hw[1]) - new_w - pl,
                                            pt, int(dst_hw[0]) - new_h - pt)
    return torch.nn.functional.pad(x, pad, value=pad_value)


def unletterbox_mask(mask: torch.Tensor, src_hw: Sequence[int],
                     dst_hw: Sequence[int]) -> torch.Tensor:
    """Inverse of `letterbox` for an (..., H, W) mask at `dst_hw`: the
    content region, nearest-resized back to `src_hw`."""
    new_h, new_w, pt, pl = letterbox_params(src_hw, mask.shape[-2:])
    crop = mask[..., pt:pt + new_h, pl:pl + new_w]
    return resize_nearest(crop, src_hw, channel_dim=False)


# ---------------------------------------------------------------------------
# separable filters
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# dynamic horizontal crop / resize (the roi_first preset)
# ---------------------------------------------------------------------------

def _crop_rows(H: int, oh: int):
    """Row taps of `crop_resize_bilinear`, in float32 as the JAX package
    computes them: src = (i + 0.5) * float32(H / oh) - 0.5."""
    ys = (np.arange(oh, dtype=np.float32) + np.float32(0.5)) * np.float32(H / oh) - np.float32(0.5)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    wy = np.clip(ys - y0.astype(np.float32), np.float32(0), np.float32(1))
    return y0, np.minimum(y0 + 1, H - 1), wy


def crop_resize_bilinear(img: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                         out_hw: Sequence[int]) -> torch.Tensor:
    """Per-image horizontal crop [x0, x1) of (B, H, W, C) `img`, resized to
    `out_hw` with bilinear taps (src = (dst + 0.5) * scale - 0.5), the
    columns clamped to the crop, as cv2.resize of a numpy crop replicates
    its edge columns (reference infer_video_roi.py:201-209). x0, x1: (B,)
    int tensors on the device, so the box never reaches the host.

    The arithmetic is the jitted JAX function's on the CPU, where XLA
    computes span / ow as span * float32(1 / ow) and contracts products
    into sums: the source column is fma(i + 0.5, scale, -0.5) + x0 and each
    lerp fma(p, 1 - w, q * w), a fused multiply-add emulated in float64
    (one rounding to float32)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    B, H, W, C = img.shape
    y0, y1, wy = _table(_crop_rows, H, oh, img.device)
    a = x0.to(torch.int64)[:, None]
    b = x1.to(torch.int64)[:, None]
    span = torch.clamp((b - a).to(torch.float32), min=1.0)
    t = torch.arange(ow, dtype=torch.float32, device=img.device) + 0.5
    xs = (t.double() * (span * recip32(ow)).double() - 0.5).to(torch.float32) + a.to(torch.float32)
    lo = a.clamp(0, W - 1)
    hi = torch.maximum(torch.minimum(b - 1, torch.full_like(b, W - 1)), lo)
    c0 = torch.minimum(torch.maximum(torch.floor(xs).to(torch.int64), lo), hi)
    c1 = torch.minimum(c0 + 1, hi)
    wx = torch.clamp(xs - c0.to(torch.float32), 0.0, 1.0)[:, None, :, None]
    x = img.to(torch.float32)

    def tap(rows, cols):
        r = x.index_select(1, rows)                               # (B, oh, W, C)
        return r.gather(2, cols[:, None, :, None].expand(B, oh, ow, C))

    def lerp(p, q, w):
        return (p.double() * (1 - w).double() + (q * w).double()).to(torch.float32)

    top = lerp(tap(y0, c0), tap(y0, c1), wx)
    bot = lerp(tap(y1, c0), tap(y1, c1), wx)
    return lerp(top, bot, wy[None, :, None, None])


def _nearest_rows(oh: int, mh: int):
    return (np.minimum(np.arange(oh) * mh // oh, mh - 1).astype(np.int64),)


def uncrop_resize_nearest(mask: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                          out_hw: Sequence[int]) -> torch.Tensor:
    """Inverse of `crop_resize_bilinear` for (B, mh, mw) bool masks: each
    mask nearest-resized into the [x0, x1) span of an empty (oh, ow) frame
    (reference infer_video_roi.py:238-247). Source columns are
    floor((ox - x0) * mw / span), a floor division also left of the box."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    mh, mw = mask.shape[-2:]
    rows = _table(_nearest_rows, oh, mh, mask.device)[0]
    a = x0.to(torch.int64)[:, None]
    b = x1.to(torch.int64)[:, None]
    ox = torch.arange(ow, dtype=torch.int64, device=mask.device)[None]
    span = torch.clamp(b - a, min=1)
    cols = torch.clamp(torch.div((ox - a) * mw, span, rounding_mode="floor"), 0, mw - 1)
    out = mask.index_select(1, rows).gather(
        2, cols[:, None, :].expand(mask.shape[0], oh, ow))
    return out & ((ox >= a) & (ox < b))[:, None, :]


def _box_tree(v):
    """Sum of 1, 2, 4 or 8 float32 tensors as XLA's CPU dot reduces a
    vector: pairs (0, 1), (2, 3), ..., then pairs of pairs, the halves
    {0, 1, 4, 5} and {2, 3, 6, 7} last."""
    while len(v) > 2:
        pairs = [v[i] + v[i + 1] for i in range(0, len(v), 2)]
        h = len(pairs) // 2
        v = [pairs[i] + pairs[i + h] for i in range(h)] if len(pairs) > 2 else pairs
    return v[0] + v[1] if len(v) == 2 else v[0]


def box_smooth_same(x: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.convolve(x, ones(n) / n, "same") along the last axis of a float32
    tensor of INTEGER values (detect_vertical_roi's column counts), with
    numpy's alignment (pad n // 2 before, n - 1 - n // 2 after) and, bit for
    bit, the float32 sums of the JAX package's jitted convolution on the
    CPU: each tap x * float32(1 / n) rounded; the first 16 * (n // 16)
    taps in 8 lanes, lane l starting at tap l and adding taps l + 8, l +
    16, ... with a fused multiply-add each, then reduced as a vector; the
    rest in blocks of 8, 4, 2 and 1 taps, each reduced as a vector; the
    partial sums added in that order. A fused multiply-add is a float64
    product and sum rounded once, exact for integer inputs below 2**20."""
    k = np.float32(1.0) / np.float32(n)
    W = x.shape[-1]
    xp = torch.nn.functional.pad(x.to(torch.float32), (n // 2, n - 1 - n // 2))
    tap = lambda t: xp[..., t:t + W]
    prod = lambda t: tap(t) * float(k)
    parts, t = [], 0
    main = 16 * (n // 16)
    if main:
        lanes = []
        for l in range(8):
            acc = prod(l)
            for c in range(l + 8, main, 8):
                acc = (tap(c).double() * float(k) + acc.double()).to(torch.float32)
            lanes.append(acc)
        parts.append(_box_tree(lanes))
        t = main
    for size in (8, 4, 2, 1):
        if n - t >= size:
            parts.append(_box_tree([prod(t + i) for i in range(size)]))
            t += size
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def detect_vertical_roi(gray: torch.Tensor, canny_low: float = 50.0,
                        canny_high: float = 150.0, smooth: int = 30,
                        rel_thresh: float = 0.3, margin_frac: float = 0.1):
    """Per-frame [x0, x1) bounds of the vertical edge-density band
    (reference detect_roi_by_projection, infer_video_roi.py:23-57): Canny
    (kernel B1 for its hysteresis) -> per-column edge counts -> box
    smoothing (`box_smooth_same`) -> columns above rel_thresh * max,
    widened by margin_frac of the span; the central half where no column
    clears the threshold. Returns (x0, x1), int32 (B,) tensors on the
    device of `gray`."""
    from unet_tpu_torch.ops import edges as _edges
    e = _edges.canny(gray, canny_low, canny_high)
    proj = e.sum(dim=-2, dtype=torch.int32).to(torch.float32)           # (B, W)
    proj = box_smooth_same(proj, smooth)
    thr = torch.amax(proj, dim=-1, keepdim=True) * rel_thresh
    active = proj > thr
    W = gray.shape[-1]
    any_active = active.any(dim=-1)
    x0 = torch.argmax(active.to(torch.uint8), dim=-1).to(torch.int32)
    x1 = (W - torch.argmax(active.flip(-1).to(torch.uint8), dim=-1)).to(torch.int32)
    m = ((x1 - x0).to(torch.float32) * margin_frac).to(torch.int32)
    x0 = torch.clamp(x0 - m, min=0)
    x1 = torch.clamp(x1 + m, max=W)
    x0 = torch.where(any_active, x0, W // 4).to(torch.int32)
    x1 = torch.where(any_active, x1, (3 * W) // 4).to(torch.int32)
    return x0, x1
