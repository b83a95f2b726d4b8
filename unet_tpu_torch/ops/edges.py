"""Sobel, Laplacian, difference of Gaussians and Canny with hysteresis
(counterpart of unet_tpu/ops/edges.py:38-120, 127-245).

OpenCV parity, as in the reference:
  * cv2.Sobel / cv2.Laplacian use BORDER_REFLECT_101 and return float32
    (the reference's CV_64F path); `uint8_wrap` is the C cast to uint8
  * Canny's Sobel-3 gradients use BORDER_REPLICATE, taken as int32
  * L1 magnitude |dx|+|dy| (the burr stage's); thresholds are floor()ed
  * NMS sector tests with the fixed-point constant TG22 = 13573 / 2**15 and
    OpenCV's exact strict / non-strict neighbour comparisons
  * hysteresis = min-propagation over the candidate set with seeds
    strong=0 / weak=1 (ops.cc_kernels.propagate), bounded like the reference
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from unet_tpu_torch.ops import cc_kernels
from unet_tpu_torch.ops import image as _image

# fixed-point tan(22.5 deg) * 2**15, exactly as in OpenCV's canny.cpp
_TG22 = 13573
_CANNY_SHIFT = 15


def _replicate_indices(n: int, before: int, after: int):
    return (np.clip(np.arange(-before, n + after, dtype=np.int64), 0, n - 1),)


def _corr1d(x: torch.Tensor, kernel: Sequence[float], axis: int, border: str) -> torch.Tensor:
    """Correlate one axis of `x` (as float32) with a static 1-D kernel,
    `border` "reflect101" or "replicate"; zero taps are skipped and the rest
    summed in kernel order."""
    rb = (len(kernel) - 1) // 2
    ra = len(kernel) - 1 - rb
    n = x.shape[axis]
    if border == "reflect101":
        idx = _image._table(_image._reflect101_indices, n, rb, ra, x.device)[0]
    elif border == "replicate":
        idx = _image._table(_replicate_indices, n, rb, ra, x.device)[0]
    else:
        raise ValueError(border)
    xp = x.to(torch.float32).index_select(axis, idx)
    out = None
    for i, w in enumerate(kernel):
        if w == 0.0:
            continue
        term = xp.narrow(axis, i, n) * float(w)
        out = term if out is None else out + term
    return out if out is not None else torch.zeros(x.shape, dtype=torch.float32,
                                                   device=x.device)


_SOBEL_DERIV = {1: [-1.0, 0.0, 1.0], 2: [1.0, -2.0, 1.0], 0: [1.0, 2.0, 1.0]}


def sobel(img: torch.Tensor, dx: int, dy: int, ksize: int = 3,
          border: str = "reflect101") -> torch.Tensor:
    """cv2.Sobel(..., ksize=3) on (..., H, W) single-channel images, float32
    out (reference infer_enhanced_burr.py:95-96). Only ksize=3 with
    dx + dy in {1, 2}, the reference's configurations."""
    if ksize != 3:
        raise NotImplementedError("only ksize=3 is used by the reference")
    out = _corr1d(img, _SOBEL_DERIV[dy], img.ndim - 2, border)
    return _corr1d(out, _SOBEL_DERIV[dx], img.ndim - 1, border)


def sobel_magnitude(img: torch.Tensor, border: str = "reflect101") -> torch.Tensor:
    """sqrt(Sx^2 + Sy^2) of the 3x3 Sobel (reference infer_enhanced_burr.py:95-97)."""
    gx = sobel(img, 1, 0, border=border)
    gy = sobel(img, 0, 1, border=border)
    # float64 root rounded to float32: the correctly rounded float32 sqrt,
    # which XLA gives and PyTorch's vectorized CPU sqrt does not always
    return torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(torch.float32)


# Laplacian apertures: ksize=1 is the 4-neighbour stencil; ksize=3 is the
# Sobel-composed second-derivative aperture (OpenCV laplacian docs).
_LAP_K1 = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=np.float32)
_LAP_K3 = np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]], dtype=np.float32)


def laplacian(img: torch.Tensor, ksize: int = 1) -> torch.Tensor:
    """cv2.Laplacian(..., CV_64F), REFLECT_101 border, float32 out."""
    return _image.filter2d(img, {1: _LAP_K1, 3: _LAP_K3}[ksize], channel_dim=False)


def dog(img: torch.Tensor, ksize1: int = 3, sigma1: float = 1.0,
        ksize2: int = 7, sigma2: float = 2.0) -> torch.Tensor:
    """Difference of Gaussians of uint8 blurs, saturated at 0 as
    cv2.subtract does (reference src/refactor/burr_detector.py:93-96)."""
    b1 = torch.clamp(torch.round(_image.gaussian_blur(img, ksize1, sigma1, channel_dim=False)), 0, 255)
    b2 = torch.clamp(torch.round(_image.gaussian_blur(img, ksize2, sigma2, channel_dim=False)), 0, 255)
    return torch.clamp(b1 - b2, min=0)


def uint8_wrap(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 with C-cast semantics (truncate toward 0, wrap mod
    256), as `np.abs(lap).astype(np.uint8)` in the reference
    (infer_enhanced_burr.py:101); float32 out."""
    return torch.remainder(torch.trunc(x).to(torch.int32), 256).to(torch.float32)


def _shift2d(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """x shifted so out[r, c] = x[r + dr, c + dc], zero outside."""
    H, W = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[..., 1 + dr:1 + dr + H, 1 + dc:1 + dc + W]


def canny(img: torch.Tensor, low: float, high: float,
          cc_iters: int = 16) -> torch.Tensor:
    """cv2.Canny parity (L1 gradient) on (..., H, W) uint8-valued arrays ->
    bool edge mask."""
    x = torch.round(img.to(torch.float32))
    h_ax, w_ax = x.ndim - 2, x.ndim - 1
    gx = _corr1d(_corr1d(x, [1.0, 2.0, 1.0], h_ax, "replicate"),
                 [-1.0, 0.0, 1.0], w_ax, "replicate").to(torch.int32)
    gy = _corr1d(_corr1d(x, [-1.0, 0.0, 1.0], h_ax, "replicate"),
                 [1.0, 2.0, 1.0], w_ax, "replicate").to(torch.int32)

    mag = gx.abs() + gy.abs()
    lo = int(np.floor(low))
    hi = int(np.floor(high))

    ax = gx.abs()
    ay = gy.abs() << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((ax + ax) << _CANNY_SHIFT)

    horiz = ay < tg22x
    vert = ay > tg67x
    s_neg = (gx ^ gy) < 0  # opposite signs -> anti-diagonal neighbours

    m = mag
    keep_h = (m > _shift2d(m, 0, -1)) & (m >= _shift2d(m, 0, 1))
    keep_v = (m > _shift2d(m, -1, 0)) & (m >= _shift2d(m, 1, 0))
    # s = -1 when signs differ: compare with up-right and down-left
    keep_d = torch.where(
        s_neg,
        (m > _shift2d(m, -1, 1)) & (m > _shift2d(m, 1, -1)),
        (m > _shift2d(m, -1, -1)) & (m > _shift2d(m, 1, 1)),
    )
    nms = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_d))
    cand = (m > lo) & nms
    strong = cand & (m > hi)
    return hysteresis(strong, cand & ~strong, cc_iters=cc_iters)


def hysteresis(strong: torch.Tensor, weak: torch.Tensor, cc_iters: int = 16,
               pool_iters: int = 16) -> torch.Tensor:
    """Keep strong pixels plus weak pixels 8-connected (transitively) to a
    strong pixel, with the reference's bounded schedule: or-reachability is
    min-propagation with seeds strong=0 / weak=1 over the candidate set, and
    the result is 0 exactly where the component reached a strong pixel."""
    cand = strong | weak
    lead = cand.shape[:-2]
    H, W = cand.shape[-2:]
    fg = cand.reshape(-1, H, W).contiguous()
    seed = torch.where(strong & cand, 0, 1).to(torch.int32).reshape(-1, 1, H, W)
    out = cc_kernels.propagate(seed.contiguous(), fg, pool_iters=pool_iters,
                               max_iters=cc_iters, connectivity=8)
    return ((out[:, 0] == 0) & fg).reshape(lead + (H, W))
