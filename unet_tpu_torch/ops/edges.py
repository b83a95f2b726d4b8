"""Canny with hysteresis (counterpart of unet_tpu/ops/edges.py:38-63,
127-245).

OpenCV parity, as in the reference:
  * Sobel-3 gradients with BORDER_REPLICATE, taken as int32
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

# fixed-point tan(22.5 deg) * 2**15, exactly as in OpenCV's canny.cpp
_TG22 = 13573
_CANNY_SHIFT = 15


def _corr1d_replicate(x: torch.Tensor, kernel: Sequence[float], axis: int) -> torch.Tensor:
    """Correlate one axis of float32 `x` with a static 1-D kernel, replicate
    border; zero taps are skipped and the rest summed in kernel order."""
    rb = (len(kernel) - 1) // 2
    n = x.shape[axis]
    idx = np.clip(np.arange(-rb, n + len(kernel) - 1 - rb), 0, n - 1)
    xp = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    out = None
    for i, w in enumerate(kernel):
        if w == 0.0:
            continue
        term = xp.narrow(axis, i, n) * float(w)
        out = term if out is None else out + term
    return out


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
    gx = _corr1d_replicate(_corr1d_replicate(x, [1.0, 2.0, 1.0], h_ax),
                           [-1.0, 0.0, 1.0], w_ax).to(torch.int32)
    gy = _corr1d_replicate(_corr1d_replicate(x, [-1.0, 0.0, 1.0], h_ax),
                           [1.0, 2.0, 1.0], w_ax).to(torch.int32)

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
