"""Binary morphology (counterpart of unet_tpu/ops/morph.py:26-63, 91-198).

Structuring elements replicate cv2.getStructuringElement bit for bit,
including the MORPH_ELLIPSE rasterization. cv2's anchor is (kh//2, kw//2),
so an even SE (the burr stage uses ellipse_kernel(8) and ellipse_kernel(2))
pads asymmetrically. A dilation is the OR of one horizontal window max per
SE row, shifted vertically; an erosion is NOT dilate(NOT x) with the same
rows, whose zero padding of the complement is cv2's +inf border.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

RECT = "rect"
ELLIPSE = "ellipse"
CROSS = "cross"


def structuring_element(shape: str, ksize: Sequence[int]) -> np.ndarray:
    """cv2.getStructuringElement parity. `ksize` = (width, height) like cv2."""
    w, h = int(ksize[0]), int(ksize[1])
    if shape == RECT:
        return np.ones((h, w), dtype=np.uint8)
    if shape == CROSS:
        e = np.zeros((h, w), dtype=np.uint8)
        e[h // 2, :] = 1
        e[:, w // 2] = 1
        return e
    if shape == ELLIPSE:
        e = np.zeros((h, w), dtype=np.uint8)
        r, c = h // 2, w // 2
        inv_r2 = 1.0 / (r * r) if r else 0.0
        for i in range(h):
            dy = i - r
            if abs(dy) <= r:
                # cvRound == round-half-to-even == np.round
                dx = int(np.round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
                j1, j2 = max(c - dx, 0), min(c + dx + 1, w)
                e[i, j1:j2] = 1
        return e
    raise ValueError(f"unknown SE shape {shape!r}")


def ellipse_kernel(w: int, h: int | None = None) -> np.ndarray:
    return structuring_element(ELLIPSE, (w, h if h is not None else w))


def disk_kernel(radius: int) -> np.ndarray:
    """Euclidean disk x^2 + y^2 <= r^2. Dilation by it thresholds the
    Euclidean distance transform at `radius` (`ring_band`)."""
    r = int(radius)
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def _row_runs(se: np.ndarray):
    """Per-row contiguous runs (dy, left, width) of an SE around the cv2
    anchor. Rect, cross, ellipse and disk SEs all decompose so."""
    se = np.asarray(se)
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    runs = []
    for i in range(kh):
        cols = np.nonzero(se[i])[0]
        if len(cols) == 0:
            continue
        if cols[-1] - cols[0] + 1 != len(cols):
            raise ValueError("structuring element rows must be contiguous")
        runs.append((i - ay, int(cols[0]) - ax, len(cols)))
    return runs


def _dilate_runs(mask: torch.Tensor, runs) -> torch.Tensor:
    """out[r, c] = any(mask[r+dy, c+left : c+left+w]) over runs; taps
    outside the image read False."""
    lead = mask.shape[:-2]
    H, W = mask.shape[-2:]
    x = mask.reshape(-1, 1, H, W).to(torch.float32)
    out = None
    for dy, left, w in runs:
        xp = F.pad(x, (max(-left, 0), max(left + w - 1, 0)))
        win = F.max_pool2d(xp, (1, w), stride=1)
        start = max(left, 0)
        win = win[..., start:start + W]
        if dy:
            win = F.pad(win, (0, 0, max(-dy, 0), max(dy, 0)))
            win = win[..., max(dy, 0):max(dy, 0) + H, :]
        out = win if out is None else torch.maximum(out, win)
    return (out > 0.5).reshape(lead + (H, W))


def dilate(mask: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate on a binary mask (border behaves like cv2's default)."""
    out = mask.to(torch.bool)
    runs = _row_runs(se)
    for _ in range(iterations):
        out = _dilate_runs(out, runs)
    return out


def erode(mask: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.erode on a binary mask; outside the image counts as foreground."""
    out = mask.to(torch.bool)
    runs = _row_runs(se)
    for _ in range(iterations):
        out = torch.logical_not(_dilate_runs(torch.logical_not(out), runs))
    return out


def open_(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx MORPH_OPEN = dilate(erode(x))."""
    return dilate(erode(mask, se), se)


def close_(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx MORPH_CLOSE = erode(dilate(x))."""
    return erode(dilate(mask, se), se)


def outer_band(mask: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """dilate(mask) & ~mask — the burr detection band
    (reference infer_two_stage_burr.py:78-81)."""
    return torch.logical_and(dilate(mask, se, iterations),
                             torch.logical_not(mask.to(torch.bool)))


def gradient(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Morphological gradient: dilate & ~erode (the boundary band)."""
    return torch.logical_and(dilate(mask, se), torch.logical_not(erode(mask, se)))


def ring_band(mask: torch.Tensor, r_in: int, r_out: int) -> torch.Tensor:
    """Pixels whose Euclidean distance to `mask` lies in (r_in, r_out]:
    dilate(disk r_out) & ~dilate(disk r_in), the reference's
    cv2.distanceTransform band (infer_video_robust.py:169-198)."""
    outer = dilate(mask, disk_kernel(r_out))
    inner = dilate(mask, disk_kernel(r_in)) if r_in > 0 else mask.to(torch.bool)
    return torch.logical_and(outer, torch.logical_not(inner))
