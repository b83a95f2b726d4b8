"""Frozen copy of the port's `ops/clahe.py`, run on its plain routes, for the
benchmark's reference; it imports nothing of the port.

CLAHE, contrast-limited adaptive histogram equalization (counterpart of
unet_tpu/ops/clahe.py:30-163).

cv2.createCLAHE(clipLimit, tileGridSize).apply semantics, as in the JAX
package:
  1. pad right/bottom with BORDER_REFLECT_101 to a multiple of the grid
  2. per-tile 256-bin histograms: one integer `bincount` over
     (image, tile, value)
  3. integer clip + excess redistribution (cv2's residual loop, vectorized)
  4. LUT = round_half_even(cdf * 255 / tile_area)
  5. bilinear blend of the 4 surrounding tile LUTs (gathered per pixel) with
     cv2's half-pixel tile coordinates and edge clamping

Steps 1-4 are integer and exact. The blend is float32 and is followed by a
rounding, so its multiplication order is part of the result: the JAX package
multiplies by precomputed weights `(1 - xa) * (1 - ya)` when both tile sides
are even (its one-hot-matmul route) and by `(1 - xa)` then `(1 - ya)`
otherwise. The port picks the same order on the same condition. The JAX
one-hot compare and one-hot einsum are TPU workarounds and are not ported.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .image import _pad_hw_reflect101

_BINS = 256


def _axis_coords(n: int, tile: int, ntiles: int):
    """Per-pixel (first tile, second tile, weight of the second) along one
    axis, cv2's half-pixel tile coordinates, computed in float64."""
    f = np.arange(n, dtype=np.float64) / tile - 0.5
    i1 = np.floor(f).astype(np.int64)
    a = (f - i1).astype(np.float32)
    i2 = np.minimum(i1 + 1, ntiles - 1)
    return np.maximum(i1, 0), i2, a


def _tile_luts(x: torch.Tensor, tiles_y: int, tiles_x: int, th: int, tw: int,
               clip_limit: float) -> torch.Tensor:
    """(N, ph, pw) int64 padded images -> (N, tiles_y * tiles_x, 256) int64
    LUTs."""
    N, ph, pw = x.shape
    dev = x.device
    n_tiles = tiles_y * tiles_x
    tile_area = th * tw
    tile_of = ((torch.arange(ph, device=dev) // th)[:, None] * tiles_x
               + (torch.arange(pw, device=dev) // tw)[None, :])
    key = (torch.arange(N, device=dev)[:, None, None] * n_tiles + tile_of) * _BINS + x
    hist = torch.bincount(key.reshape(-1), minlength=N * n_tiles * _BINS)
    hist = hist.reshape(N, n_tiles, _BINS)

    clip = max(int(clip_limit * tile_area / _BINS), 1)
    clipped = (hist - clip).clamp(min=0).sum(-1)
    hist = hist.clamp(max=clip)
    redist = clipped // _BINS
    residual = clipped - redist * _BINS
    hist = hist + redist[..., None]
    step = torch.clamp(_BINS // torch.clamp(residual, min=1), min=1)[..., None]
    bins = torch.arange(_BINS, device=dev)
    hist = hist + ((bins % step == 0) & (bins // step < residual[..., None])).to(hist.dtype)

    cdf = torch.cumsum(hist, -1).to(torch.float32)
    return torch.clamp(torch.round(cdf * (float(_BINS - 1) / tile_area)), 0, 255).to(torch.int64)


def clahe(img: torch.Tensor, clip_limit: float = 3.0,
          tile_grid: Sequence[int] = (8, 8)) -> torch.Tensor:
    """cv2 CLAHE on (..., H, W) uint8-valued arrays. Returns float32 with
    integer values in [0, 255]. `tile_grid` is (tilesX, tilesY) like cv2."""
    tiles_x, tiles_y = int(tile_grid[0]), int(tile_grid[1])
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    dev = img.device
    x = img.reshape(-1, H, W).to(torch.int64)
    N = x.shape[0]
    pad_h = (tiles_y - H % tiles_y) % tiles_y
    pad_w = (tiles_x - W % tiles_x) % tiles_x
    xp = _pad_hw_reflect101(x, 1, 0, pad_h, 0, pad_w) if pad_h or pad_w else x
    th, tw = (H + pad_h) // tiles_y, (W + pad_w) // tiles_x
    lut = _tile_luts(xp, tiles_y, tiles_x, th, tw, clip_limit).reshape(N, -1)

    ty1, ty2, ya = _axis_coords(H, th, tiles_y)
    tx1, tx2, xa = _axis_coords(W, tw, tiles_x)
    ya = torch.from_numpy(ya).to(dev)[:, None]
    xa = torch.from_numpy(xa).to(dev)[None, :]

    def gather(tyi, txi):
        base = torch.from_numpy((tyi[:, None] * tiles_x + txi[None, :]) * _BINS).to(dev)
        idx = (base + x).reshape(N, -1)
        return torch.gather(lut, 1, idx).reshape(N, H, W).to(torch.float32)

    g11, g12 = gather(ty1, tx1), gather(ty1, tx2)
    g21, g22 = gather(ty2, tx1), gather(ty2, tx2)
    if th % 2 == 0 and tw % 2 == 0:
        res = (g11 * ((1 - xa) * (1 - ya)) + g12 * (xa * (1 - ya))
               + g21 * ((1 - xa) * ya) + g22 * (xa * ya))
    else:
        res = (g11 * (1 - xa) * (1 - ya) + g12 * xa * (1 - ya)
               + g21 * (1 - xa) * ya + g22 * xa * ya)
    return torch.clamp(torch.round(res), 0, 255).reshape(lead + (H, W))
