"""Frozen copy of the port's `ops/cc.py`, run on its plain routes, for the
benchmark's reference; it imports nothing of the port.

The burr stage's component filter (counterpart of unet_tpu/ops/cc.py).

`filter_components_by_geometry` is the burr stage's CC area/aspect/size
filter (reference infer_two_stage_burr.py:100-119). One propagation of four
channels -- label (row-major linear index), -row, col, -col, all segment
minima -- gives every foreground pixel its component's root label and
bounding box (ops.cc_kernels.propagate: the CUDA kernel on the card). The
area comes from an integer count over the labels, the JAX package's own
`single_scatter` route. Its one-hot-matmul area gate and run-head rank
channel are TPU workarounds and are not ported: with this route the port
equals the JAX `UNET_TPU_CC_NO_ONEHOT=1` route even where propagation
truncates, and its default route wherever propagation converges.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernels as cc_kernels


def _label_seed(h: int, w: int, device=None) -> torch.Tensor:
    """Label-channel seed: the row-major linear index idx[r, c] = r*w + c."""
    return torch.arange(h * w, dtype=torch.int32, device=device).reshape(h, w)


def _bbox_seed_state(fg: torch.Tensor) -> torch.Tensor:
    """Seed channels label, -row, col, -col for (B, H, W) fg; returns
    (B, 4, H, W) int32."""
    B, H, W = fg.shape
    rows = torch.arange(H, dtype=torch.int32, device=fg.device)[:, None].expand(H, W)
    cols = torch.arange(W, dtype=torch.int32, device=fg.device)[None, :].expand(H, W)
    seed = torch.stack([_label_seed(H, W, fg.device), -rows, cols, -cols])
    return seed[None].repeat(B, 1, 1, 1)


def filter_components_by_geometry(mask: torch.Tensor, min_area: int, max_area: int,
                                  max_aspect: float = None, min_w: int = 0,
                                  min_h: int = 0, strict_min_wh: bool = False,
                                  max_iters: int = 64) -> torch.Tensor:
    """Keep pixels of (..., H, W) `mask` whose component passes the area,
    aspect and width/height gates of the reference."""
    lead = mask.shape[:-2]
    H, W = mask.shape[-2:]
    fg = mask.reshape(-1, H, W).to(torch.bool).contiguous()
    B = fg.shape[0]
    s = cc_kernels.propagate(_bbox_seed_state(fg), fg, pool_iters=4,
                             max_iters=max_iters)
    labels = torch.where(fg, s[:, 0], -1)
    min_r = torch.where(fg, torch.div(s[:, 0], W, rounding_mode="floor"), 0)
    max_r, min_c, max_c = -s[:, 1], s[:, 2], -s[:, 3]

    width = max_c - min_c + 1
    height = max_r - min_r + 1
    keep = fg
    if max_aspect is not None:
        aspect = (torch.maximum(width, height).to(torch.float32)
                  / (torch.minimum(width, height).to(torch.float32) + 1e-6))
        keep = keep & (aspect < max_aspect)
    if strict_min_wh:
        keep = keep & (width >= min_w) & (height >= min_h)
    else:
        keep = keep & (width > min_w) & (height > min_h)

    # the pixel count of each pixel's component
    bins, fgf = _scatter_bins(labels)
    area_px = _areas(bins, fgf).gather(1, bins).reshape(B, H, W)
    keep = keep & (area_px >= min_area) & (area_px <= max_area)
    return keep.reshape(lead + (H, W))


# ---------------------------------------------------------------------------
# labels and per-component statistics
# ---------------------------------------------------------------------------

def _scatter_bins(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) labels -> ((N, H*W) int64 bins, (N, H*W) foreground). A
    foreground pixel goes to its root label's bin, a background pixel to
    its own index, which is no root: one shared background bin would take
    most of a frame's pixels as atomics on one address. Only the roots'
    bins are read back, and the background adds nothing to them."""
    hw = labels.shape[-2] * labels.shape[-1]
    flat = labels.reshape(labels.shape[0], hw)
    fg = flat >= 0
    own = torch.arange(hw, dtype=torch.int64, device=labels.device)
    return torch.where(fg, flat.to(torch.int64), own), fg


def _areas(bins: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """(N, H*W) int32 pixel count of each root label (0 at every other
    index), from `_scatter_bins`."""
    area = torch.zeros(bins.shape, dtype=torch.int32, device=bins.device)
    return area.scatter_add_(1, bins, fg.to(torch.int32))
