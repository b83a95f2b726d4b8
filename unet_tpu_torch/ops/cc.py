"""Connected-component gates (counterpart of unet_tpu/ops/cc.py:148-182,
420-546).

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

import torch

from unet_tpu_torch.ops import cc_kernels


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
    return seed[None].expand(B, 4, H, W).contiguous()


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

    # per-image pixel count of each root label; background to a spare bin
    hw = H * W
    offs = torch.arange(B, device=fg.device)[:, None, None] * (hw + 1)
    bins = (torch.where(fg, labels, hw).to(torch.int64) + offs).reshape(-1)
    areas = torch.bincount(bins, minlength=B * (hw + 1))
    area_px = areas[bins].reshape(B, H, W)
    keep = keep & (area_px >= min_area) & (area_px <= max_area)
    return keep.reshape(lead + (H, W))
