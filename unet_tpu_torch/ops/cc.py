"""Connected components (counterpart of unet_tpu/ops/cc.py:148-182,
219-352, 420-554).

`connected_components` labels each foreground pixel with its component's
minimum row-major linear index r*W + c, the root (-1 on background): one
propagation of the label seed (ops.cc_kernels.propagate, pool_iters=16, the
CUDA kernel on the card). `component_stats` is the fixed-size top-K
analogue of cv2.connectedComponentsWithStats, from scatters into one bin
per pixel index, read back at the roots; `keep_mask`, `largest_component`
and `count_components` build on the same bins. Nothing here reads a value
back to the host, so a step that calls them queues its work without
waiting.

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

from typing import NamedTuple, Tuple

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

    # the pixel count of each pixel's component
    bins, fgf = _scatter_bins(labels)
    area_px = _areas(bins, fgf).gather(1, bins).reshape(B, H, W)
    keep = keep & (area_px >= min_area) & (area_px <= max_area)
    return keep.reshape(lead + (H, W))


# ---------------------------------------------------------------------------
# labels and per-component statistics
# ---------------------------------------------------------------------------

def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 64) -> torch.Tensor:
    """Label (..., H, W) foreground masks: each foreground pixel gets the
    minimum linear index (r*W + c) of its component, background -1 (int32).
    The labels, not only the partition, equal the JAX package's: both run
    the same schedule from the same seed, also where `max_iters` cuts it."""
    lead = mask.shape[:-2]
    H, W = mask.shape[-2:]
    fg = mask.reshape(-1, H, W).to(torch.bool).contiguous()
    state0 = _label_seed(H, W, fg.device).expand(fg.shape[0], 1, H, W).contiguous()
    out = cc_kernels.propagate(state0, fg, pool_iters=16, max_iters=max_iters,
                               connectivity=connectivity)
    return torch.where(fg, out[:, 0], -1).reshape(lead + (H, W))


class ComponentStats(NamedTuple):
    """Fixed-size (top-K by area) analogue of cv2.connectedComponentsWithStats.
    Fields are (..., K); `valid` marks real components (area > 0) and `num`
    (...,) counts them. bbox fields follow cv2's CC_STAT_* (left/top
    inclusive, width/height in pixels); `cx`/`cy` are float centroids."""
    label: torch.Tensor   # root linear index of the component, -1 if not valid
    area: torch.Tensor
    left: torch.Tensor
    top: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    valid: torch.Tensor
    num: torch.Tensor


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


def _top_components(area: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of (N, H*W) `_areas`: their areas (int32)
    and root labels (int64, -1 past the last component). Ties go to the
    lower label, as jax.lax.top_k orders them: the rank key
    area * (hw + 1) + (hw - label) is unique, so the top-k's own order on
    ties never enters."""
    hw = area.shape[1]
    idx = torch.arange(hw, dtype=torch.int64, device=area.device)
    lab = (area.to(torch.int64) * (hw + 1) + (hw - idx)).topk(k, dim=-1).indices
    top_area = area.gather(1, lab)
    return top_area, torch.where(top_area > 0, lab, -1)


def component_stats(labels: torch.Tensor, max_components: int = 32) -> ComponentStats:
    """Top-`max_components` (by area) component statistics of a (..., H, W)
    label map. Row and column sums are taken in int64 and turned into
    float32 once: a float32 sum in another order differs once it passes
    2**24, so the centroids are the exactly rounded ones (the JAX package
    adds in float32, in order: equal below 2**24)."""
    lead = labels.shape[:-2]
    H, W = labels.shape[-2:]
    hw = H * W
    lab = labels.reshape(-1, H, W)
    N, dev = lab.shape[0], lab.device
    bins, fg = _scatter_bins(lab)
    top_area, top_lab = _top_components(_areas(bins, fg), max_components)
    valid = top_area > 0
    pix = torch.arange(hw, dtype=torch.int64, device=dev).expand(N, hw)
    rows, cols = pix // W, pix % W

    def reduce(src, how, init):
        acc = torch.full((N, hw), init, dtype=torch.int64, device=dev)
        acc.scatter_reduce_(1, bins, src, how)
        return acc.gather(1, top_lab.clamp(min=0))

    min_r, max_r = reduce(rows, "amin", hw), reduce(rows, "amax", -1)
    min_c, max_c = reduce(cols, "amin", hw), reduce(cols, "amax", -1)
    sum_r, sum_c = reduce(rows, "sum", 0), reduce(cols, "sum", 0)
    af = top_area.clamp(min=1).to(torch.float32)
    i32 = lambda t: torch.where(valid, t, 0).to(torch.int32)
    stats = ComponentStats(
        label=top_lab.to(torch.int32), area=top_area,
        left=i32(min_c), top=i32(min_r),
        width=i32(max_c - min_c + 1), height=i32(max_r - min_r + 1),
        cx=torch.where(valid, sum_c.to(torch.float32) / af, 0.0),
        cy=torch.where(valid, sum_r.to(torch.float32) / af, 0.0),
        valid=valid, num=valid.sum(-1, dtype=torch.int32))
    return ComponentStats(*(t.reshape(lead + t.shape[1:]) for t in stats))


def _keep(bins: torch.Tensor, comp_label: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(N, H*W) bool: the pixels (by their `_scatter_bins` bins) whose
    component's flag in `keep` (N, K) is set, `comp_label` (N, K) naming
    the components (-1: none). One scatter into a flag per pixel index, one
    gather; a background pixel reads its own index, never a root's."""
    flag = torch.zeros(bins.shape, dtype=torch.int32, device=bins.device)
    flag.scatter_reduce_(1, comp_label.clamp(min=0).to(torch.int64),
                         (keep & (comp_label >= 0)).to(torch.int32), "amax")
    return flag.gather(1, bins).to(torch.bool)


def keep_mask(labels: torch.Tensor, stats: ComponentStats, keep: torch.Tensor) -> torch.Tensor:
    """Pixel mask of the components of (..., H, W) `labels` whose
    per-component `keep` (..., K) flag is set, among `stats`' valid ones."""
    lead = labels.shape[:-2]
    H, W = labels.shape[-2:]
    k = stats.label.shape[-1]
    bins, _ = _scatter_bins(labels.reshape(-1, H, W))
    out = _keep(bins, stats.label.reshape(-1, k), (keep & stats.valid).reshape(-1, k))
    return out.reshape(lead + (H, W))


def largest_component(mask: torch.Tensor, min_area: int = 0, connectivity: int = 8,
                      max_iters: int = 64) -> torch.Tensor:
    """Largest connected component of a (..., H, W) binary mask; all False
    where the largest is smaller than `min_area` (floored at 1). Of equal
    areas, the component with the lower root label."""
    lead = mask.shape[:-2]
    H, W = mask.shape[-2:]
    bins, fg = _scatter_bins(connected_components(mask, connectivity, max_iters)
                             .reshape(-1, H, W))
    area, lab = _top_components(_areas(bins, fg), 1)
    return _keep(bins, lab, area >= max(min_area, 1)).reshape(lead + (H, W))


def count_components(mask: torch.Tensor, connectivity: int = 8,
                     max_components: int = 64, max_iters: int = 64) -> torch.Tensor:
    """Number of connected components of a (..., H, W) mask (background
    excluded), clipped at `max_components`: int32 (...,)."""
    lead = mask.shape[:-2]
    H, W = mask.shape[-2:]
    labels = connected_components(mask, connectivity, max_iters).reshape(-1, H, W)
    n = (_areas(*_scatter_bins(labels)) > 0).sum(-1, dtype=torch.int32)
    return n.clamp(max=max_components).reshape(lead)
