"""Diameter, thickness and defect geometry as batched tensor reductions
(counterpart of unet_tpu/ops/geometry.py).

Every measurement is a fixed-shape reduction over (..., H, W) masks, so a
batch is measured in the same step as the forward and nothing is read back
to the host:
  * per-row widths: a first-max argmax along the row
  * the median over valid rows: a sort with the invalid entries at +max
  * the largest-component denoise: ops.cc.largest_component (kernel B1)
  * holes: a morphological close minus the tape, then ops.cc

The JAX package runs these inside its jitted step, where XLA turns a
division by a Python constant into a product with its float32 reciprocal;
the coverages here compute that form (`recip32`), so they equal the jitted
JAX step bit for bit. Divisions by a tensor stay true divisions, as there.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from unet_tpu_torch.ops import cc as _cc
from unet_tpu_torch.ops import morph as _morph
from unet_tpu_torch.ops.image import filter1d, gaussian_kernel1d, recip32, resize_nearest


def width_per_row(mask: torch.Tensor) -> torch.Tensor:
    """Per-row horizontal extent (max_x - min_x + 1), 0 for empty rows.
    mask: (..., H, W) -> (..., H) float32."""
    m = mask.to(torch.uint8)
    W = m.shape[-1]
    first = torch.argmax(m, dim=-1)
    last = W - 1 - torch.argmax(torch.flip(m, dims=(-1,)), dim=-1)
    w = (last - first + 1).to(torch.float32)
    return torch.where(mask.to(torch.bool).any(dim=-1), w, 0.0)


def smooth_widths(widths: torch.Tensor, ksize: int = 31) -> torch.Tensor:
    """Gaussian smoothing of a width profile: cv2.GaussianBlur((1, k), 0) on
    the (H, 1) column (reference src/utils/geometry.py:21-25)."""
    if ksize <= 1:
        return widths
    k = ksize if ksize % 2 == 1 else ksize + 1
    return filter1d(widths, gaussian_kernel1d(k, 0.0), axis=widths.ndim - 1)


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """np.median(x[valid]) along the last axis with fixed shapes: the
    invalid entries sort to float32's max and the (n-1)/2, n/2 pair is
    read. 0.0 where nothing is valid."""
    big = float(np.finfo(np.float32).max)
    n = valid.sum(dim=-1)
    s = torch.sort(torch.where(valid, x, big), dim=-1).values
    hi_i = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    lo_i = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    lo = s.gather(-1, lo_i[..., None])[..., 0]
    hi = s.gather(-1, hi_i[..., None])[..., 0]
    return torch.where(n > 0, 0.5 * (lo + hi), 0.0)


class DiameterMetrics(NamedTuple):
    """Per-frame diameters (reference geometry_enhanced.py:18-34); every
    field (...,)-shaped."""
    dc_px: torch.Tensor
    dt_px: torch.Tensor
    delta_d_px: torch.Tensor
    dc_mm: torch.Tensor
    dt_mm: torch.Tensor
    delta_d_mm: torch.Tensor
    valid_rows: torch.Tensor
    cable_coverage: torch.Tensor
    tape_coverage: torch.Tensor


def diameter_metrics(pred_mask: torch.Tensor, cable_cls: int = 1, tape_cls: int = 2,
                     mm_per_px: float = 0.05, min_valid_rows: int = 20,
                     cc_min_area: int = 50, smooth_ksize: int = 31,
                     denoise: bool = True) -> DiameterMetrics:
    """compute_diameter_metrics (reference geometry_enhanced.py:113-185):
    largest-component denoise, smoothed per-row widths, the median over rows
    holding both cable and tape; zero when fewer than `min_valid_rows`."""
    cable = pred_mask == cable_cls
    tape = pred_mask == tape_cls
    if denoise:
        cable = _cc.largest_component(cable, min_area=cc_min_area)
        tape = _cc.largest_component(tape, min_area=cc_min_area)
    return diameter_metrics_from_masks(cable, tape, mm_per_px=mm_per_px,
                                       min_valid_rows=min_valid_rows,
                                       smooth_ksize=smooth_ksize)


def largest_component_lowres(mask_lowres: torch.Tensor, frame_hw,
                             min_area: int = 50) -> torch.Tensor:
    """The largest component found at model resolution, resized (nearest)
    to `frame_hw`, with the `min_area` floor applied in frame pixels.
    Nearest upscaling keeps the partition and the order of the areas, so
    this equals `largest_component` at frame resolution."""
    kept = _cc.largest_component(mask_lowres, min_area=0)
    big = resize_nearest(kept, frame_hw, channel_dim=False)
    area = big.sum(dim=(-2, -1))
    return big & (area >= min_area)[..., None, None]


def diameter_metrics_from_masks(cable: torch.Tensor, tape: torch.Tensor,
                                mm_per_px: float = 0.05, min_valid_rows: int = 20,
                                smooth_ksize: int = 31) -> DiameterMetrics:
    """`diameter_metrics` on masks already denoised (the step denoises at
    model resolution with `largest_component_lowres` where it can)."""
    inv_hw = recip32(cable.shape[-2] * cable.shape[-1])
    cable_cov = cable.sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32) * inv_hw
    tape_cov = tape.sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32) * inv_hw

    wc = smooth_widths(width_per_row(cable), smooth_ksize)
    wt = smooth_widths(width_per_row(tape), smooth_ksize)
    valid = (wc > 0) & (wt > 0)
    n_valid = valid.sum(dim=-1, dtype=torch.int32)

    enough = n_valid >= min_valid_rows
    dc = torch.where(enough, masked_median(wc, valid), 0.0)
    dt = torch.where(enough, masked_median(wt, valid), 0.0)
    dd = dt - dc
    return DiameterMetrics(
        dc_px=dc, dt_px=dt, delta_d_px=dd,
        dc_mm=dc * mm_per_px, dt_mm=dt * mm_per_px, delta_d_mm=dd * mm_per_px,
        valid_rows=n_valid, cable_coverage=cable_cov, tape_coverage=tape_cov)


class ThicknessProfile(NamedTuple):
    """Per-row thickness increment (reference geometry_enhanced.py:37-42)."""
    delta_d_mm: torch.Tensor  # (..., H)
    valid: torch.Tensor       # (..., H) bool


def thickness_profile(pred_mask: torch.Tensor, cable_cls: int = 1, tape_cls: int = 2,
                      mm_per_px: float = 0.05, smooth_ksize: int = 31) -> ThicknessProfile:
    """compute_thickness_profile (reference geometry_enhanced.py:188-225),
    without a component denoise, as the reference."""
    wc = smooth_widths(width_per_row(pred_mask == cable_cls), smooth_ksize)
    wt = smooth_widths(width_per_row(pred_mask == tape_cls), smooth_ksize)
    return ThicknessProfile(delta_d_mm=(wt - wc) * mm_per_px, valid=(wc > 0) & (wt > 0))


def diameter_profile(pred_mask: torch.Tensor, cable_cls: int, wrap_cls: int,
                     smooth_ksize: int = 31):
    """diameter_profile_from_masks (reference src/utils/geometry.py:28-64):
    largest components (no area floor), smoothed widths, joint validity.
    Returns (w_cable, w_wrap, valid), each (..., H)."""
    wc = smooth_widths(width_per_row(_cc.largest_component(pred_mask == cable_cls)),
                       smooth_ksize)
    ww = smooth_widths(width_per_row(_cc.largest_component(pred_mask == wrap_cls)),
                       smooth_ksize)
    return wc, ww, (wc > 0) & (ww > 0)


class DefectAnalysis(NamedTuple):
    """Per-frame defect analysis (reference geometry_enhanced.py:228-243)."""
    tape_hole_ratio: torch.Tensor
    tape_num_holes: torch.Tensor
    tape_coverage: torch.Tensor
    cable_num_components: torch.Tensor
    tape_num_components: torch.Tensor
    tape_largest_area_ratio: torch.Tensor
    defect_areas: torch.Tensor        # (..., n_defect_classes)
    total_defect_area: torch.Tensor


def analyze_defects(pred_mask: torch.Tensor, cable_cls: int = 1, tape_cls: int = 2,
                    defect_classes: Sequence[int] = (3, 4, 5, 6),
                    hole_min_size: int = 10,
                    max_components: int = 64) -> DefectAnalysis:
    """analyze_defects (reference geometry_enhanced.py:246-330): holes are
    close(tape, ellipse 5x5) minus the tape, kept from `hole_min_size`
    pixels; component counts stop at `max_components`. Counts are int32."""
    tape = pred_mask == tape_cls
    cable = pred_mask == cable_cls
    hw = pred_mask.shape[-2] * pred_mask.shape[-1]
    lead = pred_mask.shape[:-2]
    flat = lambda t: t.reshape(-1, *t.shape[-2:])
    tape_area = tape.sum(dim=(-2, -1), dtype=torch.int32)
    tape_div = tape_area.clamp(min=1).to(torch.float32)

    se5 = _morph.structuring_element(_morph.ELLIPSE, (5, 5))
    holes = _morph.close_(tape, se5) & ~tape
    # the areas of the largest components only: component_stats' bounding
    # boxes and centroids would cost six more scatters a mask
    top = lambda m: _cc._top_components(
        _cc._areas(*_cc._scatter_bins(flat(_cc.connected_components(m)))), max_components)[0]
    hole_area = top(holes)
    hole_ok = hole_area >= max(hole_min_size, 1)
    num_holes = hole_ok.sum(-1, dtype=torch.int32).reshape(lead)
    hole_sum = torch.where(hole_ok, hole_area, 0).sum(-1, dtype=torch.int32).reshape(lead)

    tape_top = top(tape)
    tape_ncc = (tape_top > 0).sum(-1, dtype=torch.int32).reshape(lead)
    largest = tape_top[:, 0].reshape(lead)   # the top-k's first entry: the largest area

    d_areas = torch.stack([(pred_mask == c).sum(dim=(-2, -1), dtype=torch.int32)
                           for c in defect_classes], dim=-1)
    return DefectAnalysis(
        tape_hole_ratio=hole_sum.to(torch.float32) / tape_div,
        tape_num_holes=num_holes,
        tape_coverage=tape_area.to(torch.float32) * recip32(hw),
        cable_num_components=_cc.count_components(cable, max_components=max_components),
        tape_num_components=tape_ncc,
        tape_largest_area_ratio=torch.where(tape_ncc > 0, largest.to(torch.float32) / tape_div,
                                            0.0),
        defect_areas=d_areas,
        total_defect_area=d_areas.sum(dim=-1, dtype=torch.int32))
