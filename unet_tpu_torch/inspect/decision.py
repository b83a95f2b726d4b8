"""Simple per-frame metrics and a threshold decision, the lightweight
alternative to the window pipeline (counterpart of
unet_tpu/inspect/decision.py; reference src/infer/postprocess.py:21-73 and
src/infer/decision.py:14-31)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from unet_tpu_torch.ops import geometry as _geo


@dataclass
class Metrics:
    """Reference src/infer/postprocess.py Metrics."""
    mm_per_px: float
    cable_diam_mm_med: float
    wrap_diam_mm_med: float
    delta_mm_max: float
    delta_mm_min: float
    bulge_mm: float
    cv_wrap: float
    defect_area_px: int


@dataclass
class Finding:
    code: str
    severity: str  # P1/P2
    detail: str


@dataclass
class SimpleThresholds:
    """Threshold fields consumed by `decide` (reference src/utils/config.py
    ThresholdCfg)."""
    wrap_delta_max_mm: float = 8.0
    wrap_delta_min_mm: float = 2.0
    bulge_mm: float = 4.0
    cv_wrap: float = 0.12
    defect_area_px: int = 800


def compute_metrics(pred_mask, cable_cls: int, wrap_cls: int,
                    defect_cls: Optional[int], mm_per_px: Optional[float],
                    cable_diameter_mm_known: float) -> Metrics:
    """compute_metrics (reference src/infer/postprocess.py:21-73): median
    diameters, delta extremes, bulge (max - median of wrap), CV, and mm/px
    from the known cable diameter when `mm_per_px` is None. The profiles run
    on the card for a numpy `pred_mask` and on the device of a tensor one,
    the scalar tail in numpy on the host."""
    pred = (pred_mask if isinstance(pred_mask, torch.Tensor)
            else torch.as_tensor(np.asarray(pred_mask)).to("cuda"))
    w_cable, w_wrap, valid = (t.cpu().numpy()
                              for t in _geo.diameter_profile(pred, cable_cls, wrap_cls))
    defect_area = int((pred == defect_cls).sum()) if defect_cls is not None else 0

    if valid.sum() < 20:
        mmpp = mm_per_px if mm_per_px is not None else 0.1
        return Metrics(mmpp, 0, 0, 0, 0, 0, 0, defect_area)

    cable_px_med = float(np.median(w_cable[valid]))
    wrap_px_med = float(np.median(w_wrap[valid]))
    mmpp = (float(cable_diameter_mm_known / max(cable_px_med, 1e-6))
            if mm_per_px is None else float(mm_per_px))

    delta = (w_wrap - w_cable) * mmpp
    wrap_mm = w_wrap * mmpp
    dv, wv = delta[valid], wrap_mm[valid]
    return Metrics(
        mm_per_px=mmpp,
        cable_diam_mm_med=cable_px_med * mmpp,
        wrap_diam_mm_med=wrap_px_med * mmpp,
        delta_mm_max=float(dv.max()),
        delta_mm_min=float(dv.min()),
        bulge_mm=float(wv.max() - np.median(wv)),
        cv_wrap=float(wv.std() / max(wv.mean(), 1e-6)),
        defect_area_px=defect_area,
    )


def decide(metrics: Metrics, thr: SimpleThresholds) -> List[Finding]:
    """Threshold rule table (reference src/infer/decision.py:14-31)."""
    out: List[Finding] = []
    if metrics.delta_mm_max > thr.wrap_delta_max_mm:
        out.append(Finding("wrap_too_large", "P1", f"delta_max={metrics.delta_mm_max:.2f}mm"))
    if metrics.delta_mm_min < thr.wrap_delta_min_mm:
        out.append(Finding("wrap_too_small", "P1", f"delta_min={metrics.delta_mm_min:.2f}mm"))
    if metrics.bulge_mm > thr.bulge_mm:
        out.append(Finding("wrap_bulge", "P2", f"bulge={metrics.bulge_mm:.2f}mm"))
    if metrics.cv_wrap > thr.cv_wrap:
        out.append(Finding("wrap_uneven", "P2", f"cv={metrics.cv_wrap:.3f}"))
    if metrics.defect_area_px > thr.defect_area_px:
        out.append(Finding("cable_damage_or_defect", "P1",
                           f"defect_area={metrics.defect_area_px}px"))
    return out
