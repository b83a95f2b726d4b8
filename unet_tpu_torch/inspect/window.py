"""Window aggregation and the OK/NG decision (counterpart of
unet_tpu/inspect/window.py; reference src/infer/window_aggregator.py:75-399).

Host-side, on a few scalars per frame: frames accumulate until the window's
duration or `max_frames` is reached, then the window's statistics feed the
rule table of `make_decision`. The per-frame scalars come from the step's
`DiameterMetrics` and `DefectAnalysis` (ops.geometry), tensors on the card
or the CPU, read back by `FrameResult.from_device`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class FrameResult:
    """Per-frame inputs to the aggregator (reference window_aggregator.py:24-39)."""
    timestamp_ns: int
    frame_id: int
    delta_d_mm: float
    dc_mm: float
    dt_mm: float
    cable_coverage: float
    tape_coverage: float
    tape_hole_ratio: float = 0.0
    tape_num_components: int = 0
    total_defect_area: int = 0
    defect_areas: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def from_device(cls, timestamp_ns: int, frame_id: int, diameter,
                    defects=None, index=None) -> "FrameResult":
        """Build from the step's DiameterMetrics / DefectAnalysis, taking
        frame `index` of a batch when given."""
        get = (lambda x: float(_host(x)[index])) if index is not None \
            else (lambda x: float(_host(x)))
        kw = dict(
            timestamp_ns=timestamp_ns, frame_id=frame_id,
            delta_d_mm=get(diameter.delta_d_mm), dc_mm=get(diameter.dc_mm),
            dt_mm=get(diameter.dt_mm),
            cable_coverage=get(diameter.cable_coverage),
            tape_coverage=get(diameter.tape_coverage))
        if defects is not None:
            areas = _host(defects.defect_areas)
            areas = areas[index] if index is not None else areas
            kw.update(
                tape_hole_ratio=get(defects.tape_hole_ratio),
                tape_num_components=int(get(defects.tape_num_components)),
                total_defect_area=int(get(defects.total_defect_area)),
                defect_areas={i + 3: int(a) for i, a in enumerate(areas)})
        return cls(**kw)

@dataclass
class WindowStatistics:
    """Aggregated window stats (reference window_aggregator.py:42-72)."""
    window_id: str
    start_time_ns: int
    end_time_ns: int
    num_frames: int
    delta_d_mean: float
    delta_d_std: float
    delta_d_max: float
    delta_d_min: float
    delta_d_p95: float
    delta_d_range: float
    dc_mean: float
    dt_mean: float
    cable_coverage_mean: float
    tape_coverage_mean: float
    tape_hole_ratio_max: float
    total_defect_area: int
    frames_with_defects: int
    tape_components_avg: float
    tape_components_max: int
    defect_areas_by_class: Dict[int, int] = field(default_factory=dict)


class WindowAggregator:
    """Reference WindowAggregator parity (window_aggregator.py:75-234)."""

    def __init__(self, window_duration_sec: float = 3.0, min_frames: int = 6,
                 max_frames: int = 12):
        self.window_duration_ns = int(window_duration_sec * 1e9)
        self.min_frames = min_frames
        self.max_frames = max_frames
        self.frames: List[FrameResult] = []
        self.window_count = 0

    def reset(self) -> None:
        self.frames = []
        self.window_count += 1

    def add_frame(self, frame: FrameResult) -> None:
        self.frames.append(frame)

    def is_ready(self) -> bool:
        if len(self.frames) < self.min_frames:
            return False
        if len(self.frames) >= self.max_frames:
            return True
        span = self.frames[-1].timestamp_ns - self.frames[0].timestamp_ns
        return span >= self.window_duration_ns

    def get_statistics(self) -> WindowStatistics:
        if not self.frames:
            raise ValueError("no frames in window")
        dd = np.array([f.delta_d_mm for f in self.frames])
        holes = [f.tape_hole_ratio for f in self.frames]
        comps = [f.tape_num_components for f in self.frames]
        by_class: Dict[int, int] = {}
        for f in self.frames:
            for cls, area in f.defect_areas.items():
                by_class[cls] = by_class.get(cls, 0) + area
        return WindowStatistics(
            window_id=f"win_{self.window_count:06d}_{self.frames[0].timestamp_ns}",
            start_time_ns=self.frames[0].timestamp_ns,
            end_time_ns=self.frames[-1].timestamp_ns,
            num_frames=len(self.frames),
            delta_d_mean=float(dd.mean()),
            delta_d_std=float(dd.std()),
            delta_d_max=float(dd.max()),
            delta_d_min=float(dd.min()),
            delta_d_p95=float(np.percentile(dd, 95)),
            delta_d_range=float(dd.max() - dd.min()),
            dc_mean=float(np.mean([f.dc_mm for f in self.frames])),
            dt_mean=float(np.mean([f.dt_mm for f in self.frames])),
            cable_coverage_mean=float(np.mean([f.cable_coverage for f in self.frames])),
            tape_coverage_mean=float(np.mean([f.tape_coverage for f in self.frames])),
            tape_hole_ratio_max=float(np.max(holes)),
            total_defect_area=sum(f.total_defect_area for f in self.frames),
            frames_with_defects=sum(1 for f in self.frames if f.total_defect_area > 0),
            tape_components_avg=float(np.mean(comps)),
            tape_components_max=int(np.max(comps)),
            defect_areas_by_class=by_class,
        )


@dataclass
class ThresholdConfig:
    """Decision thresholds, defaults as reference window_aggregator.py:237-260."""
    target_delta_d: float = 20.0
    delta_d_tolerance: float = 5.0
    delta_d_min_tolerance: float = 3.0
    bulge_delta_max: float = 28.0
    bulge_delta_p95: float = 26.0
    uneven_std_threshold: float = 3.0
    uneven_range_threshold: float = 10.0
    tape_coverage_min: float = 0.3
    tape_hole_ratio_max: float = 0.15
    tape_components_max: int = 5
    defect_area_threshold: int = 500
    defect_frame_ratio: float = 0.5


@dataclass
class DecisionResult:
    window_id: str
    result: str            # "OK" | "NG"
    reasons: List[str]
    severity: str          # "P1" | "P2"
    metrics: Dict[str, Any]
    timestamp: str


def make_decision(stats: WindowStatistics,
                  config: Optional[ThresholdConfig] = None) -> DecisionResult:
    """Rule table parity with reference make_decision
    (window_aggregator.py:277-399): thickness-insufficient / bulge /
    uneven / tape-detach / cable-defect checks with P1/P2 severities."""
    c = config or ThresholdConfig()
    reasons: List[str] = []
    severity = "P2"

    if stats.delta_d_min < c.target_delta_d - c.delta_d_min_tolerance:
        reasons.append(f"thickness_insufficient: ΔD_min={stats.delta_d_min:.2f}mm < "
                       f"{c.target_delta_d - c.delta_d_min_tolerance:.2f}mm")
        severity = "P1"
    if stats.delta_d_mean < c.target_delta_d - c.delta_d_tolerance:
        reasons.append(f"thickness_low_average: ΔD_mean={stats.delta_d_mean:.2f}mm < "
                       f"{c.target_delta_d - c.delta_d_tolerance:.2f}mm")
        severity = "P1"
    if stats.delta_d_max > c.bulge_delta_max:
        reasons.append(f"bulge_detected: ΔD_max={stats.delta_d_max:.2f}mm > "
                       f"{c.bulge_delta_max:.2f}mm")
        severity = "P1"
    if stats.delta_d_p95 > c.bulge_delta_p95:
        reasons.append(f"bulge_p95_exceeded: ΔD_p95={stats.delta_d_p95:.2f}mm > "
                       f"{c.bulge_delta_p95:.2f}mm")
        severity = "P2"
    if stats.delta_d_std > c.uneven_std_threshold:
        reasons.append(f"wrap_uneven_std: ΔD_std={stats.delta_d_std:.2f}mm > "
                       f"{c.uneven_std_threshold:.2f}mm")
        severity = "P2"
    if stats.delta_d_range > c.uneven_range_threshold:
        reasons.append(f"wrap_uneven_range: ΔD_range={stats.delta_d_range:.2f}mm > "
                       f"{c.uneven_range_threshold:.2f}mm")
        severity = "P2"
    if stats.tape_coverage_mean < c.tape_coverage_min:
        reasons.append(f"tape_low_coverage: coverage={stats.tape_coverage_mean:.2%} < "
                       f"{c.tape_coverage_min:.2%}")
        severity = "P1"
    if stats.tape_hole_ratio_max > c.tape_hole_ratio_max:
        reasons.append(f"tape_excessive_holes: hole_ratio={stats.tape_hole_ratio_max:.2%} > "
                       f"{c.tape_hole_ratio_max:.2%}")
        severity = "P1"
    if stats.tape_components_max > c.tape_components_max:
        reasons.append(f"tape_fragmented: components={stats.tape_components_max} > "
                       f"{c.tape_components_max}")
        severity = "P1"
    if stats.total_defect_area > c.defect_area_threshold:
        if stats.frames_with_defects / max(stats.num_frames, 1) > c.defect_frame_ratio:
            reasons.append(f"cable_defect_detected: total_area={stats.total_defect_area}px, "
                           f"frames={stats.frames_with_defects}/{stats.num_frames}")
            severity = "P1"

    return DecisionResult(
        window_id=stats.window_id,
        result="NG" if reasons else "OK",
        reasons=reasons,
        severity=severity,
        metrics={
            "delta_d_mean": round(stats.delta_d_mean, 2),
            "delta_d_std": round(stats.delta_d_std, 2),
            "delta_d_min": round(stats.delta_d_min, 2),
            "delta_d_max": round(stats.delta_d_max, 2),
            "delta_d_range": round(stats.delta_d_range, 2),
            "dc_mean": round(stats.dc_mean, 2),
            "dt_mean": round(stats.dt_mean, 2),
            "tape_coverage": round(stats.tape_coverage_mean, 3),
            "tape_hole_ratio_max": round(stats.tape_hole_ratio_max, 3),
            "defect_area": stats.total_defect_area,
            "num_frames": stats.num_frames,
        },
        timestamp=datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
    )
