"""Failure-detection / robustness gates (counterpart of
unet_tpu/inspect/detectors.py; SURVEY §5 'Failure detection').

Host-side state machines over device-computed per-frame scalars:
  * EventDetector    — consecutive-frame counters + per-event cooldown
                       (reference src/refactor/event_detector.py:24-175)
  * EventGate        — N-consecutive confirmation + wall-clock cooldown
                       (reference infer_video_robust.py:219-239)
  * DefectTracker    — IoU-matched multi-frame defect confirmation
                       (reference infer_video_optimized.py:66-189)
  * FrameQualityGate — blur/flat/motion gating; the heavy stats (Laplacian
                       variance, gray std, frame-diff MAD) come from the
                       device via `quality_stats` (reference infer_video.py:73-118)
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from unet_tpu_torch.ops import edges as _edges


@dataclass
class FrameMetrics:
    """Per-frame scalars for EventDetector (reference event_detector.py:12-22)."""
    frame_id: int
    dc_px: float
    dt_px: float
    delta_d_px: float
    ratio: Optional[float]
    has_burr: bool
    cable_coverage: float
    tape_coverage: float


@dataclass
class EventConfig:
    """Reference src/refactor/config.py EventConfig fields used by the detector."""
    ratio_min: float = 1.05
    ratio_max: float = 1.5
    thin_wrap_frames: int = 3
    thick_wrap_frames: int = 3
    burr_frames: int = 3
    cooldown_frames: int = 30
    uniformity_window: int = 30


class EventDetector:
    """Consecutive-frame event triggering with cooldown
    (reference event_detector.py:24-175)."""

    def __init__(self, cfg: EventConfig):
        self.cfg = cfg
        self.history: List[FrameMetrics] = []
        self.last_event_frame: Dict[str, int] = {}
        self._counts = {"thin_wrap": 0, "thick_wrap": 0, "burr": 0}

    def _check(self, name: str, active: bool, need: int, frame_id: int,
               out: List[str]) -> None:
        if active:
            self._counts[name] += 1
            if self._counts[name] >= need and self._can_trigger(name, frame_id):
                out.append(name)
                self.last_event_frame[name] = frame_id
                self._counts[name] = 0
        else:
            self._counts[name] = 0

    def add_frame(self, m: FrameMetrics) -> List[str]:
        self.history.append(m)
        if len(self.history) > self.cfg.uniformity_window:
            self.history.pop(0)
        out: List[str] = []
        self._check("thin_wrap", m.ratio is not None and m.ratio < self.cfg.ratio_min,
                    self.cfg.thin_wrap_frames, m.frame_id, out)
        self._check("thick_wrap", m.ratio is not None and m.ratio > self.cfg.ratio_max,
                    self.cfg.thick_wrap_frames, m.frame_id, out)
        self._check("burr", m.has_burr, self.cfg.burr_frames, m.frame_id, out)
        return out

    def _can_trigger(self, event_type: str, current_frame: int) -> bool:
        last = self.last_event_frame.get(event_type)
        return last is None or current_frame - last >= self.cfg.cooldown_frames

    def compute_uniformity(self) -> Optional[float]:
        ratios = [m.ratio for m in self.history if m.ratio is not None]
        if len(self.history) < 2 or len(ratios) < 2:
            return None
        return float(np.std(ratios))

    def get_recent_metrics(self, n: int = 10) -> List[FrameMetrics]:
        return self.history[-n:]

    def get_average_ratio(self, n: int = 10) -> Optional[float]:
        ratios = [m.ratio for m in self.get_recent_metrics(n) if m.ratio is not None]
        return float(np.mean(ratios)) if ratios else None

    def reset(self) -> None:
        self.history.clear()
        self.last_event_frame.clear()
        self._counts = {k: 0 for k in self._counts}


class EventGate:
    """All-of-last-N confirmation + time cooldown
    (reference infer_video_robust.py:219-239)."""

    def __init__(self, hold_frames: int = 8, cooldown_sec: float = 3.0,
                 clock=time.time):
        self.hold_frames = hold_frames
        self.cooldown_sec = cooldown_sec
        self.hist: deque = deque(maxlen=hold_frames)
        # -inf, not 0: with a video-time clock (engine) t starts near 0 and
        # a zero initial last_fire would swallow the first event
        self.last_fire = float("-inf")
        self._clock = clock

    def update(self, is_abnormal: bool) -> None:
        self.hist.append(1 if is_abnormal else 0)

    def should_fire(self) -> bool:
        if len(self.hist) < self.hold_frames or sum(self.hist) < self.hold_frames:
            return False
        now = self._clock()
        if now - self.last_fire < self.cooldown_sec:
            return False
        self.last_fire = now
        return True


def bbox_iou(a: Tuple[float, float, float, float],
             b: Tuple[float, float, float, float]) -> float:
    x0 = max(a[0], b[0]); y0 = max(a[1], b[1])
    x1 = min(a[2], b[2]); y1 = min(a[3], b[3])
    if x1 <= x0 or y1 <= y0:
        return 0.0
    inter = (x1 - x0) * (y1 - y0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / union if union > 0 else 0.0


class DefectTracker:
    """IoU-matched multi-frame defect confirmation with persistence-based
    confidence and stale-track pruning (reference infer_video_optimized.py:66-189).
    Detections are dicts {class_id, bbox, area} — e.g. straight from
    ops.cc.component_stats of the defect mask."""

    def __init__(self, confirm_frames: int = 3, iou_threshold: float = 0.3,
                 stale_frames: int = 10, class_names: Optional[Dict[int, str]] = None):
        self.confirm_frames = confirm_frames
        self.iou_threshold = iou_threshold
        self.stale_frames = stale_frames
        self.class_names = class_names or {}
        self.active: Dict[str, dict] = {}
        self._next_id = 0

    def update(self, detections: List[dict], frame_idx: int) -> List[dict]:
        confirmed: List[dict] = []
        seen = set()
        for det in detections:
            matched = False
            for tid, tr in self.active.items():
                if tr["class_id"] != det["class_id"]:
                    continue
                if bbox_iou(det["bbox"], tr["bbox"]) >= self.iou_threshold:
                    tr["frames"].append(frame_idx)
                    tr["bbox"] = det["bbox"]
                    tr["area"] = det["area"]
                    tr["count"] += 1
                    seen.add(tid)
                    if tr["count"] >= self.confirm_frames:
                        confidence = min(0.95, 0.5 + tr["count"] / self.confirm_frames * 0.3)
                        confirmed.append({
                            "defect_id": tid, "type": tr["type"],
                            "class_id": tr["class_id"], "bbox": det["bbox"],
                            "area": det["area"], "confidence": confidence,
                            "start_frame": tr["frames"][0], "duration": tr["count"],
                        })
                    matched = True
                    break
            if not matched:
                tid = f"{det['class_id']}_{frame_idx}_{self._next_id}"
                self._next_id += 1
                self.active[tid] = {
                    "class_id": det["class_id"],
                    "type": self.class_names.get(det["class_id"], f"class_{det['class_id']}"),
                    "frames": deque([frame_idx], maxlen=self.confirm_frames + 5),
                    "bbox": det["bbox"], "area": det["area"], "count": 1,
                }
        for tid in [t for t, tr in self.active.items()
                    if t not in seen and frame_idx - tr["frames"][-1] > self.stale_frames]:
            del self.active[tid]
        return confirmed


@dataclass
class QualityResult:
    is_bad: bool
    lap_var: float
    gray_std: float
    mad: float
    reason: str


class FrameQualityGate:
    """Blur / flat / glitch / motion gating (reference infer_video.py:73-118).
    Feed it the device-computed stats from `quality_stats` below."""

    def __init__(self, enable: bool = True, blur_th: float = 80.0,
                 flat_th: float = 8.0, motion_th: float = 10.0,
                 glitch_flat_th: float = 3.0):
        self.enable = enable
        self.blur_th = blur_th
        self.flat_th = flat_th
        self.motion_th = motion_th
        self.glitch_flat_th = glitch_flat_th

    def check(self, lap_var: float, gray_std: float, mad: float) -> QualityResult:
        if not self.enable:
            return QualityResult(False, lap_var, gray_std, mad, "disabled")
        if gray_std < self.glitch_flat_th:
            return QualityResult(True, lap_var, gray_std, mad,
                                 "revealed_glitch_frame(std<glitch_flat_th)")
        if lap_var < self.blur_th and mad > self.motion_th:
            return QualityResult(True, lap_var, gray_std, mad,
                                 "motion_blur(lap<th & mad>th)")
        if gray_std < self.flat_th:
            return QualityResult(True, lap_var, gray_std, mad, "too_flat(std<flat_th)")
        return QualityResult(False, lap_var, gray_std, mad, "ok")


def quality_stats(gray: torch.Tensor, prev_gray: Optional[torch.Tensor] = None):
    """The quality gate's statistics of a frame batch, on the device of
    `gray`: per-frame Laplacian variance, gray std, and mean-abs-diff vs the
    previous frame (within-batch shift; the first frame diffs against
    `prev_gray`, or against itself). gray: (B, H, W) float. Returns
    (lap_var, gray_std, mad), each (B,); variances are the population's."""
    lap = _edges.laplacian(gray)
    lap_var = torch.var(lap, dim=(-2, -1), unbiased=False)
    gray_std = torch.std(gray, dim=(-2, -1), unbiased=False)
    prev = torch.cat([gray[:1] if prev_gray is None else prev_gray[None], gray[:-1]], dim=0)
    mad = torch.mean(torch.abs(gray - prev), dim=(-2, -1))
    return lap_var, gray_std, mad
