"""Calibration tools: ROI selection + mm/px scale
(counterpart of unet_tpu/tools/calibrate.py).

Headless-friendly equivalents of the reference's interactive UIs
(tools/calibrate_roi.py -> roi.json, tools/calibrate_scale.py 2-click mm/px):
  * two-point scale calculation (the math behind the UI)
  * automatic ROI proposal from a short video: the column band where motion/
    edge energy concentrates (the cable), padded — replaces hand-drawing when
    no operator is present
  * roi.json round-trip compatible with RefactorConfig.ROIConfig
    (reference src/refactor/config.py:12-41)
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def scale_from_two_points(p1: Tuple[float, float], p2: Tuple[float, float],
                          known_mm: float) -> float:
    """mm/px from two clicked points spanning a known distance
    (reference calibrate_scale.py:17-52)."""
    dist_px = math.dist(p1, p2)
    if dist_px <= 0:
        raise ValueError("points coincide")
    return known_mm / dist_px


def save_roi_json(path: str, x: int, y: int, w: int, h: int,
                  mode: str = "fixed") -> None:
    """ROIConfig-compatible roi.json (reference src/refactor/config.py:30-41)."""
    Path(path).write_text(json.dumps(
        {"mode": mode, "x": x, "y": y, "w": w, "h": h}, indent=2))


def load_roi_json(path: str) -> Dict[str, int]:
    return json.loads(Path(path).read_text())


def propose_roi_from_video(video: str, sample_frames: int = 30,
                           pad_frac: float = 0.15,
                           energy_quantile: float = 0.80) -> Dict[str, int]:
    """Automatic vertical-ROI proposal: sample frames, accumulate per-column
    gradient energy, take the contiguous column band above the energy
    quantile, pad by pad_frac. Full height (the reference's ROIs span full
    height, e.g. FIXED_ROI_512)."""
    import cv2
    cap = cv2.VideoCapture(video)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    stride = max(1, total // max(sample_frames, 1))
    energy = None
    h = w = 0
    idx = -1
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        idx += 1
        if idx % stride != 0:
            continue
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
        gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3)
        col = np.abs(gx).mean(axis=0)
        energy = col if energy is None else energy + col
        h, w = gray.shape
    cap.release()
    if energy is None:
        raise RuntimeError("no frames read")
    th = np.quantile(energy, energy_quantile)
    cols = np.nonzero(energy >= th)[0]
    x1, x2 = int(cols.min()), int(cols.max()) + 1
    pad = int((x2 - x1) * pad_frac)
    x1 = max(0, x1 - pad)
    x2 = min(w, x2 + pad)
    return {"mode": "fixed", "x": x1, "y": 0, "w": x2 - x1, "h": h}
