"""Wrap-uniformity monitoring: the tape/cable diameter ratio over time
(counterpart of unet_tpu/inspect/uniformity.py; reference
infer_wrap_uniformity.py:33-131 and infer_wrap_7class.py).

`measure_cable_tape_diameter_px(mask, cable_id, tape_id) -> (cable_d_px,
tape_d_px, delta_px) | None` is the contract of the reference's missing
`utils/diameter.py`, from the logic of src/utils/geometry.py:28-64; its
profile runs on the card, or on the device of a tensor mask
(ops.geometry.diameter_profile). The monitor is
host numpy: per-frame ratio Dt/Dc, THIN/THICK thresholds, a rolling-window
std test and CSV logging.
"""
from __future__ import annotations

import csv
from collections import deque
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from unet_tpu_torch.ops import geometry as _geo


def measure_cable_tape_diameter_px(mask, cable_id: int = 1, tape_id: int = 2,
                                   min_valid_rows: int = 10
                                   ) -> Optional[Tuple[float, float, float]]:
    """Median per-row diameters of the largest cable and tape components of
    an (H, W) class map (numpy, sent to the card, or a tensor, which keeps
    its own device); None when fewer than `min_valid_rows` rows hold both."""
    m = mask if isinstance(mask, torch.Tensor) else torch.as_tensor(np.asarray(mask)).to("cuda")
    wc, wt, valid = (t.cpu().numpy() for t in _geo.diameter_profile(m, cable_id, tape_id))
    if valid.sum() < min_valid_rows:
        return None
    cable_d = float(np.median(wc[valid]))
    tape_d = float(np.median(wt[valid]))
    return cable_d, tape_d, tape_d - cable_d


class WrapUniformityMonitor:
    """Ratio thresholds + sliding-window uniformity
    (reference infer_wrap_uniformity.py:33-131). Feed per-frame (dc, dt)
    scalars (e.g. from the pipeline's device geometry outputs)."""

    def __init__(self, ratio_min: float = 1.05, ratio_max: float = 1.5,
                 window_size: int = 30, std_threshold: float = 0.15,
                 csv_path: Optional[str] = None):
        self.ratio_min = ratio_min
        self.ratio_max = ratio_max
        self.window_size = window_size
        self.std_threshold = std_threshold
        self.ratio_history: deque = deque(maxlen=window_size)
        self.csv_path = csv_path
        if csv_path:
            Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
            with open(csv_path, "w", newline="") as f:
                csv.writer(f).writerow(
                    ["frame_id", "cable_d_px", "tape_d_px", "ratio",
                     "is_thin", "is_thick", "is_uniform", "window_std"])

    def update(self, frame_id: int, cable_d_px: float, tape_d_px: float
               ) -> Dict[str, object]:
        """Returns {ratio, is_thin, is_thick, is_uniform, stats|None}."""
        if cable_d_px <= 0:
            result = dict(ratio=None, is_thin=False, is_thick=False,
                          is_uniform=False, stats=None)
            self._log(frame_id, cable_d_px, tape_d_px, result)
            return result
        ratio = tape_d_px / max(1e-6, cable_d_px)
        is_thin = ratio < self.ratio_min
        is_thick = ratio > self.ratio_max
        self.ratio_history.append(ratio)

        is_uniform = False
        stats = None
        if len(self.ratio_history) >= self.window_size:
            ratios = list(self.ratio_history)
            std = float(np.std(ratios))
            in_range = all(self.ratio_min <= r <= self.ratio_max for r in ratios)
            is_uniform = std < self.std_threshold and in_range
            stats = {"mean": float(np.mean(ratios)), "std": std,
                     "min": float(np.min(ratios)), "max": float(np.max(ratios))}
        result = dict(ratio=ratio, is_thin=is_thin, is_thick=is_thick,
                      is_uniform=is_uniform, stats=stats)
        self._log(frame_id, cable_d_px, tape_d_px, result)
        return result

    def _log(self, frame_id, dc, dt, result) -> None:
        if not self.csv_path:
            return
        stats = result["stats"]
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow([
                frame_id, f"{dc:.2f}", f"{dt:.2f}",
                "" if result["ratio"] is None else f"{result['ratio']:.4f}",
                int(result["is_thin"]), int(result["is_thick"]),
                int(result["is_uniform"]),
                "" if stats is None else f"{stats['std']:.4f}"])
