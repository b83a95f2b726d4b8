"""Host-side visualization: palettes, overlays, HUD, comparison grids
(counterpart of unet_tpu/pipeline/visualize.py).

numpy frames and class maps on the host, drawn with OpenCV (`cv2`, imported
where it is used), mirroring:
  * colorize/overlay (reference src/infer/visualize.py:7-24)
  * 7-class palette + names, bbox draw, side-by-side comparison
    (reference src/utils/visualizer.py:13-268)
  * the two-stage ROI-dim + per-class blend + contours look
    (reference infer_two_stage_burr.py:130-170)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# BGR palettes (reference src/utils/visualizer.py:13-32 and
# infer_two_stage_burr.py:22-27)
PALETTE_7 = {0: (0, 0, 0), 1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255),
             4: (255, 255, 0), 5: (255, 0, 255), 6: (0, 165, 255)}
CLASS_NAMES_7 = {0: "background", 1: "cable", 2: "tape", 3: "bulge",
                 4: "loose", 5: "damage", 6: "thin"}
TWO_STAGE_COLORS = {0: (0, 0, 0), 1: (0, 255, 0), 2: (255, 0, 0), 3: (255, 0, 255)}


def colorize_mask(mask: np.ndarray, palette: Dict[int, tuple] = None) -> np.ndarray:
    """Class-id mask -> BGR color image (reference src/infer/visualize.py:7-12)."""
    palette = palette or PALETTE_7
    out = np.zeros(mask.shape + (3,), np.uint8)
    for cls, color in palette.items():
        if cls == 0:
            continue
        out[mask == cls] = color
    return out


def overlay(frame_bgr: np.ndarray, mask: np.ndarray, alpha: float = 0.5,
            palette: Dict[int, tuple] = None) -> np.ndarray:
    """Blend colors only where mask > 0 (reference src/infer/visualize.py:15-24,
    infer_video.py overlay_mask fix for whole-frame dimming)."""
    color = colorize_mask(mask, palette)
    out = frame_bgr.copy()
    region = mask > 0
    out[region] = (frame_bgr[region] * (1 - alpha) + color[region] * alpha).astype(np.uint8)
    return out


def draw_bboxes(frame_bgr: np.ndarray, boxes: Sequence[dict],
                names: Dict[int, str] = None) -> np.ndarray:
    """Draw labeled defect boxes (reference src/utils/visualizer.py bbox draw)."""
    import cv2
    names = names or CLASS_NAMES_7
    out = frame_bgr.copy()
    for b in boxes:
        x0, y0, x1, y1 = [int(v) for v in b["bbox"]]
        cls = b.get("class_id", 0)
        color = PALETTE_7.get(cls, (255, 255, 255))
        cv2.rectangle(out, (x0, y0), (x1, y1), color, 2)
        label = b.get("type", names.get(cls, str(cls)))
        if "confidence" in b:
            label += f" {b['confidence']:.2f}"
        cv2.putText(out, label, (x0, max(y0 - 5, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return out


def two_stage_overlay(frame_bgr: np.ndarray, class_map: np.ndarray,
                      roi: Optional[Tuple[int, int, int, int]] = None,
                      draw_roi_box: bool = True) -> np.ndarray:
    """The reference two-stage look (infer_two_stage_burr.py:130-170):
    dim outside ROI, blend cable/tape/burr, draw contours + ROI box.
    class_map values: 0 bg / 1 cable / 2 tape / 3 burr."""
    import cv2
    result = frame_bgr.copy()
    h, w = frame_bgr.shape[:2]
    if roi is not None:
        x1, y1, x2, y2 = roi
        dim = result.copy()
        sel = np.ones((h, w), bool)
        sel[y1:y2, x1:x2] = False
        dim[sel] = 0
        result = cv2.addWeighted(result, 0.7, dim, 0.3, 0)

    for cls, (alpha_r, alpha_o) in ((1, (0.6, 0.4)), (2, (0.6, 0.4)), (3, (0.5, 0.5))):
        layer = np.zeros_like(result)
        layer[class_map == cls] = TWO_STAGE_COLORS[cls]
        result = cv2.addWeighted(result, alpha_r, layer, alpha_o, 0)

    if roi is not None and draw_roi_box:
        x1, y1, x2, y2 = roi
        cv2.rectangle(result, (x1, y1), (x2, y2), (0, 255, 255), 2)
        cv2.putText(result, "ROI", (x1 + 5, y1 + 25),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 255), 2)

    for cls, color, thick in ((1, (0, 255, 0), 2), (2, (255, 0, 0), 2),
                              (3, (255, 0, 255), 3)):
        m = (class_map == cls).astype(np.uint8)
        if m.any():
            contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            cv2.drawContours(result, contours, -1, color, thick)
    return result


def draw_hud(frame_bgr: np.ndarray, lines: Sequence[str]) -> np.ndarray:
    """White-on-black double-stroke HUD text
    (reference infer_two_stage_burr.py:345-348)."""
    import cv2
    out = frame_bgr
    for i, text in enumerate(lines):
        y = 30 + 30 * i
        cv2.putText(out, text, (10, y), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
        cv2.putText(out, text, (10, y), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 1)
    return out


def comparison_image(original_bgr: np.ndarray, pred_mask: np.ndarray,
                     gt_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Side-by-side original | pred(|GT) grid
    (reference src/utils/visualizer.py:217-268)."""
    panels = [original_bgr, overlay(original_bgr, pred_mask)]
    if gt_mask is not None:
        panels.append(overlay(original_bgr, gt_mask))
    return np.concatenate(panels, axis=1)
