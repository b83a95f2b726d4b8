"""Interactive annotation/calibration sessions (mouse UIs)
(counterpart of unet_tpu/tools/interactive.py).

The reference ships three mouse-driven cv2 tools — rectangle burr
annotation (tools/annotate_burr.py:12-140), ROI calibration
(tools/calibrate_roi.py:21-120) and 2-click scale calibration
(tools/calibrate_scale.py:17-52). Those couple the interaction state to
cv2.setMouseCallback/waitKey, which makes them untestable and useless on a
headless host. Here each UI is a pure event-driven state machine with
`on_mouse(event, x, y)` / `on_key(key)` / `render()` methods:

  * the exact interaction logic (drag rectangles, undo/clear/skip keys,
    two-click distance) is unit-testable headlessly by feeding synthetic
    events (tests/test_torch_tools.py);
  * `run_window()` attaches a session to a real cv2 window when a display
    exists (`cli tools annotate --interactive`, `calibrate-roi
    --interactive`, `calibrate-scale --interactive`);
  * outputs go through the same stores as the headless paths —
    tools/annotate.py's burr_annotations.json and tools/calibrate.py's
    roi.json / mm_per_px — so the two drive modes are interchangeable.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unet_tpu_torch.tools import annotate as _store
from unet_tpu_torch.tools import calibrate as _cal

# cv2 mouse-event codes (values fixed by the OpenCV API; kept as module
# constants so tests don't need cv2 imported to synthesize events)
MOUSE_DOWN = 1   # cv2.EVENT_LBUTTONDOWN
MOUSE_UP = 4     # cv2.EVENT_LBUTTONUP
MOUSE_MOVE = 0   # cv2.EVENT_MOUSEMOVE

KEY_SPACE = ord(" ")
# cv2 waitKey arrow codes differ by highgui backend: X11 gives 81/83 and
# Cocoa/Qt give 2/3 — the reference tool matches both
# (annotate_burr.py arrow handling). The X11 codes collide with 'Q'/'S';
# that collision is inherited from the reference's key map.
KEYS_LEFT = (81, 2)
KEYS_RIGHT = (83, 3)
KEY_LEFT = 81     # backwards-compat aliases (tests feed these)
KEY_RIGHT = 83

_GREEN = (0, 255, 0)
_YELLOW = (0, 255, 255)


def list_frames(frames_dir: str) -> List[str]:
    """Sorted image filenames in an extract-frames output dir."""
    p = Path(frames_dir)
    return sorted(f.name for f in p.iterdir()
                  if f.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp"))


class _DragRect:
    """Shared left-drag rectangle mechanics (all three reference tools use
    the same down/move/up pattern, annotate_burr.py:68-91)."""

    def __init__(self):
        self.drawing = False
        self.start: Optional[Tuple[int, int]] = None
        self.temp: Optional[Tuple[int, int, int, int]] = None

    def feed(self, event: int, x: int, y: int) -> Optional[Tuple[int, int, int, int]]:
        """Returns a completed (x1, y1, x2, y2) on MOUSE_UP, else None."""
        if event == MOUSE_DOWN:
            self.drawing = True
            self.start = (x, y)
            self.temp = (x, y, x, y)
        elif event == MOUSE_MOVE and self.drawing:
            self.temp = (*self.start, x, y)
        elif event == MOUSE_UP and self.drawing:
            self.drawing = False
            box = (*self.start, x, y)
            self.temp = None
            return box
        return None


class AnnotationSession:
    """Rectangle burr annotation over a frame directory.

    Key bindings mirror the reference tool (annotate_burr.py:38-47):
    space = save current frame + next, 'u' = undo last box, 'c' = clear
    frame, 's' = save, 'n' = skip (record empty) + next, 'q' = quit,
    left/right arrows = previous/next frame. Boxes persist through
    tools/annotate.py (same burr_annotations.json schema).
    """

    def __init__(self, frames_dir: str, output_dir: str,
                 filenames: Optional[Sequence[str]] = None):
        self.frames_dir = Path(frames_dir)
        self.output_dir = str(output_dir)
        self.filenames = list(filenames if filenames is not None
                              else list_frames(frames_dir))
        if not self.filenames:
            raise ValueError(f"no frames in {frames_dir}")
        self.annotations: Dict[str, dict] = _store.load_annotations(
            self.output_dir)
        self.idx = 0
        self.boxes: List[List[int]] = self._stored_boxes()
        self.drag = _DragRect()
        self.done = False
        self._image: Optional[np.ndarray] = None

    # -- state ------------------------------------------------------------
    def _stored_boxes(self) -> List[List[int]]:
        rec = self.annotations.get(str(self.idx))
        return [list(b) for b in rec["burr_regions"]] if rec else []

    @property
    def filename(self) -> str:
        return self.filenames[self.idx]

    def image(self) -> np.ndarray:
        if self._image is None:
            import cv2
            path = self.frames_dir / self.filename
            im = cv2.imread(str(path))
            if im is None:
                raise RuntimeError(f"cannot read {path}")
            self._image = im
        return self._image

    def _goto(self, idx: int) -> None:
        self.idx = max(0, min(idx, len(self.filenames) - 1))
        self.boxes = self._stored_boxes()
        self._image = None

    def _save(self) -> None:
        _store.add_boxes(self.annotations, self.idx, self.filename,
                         self.boxes, replace=True)
        _store.save_annotations(self.output_dir, self.annotations)

    # -- events -----------------------------------------------------------
    def on_mouse(self, event: int, x: int, y: int) -> None:
        box = self.drag.feed(event, x, y)
        if box is not None:
            x1, y1, x2, y2 = box
            x1, x2 = sorted((x1, x2))
            y1, y2 = sorted((y1, y2))
            # same minimum-size filter as the store/reference (:83-91)
            if (x2 - x1) > _store.MIN_BOX_SIDE and (y2 - y1) > _store.MIN_BOX_SIDE:
                self.boxes.append([x1, y1, x2, y2])

    def on_key(self, key: int) -> str:
        """Returns the action taken (for the window title / tests)."""
        if key == ord("q"):
            # Quit only flushes frames the user actually annotated: saving
            # an empty record for a merely-viewed frame would mark it as a
            # reviewed negative (the reference's 'q' likewise only flushes
            # previously saved records, annotate_burr.py quit handling).
            if self.boxes or str(self.idx) in self.annotations:
                self._save()
            self.done = True
            return "quit"
        if key == KEY_SPACE:
            self._save()
            if self.idx == len(self.filenames) - 1:
                self.done = True
                return "quit"
            self._goto(self.idx + 1)
            return "next"
        if key == ord("u"):
            if self.boxes:
                self.boxes.pop()
            return "undo"
        if key == ord("c"):
            self.boxes = []
            return "clear"
        if key == ord("s"):
            self._save()
            return "save"
        if key == ord("n"):
            self.boxes = []
            self._save()
            if self.idx == len(self.filenames) - 1:
                self.done = True
                return "quit"
            self._goto(self.idx + 1)
            return "skip"
        if key in KEYS_LEFT:
            self._goto(self.idx - 1)
            return "prev"
        if key in KEYS_RIGHT:
            self._goto(self.idx + 1)
            return "next"
        return "noop"

    def render(self) -> np.ndarray:
        import cv2
        disp = self.image().copy()
        for x1, y1, x2, y2 in self.boxes:
            cv2.rectangle(disp, (x1, y1), (x2, y2), _GREEN, 2)
        if self.drag.temp is not None:
            x1, y1, x2, y2 = self.drag.temp
            cv2.rectangle(disp, (x1, y1), (x2, y2), _YELLOW, 1)
        cv2.putText(disp, f"[{self.idx + 1}/{len(self.filenames)}] "
                    f"{self.filename}  boxes={len(self.boxes)}",
                    (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, _GREEN, 1)
        return disp


class RoiCalibrationSession:
    """Drag one rectangle -> ROIConfig-compatible roi.json
    (reference tools/calibrate_roi.py:21-120). Keys: 'r' reset,
    's'/enter save + quit, 'q' quit without saving."""

    def __init__(self, frame: np.ndarray, out_path: str = "roi.json"):
        self.frame = frame
        self.out_path = out_path
        self.roi: Optional[Dict[str, int]] = None
        self.drag = _DragRect()
        self.done = False
        self.saved = False

    def on_mouse(self, event: int, x: int, y: int) -> None:
        box = self.drag.feed(event, x, y)
        if box is not None:
            x1, y1, x2, y2 = box
            x1, x2 = sorted((x1, x2))
            y1, y2 = sorted((y1, y2))
            if x2 > x1 and y2 > y1:
                self.roi = {"x": x1, "y": y1, "w": x2 - x1, "h": y2 - y1}

    def on_key(self, key: int) -> str:
        if key == ord("q"):
            self.done = True
            return "quit"
        if key == ord("r"):
            self.roi = None
            return "reset"
        if key in (ord("s"), 13) and self.roi is not None:  # 13 = enter
            _cal.save_roi_json(self.out_path, self.roi["x"], self.roi["y"],
                               self.roi["w"], self.roi["h"])
            self.saved = True
            self.done = True
            return "save"
        return "noop"

    def render(self) -> np.ndarray:
        import cv2
        disp = self.frame.copy()
        if self.roi is not None:
            r = self.roi
            cv2.rectangle(disp, (r["x"], r["y"]),
                          (r["x"] + r["w"], r["y"] + r["h"]), _GREEN, 2)
        if self.drag.temp is not None:
            x1, y1, x2, y2 = self.drag.temp
            cv2.rectangle(disp, (x1, y1), (x2, y2), _YELLOW, 1)
        cv2.putText(disp, "drag ROI | s/enter=save  r=reset  q=quit",
                    (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, _GREEN, 1)
        return disp


class ScaleCalibrationSession:
    """Two clicks spanning a known distance -> mm/px
    (reference tools/calibrate_scale.py:17-52). 'r' resets the points;
    the session completes itself on the second click."""

    def __init__(self, frame: np.ndarray, known_mm: float):
        self.frame = frame
        self.known_mm = known_mm
        self.points: List[Tuple[int, int]] = []
        self.mm_per_px: Optional[float] = None
        self.done = False

    def on_mouse(self, event: int, x: int, y: int) -> None:
        if event == MOUSE_DOWN and len(self.points) < 2:
            self.points.append((x, y))
            if len(self.points) == 2:
                self.mm_per_px = _cal.scale_from_two_points(
                    self.points[0], self.points[1], self.known_mm)
                self.done = True

    def on_key(self, key: int) -> str:
        if key == ord("q"):
            self.done = True
            return "quit"
        if key == ord("r"):
            self.points = []
            self.mm_per_px = None
            return "reset"
        return "noop"

    def render(self) -> np.ndarray:
        import cv2
        disp = self.frame.copy()
        for p in self.points:
            cv2.circle(disp, p, 5, _GREEN, -1)
        if len(self.points) == 2:
            cv2.line(disp, self.points[0], self.points[1], _GREEN, 1)
            px = math.dist(self.points[0], self.points[1])
            cv2.putText(disp, f"{px:.1f} px = {self.known_mm} mm -> "
                        f"{self.mm_per_px:.5f} mm/px", (8, 44),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, _GREEN, 1)
        cv2.putText(disp, "click two points with known distance | r=reset",
                    (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, _GREEN, 1)
        return disp


def gui_available() -> bool:
    """True when cv2 can open a window. The env-var check is a Linux-only
    fast path (X11/Wayland need a display variable; probing highgui without
    one can abort the process in some builds) — macOS/Windows highgui opens
    windows without either variable, so there we go straight to the probe."""
    import os
    import sys

    import cv2
    if sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return False
    try:
        cv2.namedWindow("_unet_tpu_probe", cv2.WINDOW_NORMAL)
        cv2.destroyWindow("_unet_tpu_probe")
        return True
    except cv2.error:
        return False


def run_window(session, window: str = "unet-tpu", delay_ms: int = 20) -> None:
    """Drive a session in a real cv2 window until `session.done`."""
    import cv2
    if not gui_available():
        raise RuntimeError(
            "no display available — use the headless CLI variants "
            "(cli tools annotate / calibrate-roi / calibrate-scale)")
    cv2.namedWindow(window, cv2.WINDOW_NORMAL)
    cv2.setMouseCallback(
        window, lambda ev, x, y, flags, param: session.on_mouse(ev, x, y))
    try:
        while not session.done:
            cv2.imshow(window, session.render())
            key = cv2.waitKey(delay_ms) & 0xFF
            if key != 0xFF:
                session.on_key(key)
    finally:
        cv2.destroyWindow(window)
