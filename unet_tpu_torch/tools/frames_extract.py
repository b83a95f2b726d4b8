"""Frame extraction for annotation (counterpart of
unet_tpu/tools/frames_extract.py): fps-strided capture with aHash
near-duplicate dedup + ROI crop (reference tools/extract_frames.py:1-63,
tools/extract_frames_for_annotation.py)."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def ahash(img_bgr: np.ndarray, size: int = 8) -> np.ndarray:
    """Average hash (reference extract_frames.py:7-11)."""
    import cv2
    g = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY)
    g = cv2.resize(g, (size, size), interpolation=cv2.INTER_AREA)
    return (g > g.mean()).astype(np.uint8).reshape(-1)


def hash_similarity(a: np.ndarray, b: np.ndarray) -> float:
    return 1.0 - np.count_nonzero(a != b) / a.size


def extract_frames(video: str, out_dir: str, fps: float = 5.0,
                   roi: Optional[Tuple[int, int, int, int]] = None,
                   dedup: float = 0.97, quality_gate: bool = False,
                   blur_th: float = 80.0) -> int:
    """Extract fps-strided frames, skipping near-duplicates (aHash sim >=
    dedup) and optionally blurry frames (the annotation-oriented variant,
    reference extract_frames_for_annotation.py). Returns frames saved."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    stride = max(1, int(round(src_fps / fps)))
    last_hash = None
    saved = 0
    idx = -1
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        idx += 1
        if idx % stride != 0:
            continue
        if roi:
            x, y, w, h = roi
            frame = frame[y:y + h, x:x + w]
        if quality_gate:
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if cv2.Laplacian(gray, cv2.CV_32F).var() < blur_th:
                continue
        hsh = ahash(frame)
        if last_hash is not None and hash_similarity(hsh, last_hash) >= dedup:
            continue
        last_hash = hsh
        cv2.imwrite(os.path.join(out_dir, f"frame_{saved:06d}.jpg"), frame)
        saved += 1
    cap.release()
    print(f"saved {saved} frames to {out_dir}")
    return saved
