"""Headless burr annotation store
(counterpart of unet_tpu/tools/annotate.py).

The reference ships a mouse-driven rectangle annotation tool writing
`burr_annotations.json` (reference tools/annotate_burr.py: frame_id ->
{"filename", "burr_regions": [[x1, y1, x2, y2], ...]}). An interactive cv2
window is useless on a headless host, so this is the same store driven
from the CLI/batch side — SAME JSON schema — plus a converter into labelme
JSONs (via dataset_audit.rectangles_to_labelme) so rectangle annotations
feed the standard prepare-dataset path (data/labelme.py).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

MIN_BOX_SIDE = 10  # reference annotate_burr.py:89 filters boxes <= 10 px


def load_annotations(output_dir: str) -> Dict[str, dict]:
    """burr_annotations.json from `output_dir` (empty dict when absent)."""
    f = Path(output_dir) / "burr_annotations.json"
    if f.exists():
        return json.loads(f.read_text(encoding="utf-8"))
    return {}


def save_annotations(output_dir: str, annotations: Dict[str, dict]) -> str:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    f = out / "burr_annotations.json"
    f.write_text(json.dumps(annotations, indent=2, ensure_ascii=False),
                 encoding="utf-8")
    return str(f)


def add_boxes(annotations: Dict[str, dict], frame_id: int, filename: str,
              boxes: Sequence[Sequence[float]],
              replace: bool = False) -> Dict[str, dict]:
    """Add rectangle boxes [x1, y1, x2, y2] for a frame; coordinates are
    normalized to x1<x2/y1<y2 and boxes <= MIN_BOX_SIDE on a side are
    dropped (reference annotate_burr.py:83-91)."""
    clean: List[List[int]] = []
    for b in boxes:
        x1, y1, x2, y2 = (int(round(v)) for v in b)
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        if (x2 - x1) > MIN_BOX_SIDE and (y2 - y1) > MIN_BOX_SIDE:
            clean.append([x1, y1, x2, y2])
    key = str(frame_id)
    prev = [] if replace else list(
        annotations.get(key, {}).get("burr_regions", []))
    annotations[key] = {"filename": filename, "burr_regions": prev + clean}
    return annotations


def annotations_to_labelme(annotations: Dict[str, dict], images_dir: str,
                           out_dir: str, label: str = "burr") -> int:
    """burr_annotations.json records -> one labelme JSON per frame,
    consumable by data.labelme.prepare_dataset. Returns files written."""
    import cv2

    from unet_tpu_torch.tools.dataset_audit import rectangles_to_labelme

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for rec in annotations.values():
        img_path = Path(images_dir) / rec["filename"]
        im = cv2.imread(str(img_path)) if img_path.exists() else None
        if im is None:
            # a 0x0 imageHeight/Width labelme doc would rasterize to empty
            # masks downstream — surface the problem instead of writing it
            print(f"warning: skipping {rec['filename']!r} "
                  f"(image missing/unreadable in {images_dir})")
            continue
        doc = rectangles_to_labelme(rec["filename"], im.shape[:2],
                                    rec["burr_regions"], label=label)
        (out / (Path(rec["filename"]).stem + ".json")).write_text(
            json.dumps(doc, indent=2), encoding="utf-8")
        n += 1
    return n
