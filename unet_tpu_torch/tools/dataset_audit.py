"""Dataset QA tools (counterpart of unet_tpu/tools/dataset_audit.py):
labelme audit, mask diagnosis, class distribution, mask-id migrations
(reference tools/audit_dataset.py, diagnose_mask.py,
analyze_class_distribution.py, convert_masks.py / remap_masks.py)."""
from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unet_tpu_torch.data.labelme import CLASS_MAP, CLASS_NAME_MAPPING


def _polygon_issues(pts, h: int, w: int, margin: int = 5) -> Optional[str]:
    """Polygon sanity checks (reference audit_dataset.py:63-120):
    NaN, bad shape, out-of-bounds beyond a small margin, degenerate count,
    self-intersection (shoelace segments test)."""
    pts = np.asarray(pts, dtype=np.float32)
    if np.any(np.isnan(pts)):
        return "NaN in points"
    if pts.ndim != 2 or pts.shape[1] != 2:
        return f"bad shape {pts.shape}"
    if len(pts) < 3:
        return "fewer than 3 points"
    if (pts[:, 0].min() < -margin or pts[:, 1].min() < -margin
            or pts[:, 0].max() > w + margin or pts[:, 1].max() > h + margin):
        return "out of bounds"

    def segs_intersect(p1, p2, p3, p4):
        def ccw(a, b, c):
            return (c[1] - a[1]) * (b[0] - a[0]) > (b[1] - a[1]) * (c[0] - a[0])
        return (ccw(p1, p3, p4) != ccw(p2, p3, p4)
                and ccw(p1, p2, p3) != ccw(p1, p2, p4))

    n = len(pts)
    for i in range(n):
        a1, a2 = pts[i], pts[(i + 1) % n]
        for j in range(i + 2, n):
            if i == 0 and j == n - 1:
                continue  # shared endpoint
            if segs_intersect(a1, a2, pts[j], pts[(j + 1) % n]):
                return "self-intersecting polygon"
    return None


def audit_labelme_dir(labelme_dir: str, tiny_area: int = 25) -> Dict:
    """Audit labelme annotations (reference audit_dataset.py): returns a
    report {total, bad_samples:[{file, issues}], tiny_objects, empty_masks,
    class_distribution}."""
    report = {"total": 0, "bad_samples": [], "tiny_objects": [],
              "empty_masks": [], "class_distribution": {}}
    for jf in sorted(glob.glob(os.path.join(labelme_dir, "*.json"))):
        report["total"] += 1
        try:
            data = json.loads(Path(jf).read_text(encoding="utf-8"))
        except Exception as e:
            report["bad_samples"].append({"file": jf, "issues": [f"unreadable: {e}"]})
            continue
        h, w = data.get("imageHeight"), data.get("imageWidth")
        issues: List[str] = []
        n_drawn = 0
        for shape in data.get("shapes", []):
            label = shape.get("label")
            if label in CLASS_NAME_MAPPING:
                label = CLASS_NAME_MAPPING[label]
                if label is None:
                    continue
            if label not in CLASS_MAP:
                issues.append(f"unknown label {shape.get('label')!r}")
                continue
            problem = _polygon_issues(shape.get("points", []), h, w)
            if problem:
                issues.append(f"{label}: {problem}")
                continue
            pts = np.asarray(shape["points"], np.float32)
            area = 0.5 * abs(float(np.dot(pts[:, 0], np.roll(pts[:, 1], -1))
                                   - np.dot(pts[:, 1], np.roll(pts[:, 0], -1))))
            report["class_distribution"][label] = \
                report["class_distribution"].get(label, 0) + 1
            if area < tiny_area:
                report["tiny_objects"].append({"file": jf, "label": label,
                                               "area": area})
            n_drawn += 1
        if n_drawn == 0:
            report["empty_masks"].append(jf)
        if issues:
            report["bad_samples"].append({"file": jf, "issues": issues})
    return report


def diagnose_mask(mask: np.ndarray, num_classes: int,
                  resized_hw: Optional[Tuple[int, int]] = None) -> Dict:
    """Mask value-integrity checks across resize/remap
    (reference diagnose_mask.py:1-8): value histogram, out-of-range ids, and
    whether nearest-resize preserves the value set."""
    vals, counts = np.unique(mask, return_counts=True)
    out = {
        "values": {int(v): int(c) for v, c in zip(vals, counts)},
        "out_of_range": [int(v) for v in vals if v >= num_classes],
        "is_empty": bool((mask == 0).all()),
    }
    if resized_hw is not None:
        import cv2
        resized = cv2.resize(mask, (resized_hw[1], resized_hw[0]),
                             interpolation=cv2.INTER_NEAREST)
        out["values_after_resize"] = sorted(int(v) for v in np.unique(resized))
        out["values_preserved"] = set(out["values_after_resize"]) <= set(
            int(v) for v in vals)
    return out


def class_pixel_distribution(mask_dir: str, num_classes: int = 7) -> Dict[int, Dict]:
    """Per-class pixel statistics over a mask folder
    (reference analyze_class_distribution.py)."""
    import cv2
    totals = np.zeros(num_classes, np.int64)
    images_with = np.zeros(num_classes, np.int64)
    n = 0
    for p in sorted(Path(mask_dir).glob("*.png")):
        m = cv2.imdecode(np.fromfile(str(p), np.uint8), cv2.IMREAD_UNCHANGED)
        if m is None:
            continue
        if m.ndim == 3:
            m = m[..., 0]
        n += 1
        binc = np.bincount(m.reshape(-1), minlength=num_classes)[:num_classes]
        totals += binc
        images_with += binc > 0
    total_px = max(int(totals.sum()), 1)
    return {c: {"pixels": int(totals[c]),
                "fraction": round(totals[c] / total_px, 6),
                "images_with": int(images_with[c]),
                "images_total": n} for c in range(num_classes)}


def remap_masks(mask_dir: str, out_dir: str, mapping: Dict[int, int]) -> int:
    """Class-id remap migration over a mask folder (reference convert_masks.py
    / remap_masks.py / reprocess_dataset.py): e.g. {3:0,4:0,5:0} for 7->3."""
    import cv2
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    lut = np.arange(256, dtype=np.uint8)
    for k, v in mapping.items():
        lut[k] = v
    n = 0
    for p in sorted(Path(mask_dir).glob("*.png")):
        m = cv2.imdecode(np.fromfile(str(p), np.uint8), cv2.IMREAD_UNCHANGED)
        if m is None:
            continue
        if m.ndim == 3:
            m = m[..., 0]
        cv2.imwrite(str(Path(out_dir) / p.name), lut[m])
        n += 1
    return n


def update_dataset(raw_images_dir: str, raw_masks_dir: str, output_dir: str,
                   val_ratio: float = 0.1, test_ratio: float = 0.1,
                   seed: int = 42) -> Dict[str, int]:
    """Re-split already-rasterized (image, mask) pairs into the processed
    train/val/test layout (reference tools/update_dataset.py)."""
    import random
    import shutil

    pairs = []
    for p in sorted(Path(raw_images_dir).iterdir()):
        if p.suffix.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        mask = Path(raw_masks_dir) / (p.stem + ".png")
        if mask.exists():
            pairs.append((p, mask))
    random.Random(seed).shuffle(pairs)
    n_val = int(len(pairs) * val_ratio)
    n_test = int(len(pairs) * test_ratio)
    splits = {"train": pairs[: len(pairs) - n_val - n_test],
              "val": pairs[len(pairs) - n_val - n_test: len(pairs) - n_test],
              "test": pairs[len(pairs) - n_test:]}
    counts = {}
    for split, items in splits.items():
        img_dir = Path(output_dir) / split / "images"
        mask_dir = Path(output_dir) / split / "masks"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)
        for img, mask in items:
            shutil.copy2(img, img_dir / img.name)
            shutil.copy2(mask, mask_dir / mask.name)
        counts[split] = len(items)
    return counts


def rectangles_to_labelme(image_path: str, image_hw, rectangles,
                          label: str = "burr_defect") -> Dict:
    """Build a labelme-format annotation dict from (x1, y1, x2, y2) boxes —
    the programmatic core of the mouse-driven burr annotation tool
    (reference tools/annotate_burr.py), usable headless."""
    import os
    return {
        "version": "5.0.0",
        "flags": {},
        "shapes": [{
            "label": label,
            "points": [[float(x1), float(y1)], [float(x2), float(y1)],
                       [float(x2), float(y2)], [float(x1), float(y2)]],
            "group_id": None,
            "shape_type": "polygon",
            "flags": {},
        } for (x1, y1, x2, y2) in rectangles],
        "imagePath": os.path.basename(image_path),
        "imageData": None,
        "imageHeight": int(image_hw[0]),
        "imageWidth": int(image_hw[1]),
    }
