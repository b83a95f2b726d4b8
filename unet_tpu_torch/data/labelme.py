"""Labelme annotation -> mask conversion + dataset split materialization
(counterpart of unet_tpu/data/labelme.py).

Parity with reference src/data/prepare_dataset.py: the CLASS_MAP (:17-24),
legacy-name remapping (:27-31), polygon fillPoly rasterization
(json_to_mask :37-84), and the seeded 80/10/10 split (prepare_dataset :87-194).
"""
from __future__ import annotations

import glob
import json
import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

CLASS_MAP = {
    "background": 0,
    "cable": 1,
    "tape": 2,
    "burr_defect": 3,
    "loose_defect": 4,
    "wrap_uneven": 5,
}

# legacy annotation names (reference prepare_dataset.py:27-31)
CLASS_NAME_MAPPING: Dict[str, Optional[str]] = {
    "thin_defect": "wrap_uneven",
    "bulge_defect": None,
    "damage_defect": None,
}

CLASS_NAMES = {v: k for k, v in CLASS_MAP.items()}


def json_to_mask(json_file: str, save_mask: bool = False) -> np.ndarray:
    """Rasterize a labelme JSON into a class-id mask
    (reference prepare_dataset.py:37-84): shapes drawn in file order, so
    later shapes overwrite earlier ones."""
    import cv2

    data = json.loads(Path(json_file).read_text(encoding="utf-8"))
    mask = np.zeros((data["imageHeight"], data["imageWidth"]), np.uint8)
    for shape in data["shapes"]:
        label = shape["label"]
        if label in CLASS_NAME_MAPPING:
            label = CLASS_NAME_MAPPING[label]
            if label is None:
                continue
        if label not in CLASS_MAP:
            continue
        pts = np.asarray(shape["points"], np.int32)
        cv2.fillPoly(mask, [pts], color=CLASS_MAP[label])
    if save_mask:
        out = os.path.splitext(json_file)[0] + "_mask.png"
        cv2.imwrite(out, mask)
    return mask


def prepare_dataset(labelme_dir: str, images_dir: Optional[str] = None,
                    output_dir: str = "dataset/processed", val_ratio: float = 0.1,
                    test_ratio: float = 0.1, seed: int = 42
                    ) -> Dict[str, List[Tuple[str, str]]]:
    """Convert + split into {output_dir}/{train,val,test}/{images,masks}
    (reference prepare_dataset.py:87-194; seeded shuffle for reproducibility)."""
    import cv2

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    if images_dir is None:
        images_dir = os.path.join(os.path.dirname(labelme_dir), "images")

    exts = [".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG"]
    data_list = []
    for jf in glob.glob(os.path.join(labelme_dir, "*.json")):
        base = os.path.splitext(os.path.basename(jf))[0]
        for d in (images_dir, labelme_dir):
            hit = next((os.path.join(d, base + e) for e in exts
                        if os.path.exists(os.path.join(d, base + e))), None)
            if hit:
                data_list.append((hit, jf))
                break

    random.seed(seed)
    random.shuffle(data_list)
    total = len(data_list)
    n_val = int(total * val_ratio)
    n_test = int(total * test_ratio)
    n_train = total - n_val - n_test
    splits = {"train": data_list[:n_train],
              "val": data_list[n_train:n_train + n_val],
              "test": data_list[n_train + n_val:]}

    result: Dict[str, List[Tuple[str, str]]] = {}
    for split, items in splits.items():
        img_dir = Path(output_dir) / split / "images"
        mask_dir = Path(output_dir) / split / "masks"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for img_path, json_path in items:
            img = cv2.imdecode(np.fromfile(img_path, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                continue
            mask = json_to_mask(json_path)
            fname = os.path.basename(img_path)
            out_img = str(img_dir / fname)
            out_mask = str(mask_dir / (os.path.splitext(fname)[0] + ".png"))
            cv2.imwrite(out_img, img)
            cv2.imwrite(out_mask, mask)
            paths.append((out_img, out_mask))
        result[split] = paths
        print(f"{split}: {len(paths)} samples")
    return result
