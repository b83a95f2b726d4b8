"""Batch visualization renderers (counterpart of
unet_tpu/tools/visualize_dataset.py; reference tools/visualize_masks.py,
visualize_comparison.py, visualize_predictions.py): mask colorization grids
and orig/GT/pred comparisons over dataset folders."""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from unet_tpu_torch.data.dataset import imread_mask, imread_rgb
from unet_tpu_torch.pipeline.visualize import colorize_mask, comparison_image, overlay


def render_masks(image_dir: str, mask_dir: str, out_dir: str,
                 limit: Optional[int] = None) -> int:
    """Colorized-overlay render of every (image, mask) pair."""
    import cv2
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(image_dir)):
        if not f.lower().endswith((".jpg", ".png", ".jpeg")):
            continue
        mask_path = os.path.join(mask_dir, os.path.splitext(f)[0] + ".png")
        if not os.path.exists(mask_path):
            continue
        bgr = cv2.cvtColor(imread_rgb(os.path.join(image_dir, f)), cv2.COLOR_RGB2BGR)
        mask = imread_mask(mask_path)
        cv2.imwrite(os.path.join(out_dir, f), overlay(bgr, mask))
        n += 1
        if limit and n >= limit:
            break
    return n


def render_predictions(inference, image_dir: str, mask_dir: Optional[str],
                       out_dir: str, limit: Optional[int] = None) -> int:
    """Side-by-side original | prediction (| GT) grids using a
    SingleImageInference instance."""
    import cv2
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(image_dir)):
        if not f.lower().endswith((".jpg", ".png", ".jpeg")):
            continue
        bgr = cv2.cvtColor(imread_rgb(os.path.join(image_dir, f)), cv2.COLOR_RGB2BGR)
        pred = inference.predict(bgr)
        gt = None
        if mask_dir:
            mp = os.path.join(mask_dir, os.path.splitext(f)[0] + ".png")
            gt = imread_mask(mp) if os.path.exists(mp) else None
        cv2.imwrite(os.path.join(out_dir, f), comparison_image(bgr, pred, gt))
        n += 1
        if limit and n >= limit:
            break
    return n
