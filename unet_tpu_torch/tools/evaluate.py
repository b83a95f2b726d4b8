"""Test-set evaluation (counterpart of unet_tpu/tools/evaluate.py:18-58;
reference tools/evaluate.py:22-114): the confusion matrix accumulated on the
device, the reference's metrics, and the confusion CSV and metrics JSON.
`SingleImageInference` and `summarize_checkpoints` are ROADMAP A14b."""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn


def evaluate_dataset(model: nn.Module, dataset, num_classes: int, batch_size: int = 8,
                     output_dir: Optional[str] = None, device: str = "cuda") -> Dict[str, Any]:
    """Evaluate the (image, mask) samples of `dataset` with `model` (its
    weights loaded) on `device`; optional confusion_matrix.csv and
    metrics.json in `output_dir`. The JAX package passes the variables
    beside the model; here the model holds them."""
    from unet_tpu_torch.data.loader import Loader
    from unet_tpu_torch.ops.seg_metrics import metrics_from_confusion
    from unet_tpu_torch.train.trainer import make_eval_step, upload

    model = model.to(device)
    step = make_eval_step(num_classes)
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for images, labels in Loader(dataset, batch_size, prefetch=1):
        cm += step(model, *upload(images, labels, device))
    cm = cm.cpu().numpy()

    miou, precision, recall, ious = metrics_from_confusion(cm)
    result = {
        "miou": miou,
        "iou": {int(k): float(v) for k, v in ious.items()},
        "precision": {int(k): float(v) for k, v in precision.items()},
        "recall": {int(k): float(v) for k, v in recall.items()},
        "pixel_accuracy": float(np.trace(cm) / max(cm.sum(), 1)),
    }
    if output_dir:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "confusion_matrix.csv", "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["gt\\pred"] + [f"pred_{i}" for i in range(num_classes)])
            for i in range(num_classes):
                wr.writerow([f"gt_{i}"] + cm[i].tolist())
        (out / "metrics.json").write_text(json.dumps(result, indent=2))
    result["confusion"] = cm
    return result
