"""Segmentation quality metrics (counterpart of unet_tpu/ops/seg_metrics.py:
23-96): the confusion matrix on the device, finalised into the reference's
per-class IoU, precision and recall on the host (reference
src/utils/metrics.py:9-127):

  * background (class 0) excluded from the mIoU mean (metrics.py:62-64, 79-81)
  * absent-class convention: GT empty & pred empty -> IoU/precision 1.0,
    recall 1.0; GT empty & pred nonempty -> IoU/precision 0.0
    (metrics.py:51-65)
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix, rows = target, cols = pred
    (reference src/utils/metrics.py:102-127), one `bincount` on the
    tensors' device. Targets outside [0, num_classes) are dropped, as the
    JAX package's out-of-bounds scatter drops them: the train loop pads
    ragged validation batches with label == num_classes. They are masked
    out here, since `bincount` would count them into another cell (and an
    index past the end raises)."""
    t = target.reshape(-1).long()
    p = pred.reshape(-1).long()
    keep = (t >= 0) & (t < num_classes)
    flat = (t * num_classes + p)[keep]
    return torch.bincount(flat, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def metrics_from_confusion(cm: np.ndarray, ignore_index: int = -1
                           ) -> Tuple[float, Dict[int, float], Dict[int, float], Dict[int, float]]:
    """Finalize (mIoU, precision, recall, iou) from a confusion matrix with
    the reference's exact per-class conventions
    (reference src/utils/metrics.py:9-99). Returns the same 4-tuple shape."""
    cm = np.asarray(cm, dtype=np.float64)
    num_classes = cm.shape[0]
    ious_for_mean = []
    precision: Dict[int, float] = {}
    recall: Dict[int, float] = {}
    iou_dict: Dict[int, float] = {}
    for cls in range(num_classes):
        if cls == ignore_index:
            continue
        inter = cm[cls, cls]
        true_n = cm[cls, :].sum()
        pred_n = cm[:, cls].sum()
        is_background = cls == 0
        if true_n == 0:
            iou = 1.0 if pred_n == 0 else 0.0
            iou_dict[cls] = iou
            precision[cls] = 1.0 if pred_n == 0 else 0.0
            recall[cls] = 1.0
            if not is_background:
                ious_for_mean.append(iou)
            continue
        union = pred_n + true_n - inter
        iou = 1.0 if union == 0 else inter / union
        iou_dict[cls] = iou
        if not is_background:
            ious_for_mean.append(iou)
        precision[cls] = (1.0 if true_n == 0 else 0.0) if pred_n == 0 else inter / pred_n
        recall[cls] = inter / true_n
    miou = sum(ious_for_mean) / len(ious_for_mean) if ious_for_mean else 0.0
    return miou, precision, recall, iou_dict


def compute_metrics(pred, target, num_classes: int, ignore_index: int = -1):
    """Drop-in equivalent of reference compute_metrics(pred, target, ...)
    (src/utils/metrics.py:9-99): device confusion matrix + host finalize."""
    cm = confusion_matrix(torch.as_tensor(pred), torch.as_tensor(target), num_classes)
    return metrics_from_confusion(cm.cpu().numpy(), ignore_index)


def print_metrics(miou, precision, recall, iou_dict, class_names=None) -> None:
    """Formatted metric table (reference src/utils/metrics.py:130-165)."""
    if class_names is None:
        class_names = {cls: f"class_{cls}" for cls in iou_dict}
    print("\n" + "=" * 60)
    print(f"{'Metrics Summary':^60}")
    print("=" * 60)
    print(f"{'mIoU (Mean IoU):':<30} {miou:.4f}")
    print("-" * 60)
    print(f"{'Class':<15} {'IoU':<12} {'Precision':<12} {'Recall':<12}")
    print("-" * 60)
    for cls_id in sorted(iou_dict):
        name = class_names.get(cls_id, f"class_{cls_id}")
        print(f"{name:<15} {iou_dict[cls_id]:<12.4f} "
              f"{precision.get(cls_id, 0.0):<12.4f} {recall.get(cls_id, 0.0):<12.4f}")
    print("=" * 60 + "\n")
