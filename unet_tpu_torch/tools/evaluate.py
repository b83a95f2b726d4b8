"""Test-set evaluation, single-image inference and the checkpoint summary
(counterpart of unet_tpu/tools/evaluate.py): `evaluate_dataset`
(reference tools/evaluate.py:22-114: the confusion matrix accumulated on
the device, the reference's metrics, the confusion CSV and metrics JSON),
`SingleImageInference` (reference tools/inference.py:21-257) and
`summarize_checkpoints` (reference tools/evaluate_training_results.py)."""
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


class SingleImageInference:
    """Single-image / image-list inference with colorized outputs
    (reference tools/inference.py:21-257), on `device`: BGR -> RGB, a
    bilinear resize to `input_size`, / 255, the forward with full-fp32
    convs (`stages.forward_logits`), the argmax. The JAX package passes the
    variables beside the model; here the model holds them."""

    def __init__(self, model: nn.Module, input_size: int = 512, num_classes: int = 3,
                 device: str = "cuda"):
        self.input_size = input_size
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def _step(self, frames_bgr: torch.Tensor) -> torch.Tensor:
        from unet_tpu_torch.ops import color as _color
        from unet_tpu_torch.ops import image as _image
        from unet_tpu_torch.pipeline.stages import forward_logits

        s = self.input_size
        x = _image.resize_bilinear(_color.bgr2rgb(frames_bgr.to(torch.float32)), (s, s)) / 255.0
        logits = forward_logits(self.model, x.permute(0, 3, 1, 2).contiguous())
        return torch.argmax(logits, dim=1).to(torch.uint8)

    def predict(self, image_bgr: np.ndarray) -> np.ndarray:
        """(H, W, 3) BGR -> (H, W) class mask at original resolution."""
        import cv2
        frames = torch.from_numpy(np.ascontiguousarray(image_bgr[None])).to(self.device)
        pred = self._step(frames)[0].cpu().numpy()
        h, w = image_bgr.shape[:2]
        return cv2.resize(pred, (w, h), interpolation=cv2.INTER_NEAREST)

    def predict_and_save(self, image_path: str, out_dir: str) -> Dict[str, str]:
        import cv2

        from unet_tpu_torch.data.dataset import imread_rgb
        from unet_tpu_torch.pipeline.visualize import colorize_mask, overlay
        rgb = imread_rgb(image_path)
        bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        mask = self.predict(bgr)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        stem = Path(image_path).stem
        paths = {
            "mask": str(out / f"{stem}_mask.png"),
            "color": str(out / f"{stem}_color.png"),
            "overlay": str(out / f"{stem}_overlay.jpg"),
        }
        cv2.imwrite(paths["mask"], mask)
        cv2.imwrite(paths["color"], colorize_mask(mask))
        cv2.imwrite(paths["overlay"], overlay(bgr, mask))
        return paths


def summarize_checkpoints(ckpt_dir: str) -> Dict[str, Any]:
    """Checkpoint metric summarizer (reference tools/evaluate_training_results.py):
    collects {name: {epoch, best_miou}} from the `{name}.meta.json` sidecars
    that `core.checkpoint` writes beside `{name}.pth`, plus the training
    history, and prints a ranked table."""
    out: Dict[str, Any] = {"checkpoints": {}, "history": None}
    root = Path(ckpt_dir)
    for meta in sorted(root.glob("*.meta.json")):
        data = json.loads(meta.read_text())
        out["checkpoints"][meta.name.replace(".meta.json", "")] = {
            "epoch": data.get("epoch"), "best_miou": data.get("best_miou")}
    hist_path = root / "training_history.json"
    if hist_path.exists():
        hist = json.loads(hist_path.read_text())["history"]
        if hist.get("miou"):
            out["history"] = {
                "epochs": len(hist["miou"]),
                "best_miou": max(hist["miou"]),
                "best_epoch": int(np.argmax(hist["miou"])),
                "final_loss": hist["loss"][-1] if hist.get("loss") else None,
            }
    print(f"{'checkpoint':<20} {'epoch':>6} {'best_mIoU':>10}")
    for name, info in sorted(out["checkpoints"].items(),
                             key=lambda kv: -(kv[1]["best_miou"] or 0)):
        miou = info["best_miou"]
        miou_s = f"{miou:.4f}" if isinstance(miou, (int, float)) else "-"
        epoch_s = str(info["epoch"]) if info["epoch"] is not None else "-"
        print(f"{name:<20} {epoch_s:>6} {miou_s:>10}")
    if out["history"]:
        h = out["history"]
        print(f"history: {h['epochs']} epochs, best mIoU {h['best_miou']:.4f} "
              f"@ epoch {h['best_epoch']}")
    return out
