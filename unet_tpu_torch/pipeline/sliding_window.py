"""Sliding-window patch inference for high-resolution defect detection
(counterpart of unet_tpu/pipeline/sliding_window.py), the inference side of
the binary patch recipe (reference tools/inference_binary_optimized.py:21-176).

Every window of the frame is cut with static slices and the windows go
through the model in batches of `batch_chunk`; then window gating, the
overlap-averaged probability fusion, hysteresis seed growing (:116-136) and
the component + mean-probability filter (:139-176), whose labels run on
kernel B1 (`ops.cc.connected_components`) on the card. Everything stays on
the device until `predict` returns its numpy result.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from unet_tpu_torch.models.blocks import fp32_convs
from unet_tpu_torch.ops import cc as _cc
from unet_tpu_torch.ops import image as _image
from unet_tpu_torch.ops import morph as _morph


def _patch_origins(size: int, patch: int, stride: int) -> List[int]:
    """cv2-loop origin semantics (reference :44-66): stride steps plus a
    final end-aligned window when the stride does not divide evenly."""
    n = (size - patch) // stride + 1
    origins = [i * stride for i in range(n)]
    if (size - patch) % stride != 0:
        origins.append(size - patch)
    return origins


class SlidingWindowInference:
    """`model` (NCHW in, logits out; the last head where it returns
    several) over every `patch_size` window of a frame at `stride`, each
    resized to `target_size`, on `device` ("cuda" unless the caller asks
    for the CPU)."""

    def __init__(self, model: nn.Module, patch_size: int = 384, stride: int = 192,
                 target_size: int = 256, num_classes: int = 2, gate_thr: float = 0.70,
                 defect_cls: int = 1, batch_chunk: int = 64,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlidingWindowInference(device='cuda') needs a CUDA device")
        self.model = model.to(self.device).eval()
        self.patch_size = patch_size
        self.stride = stride
        self.target_size = target_size
        self.num_classes = num_classes
        self.gate_thr = gate_thr
        self.defect_cls = defect_cls
        self.batch_chunk = batch_chunk

    @torch.inference_mode()
    def _run(self, image: torch.Tensor, use_gating: bool) -> torch.Tensor:
        h, w = image.shape[:2]
        p, t, c = self.patch_size, self.target_size, self.num_classes
        origins = [(y, x) for y in _patch_origins(h, p, self.stride)
                   for x in _patch_origins(w, p, self.stride)]
        img = image.to(torch.float32)
        patches = torch.stack([img[y:y + p, x:x + p] for y, x in origins])
        # / 255 as the jitted JAX function computes it
        small = _image.resize_bilinear(patches, (t, t)) * _image.recip32(255.0)
        parts = []
        for s in range(0, len(origins), self.batch_chunk):
            with fp32_convs():
                out = self.model(small[s:s + self.batch_chunk].permute(0, 3, 1, 2).contiguous())
            parts.append(out[-1] if isinstance(out, (list, tuple)) else out)
        from unet_tpu_torch.pipeline.stages import softmax
        probs = softmax(torch.cat(parts).to(torch.float32)).permute(0, 2, 3, 1)  # (N, t, t, C)

        if use_gating:
            gate = torch.amax(probs[..., self.defect_cls], dim=(-2, -1))
            weight = (gate >= self.gate_thr).to(torch.float32)
        else:
            weight = torch.ones(len(origins), dtype=torch.float32, device=img.device)

        up = _image.resize_bilinear(probs, (p, p), channel_dim=True)      # (N, p, p, C)
        output = torch.zeros((h, w, c), dtype=torch.float32, device=img.device)
        count = torch.zeros((h, w, 1), dtype=torch.float32, device=img.device)
        for i, (y, x) in enumerate(origins):
            output[y:y + p, x:x + p] = output[y:y + p, x:x + p] + up[i] * weight[i]
            count[y:y + p, x:x + p] = count[y:y + p, x:x + p] + weight[i]
        return output / (count + 1e-8)

    def predict(self, image: np.ndarray, use_gating: bool = True) -> np.ndarray:
        """image (H, W, 3) uint8 -> (H, W, num_classes) overlap-averaged
        probabilities (windows whose gate score is below gate_thr add
        nothing)."""
        return self._run(torch.as_tensor(image).to(self.device), use_gating).cpu().numpy()


def apply_hysteresis(prob_map: torch.Tensor, thr_high: float = 0.90,
                     thr_low: float = 0.70) -> torch.Tensor:
    """Seed-grow thresholding (reference :116-136): high-threshold seeds,
    low-threshold pixels kept only within 3 dilations (ellipse 5) of a
    seed."""
    seeds = prob_map >= thr_high
    grown = _morph.dilate(seeds, _morph.ellipse_kernel(5), iterations=3)
    return seeds | ((prob_map >= thr_low) & grown)


def filter_by_cc_and_prob(pred_mask: torch.Tensor, prob_map: torch.Tensor,
                          min_area: int = 50, mean_prob_thr: float = 0.85) -> torch.Tensor:
    """Morphological open + close, then the components with area >=
    min_area AND mean probability >= mean_prob_thr (reference :139-176).
    A component's probability sum is taken in float64 and rounded once
    (the JAX package adds in float32 in pixel order: equal but for the
    last bit)."""
    se3 = _morph.ellipse_kernel(3)
    cleaned = _morph.close_(_morph.open_(pred_mask, se3), se3).to(torch.bool)
    lead = cleaned.shape[:-2]
    H, W = cleaned.shape[-2:]
    m = cleaned.reshape(-1, H, W)
    bins, fg = _cc._scatter_bins(_cc.connected_components(m))
    area = _cc._areas(bins, fg).gather(1, bins)
    prob = torch.where(fg, prob_map.reshape(bins.shape).to(torch.float64), 0.0)
    psum = torch.zeros(bins.shape, dtype=torch.float64, device=bins.device)
    psum = psum.scatter_add_(1, bins, prob).gather(1, bins).to(torch.float32)
    mean = psum / torch.clamp(area, min=1)
    keep = (area >= min_area) & (mean >= mean_prob_thr)
    return (fg & keep).reshape(lead + (H, W))


def scan_thresholds(prob_maps: List[np.ndarray], gt_masks: List[np.ndarray],
                    thr_range: Tuple[float, float, float] = (0.50, 0.99, 0.01),
                    defect_cls: int = 1) -> Dict[float, float]:
    """Threshold-scanning harness over precomputed probability maps
    (reference scan_thresholds, :179+): {threshold: mean defect IoU}."""
    lo, hi, step = thr_range
    out: Dict[float, float] = {}
    for thr in np.arange(lo, hi, step):
        ious = []
        for probs, gt in zip(prob_maps, gt_masks):
            pred = probs[..., defect_cls] >= thr
            gtb = gt > 0
            union = np.logical_or(pred, gtb).sum()
            ious.append(1.0 if union == 0 else np.logical_and(pred, gtb).sum() / union)
        out[round(float(thr), 4)] = float(np.mean(ious))
    return out
