"""Counterpart of unet_tpu/data/dataset.py, the same host code (the port keeps
its own copy); batches reach the card through the trainer's upload
(train.trainer.upload).

Datasets: image/mask folder datasets with the reference's conventions.

Framework-neutral numpy datasets (no torch dependency) feeding NHWC float
batches to the device. Mirrors:
  * CableDefectDataset — CJK-path-safe reads, bilinear image / nearest mask
    resize, flip+HSV-brightness inline augment, /255 normalization
    (reference src/data/dataset.py:10-133)
  * CableDefectDatasetAdvanced — strong augs, tape-centered crop (p=0.3),
    hard-negative sampling (p=0.15) (reference src/data/advanced_dataset.py:19-269)
  * CableDefectDataset3Class — 7->3 class remap (advanced_dataset.py:272-294)
  * PatchDefectDataset — defect-centred 50/50 patch sampling
    (reference src/data/patch_dataset.py:14-233)
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

# 7->3 class remap: bg, cable, tape kept; defects -> background
REMAP_7_TO_3 = {0: 0, 1: 1, 2: 2, 3: 0, 4: 0, 5: 0, 6: 0}


def imread_rgb(path: str) -> np.ndarray:
    """CJK-path-safe color read -> RGB (reference dataset.py:63-66)."""
    import cv2
    img = cv2.imdecode(np.fromfile(str(path), np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"image not found/decodable: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_mask(path: str) -> np.ndarray:
    import cv2
    m = cv2.imdecode(np.fromfile(str(path), np.uint8), cv2.IMREAD_UNCHANGED)
    if m is None:
        raise FileNotFoundError(f"mask not found/decodable: {path}")
    return m[..., 0] if m.ndim == 3 else m


class SegmentationDataset:
    """Base image/mask folder dataset (reference CableDefectDataset).

    __getitem__ returns (image (H, W, 3) float32 in [0,1], mask (H, W) int32).
    """

    IMG_EXTS = (".jpg", ".png", ".jpeg")

    def __init__(self, image_dir: str, mask_dir: str, augment: bool = False,
                 target_size: Optional[Tuple[int, int]] = None,
                 class_remap: Optional[dict] = None,
                 transform=None, rng: Optional[np.random.Generator] = None):
        self.image_dir = str(image_dir)
        self.mask_dir = str(mask_dir)
        self.augment = augment
        self.target_size = target_size  # (H, W)
        self.class_remap = class_remap
        self.transform = transform      # callable (img_u8, mask_u8) -> (img, mask)
        self.rng = rng or np.random.default_rng()
        self.image_files = sorted(
            f for f in os.listdir(image_dir) if f.lower().endswith(self.IMG_EXTS))
        for f in self.image_files:
            mp = os.path.join(mask_dir, os.path.splitext(f)[0] + ".png")
            if not os.path.exists(mp):
                raise FileNotFoundError(f"mask not found: {mp}")

    def __len__(self) -> int:
        return len(self.image_files)

    def _load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        f = self.image_files[idx]
        image = imread_rgb(os.path.join(self.image_dir, f))
        mask = imread_mask(os.path.join(self.mask_dir, os.path.splitext(f)[0] + ".png"))
        return image, mask

    def _resize(self, image, mask):
        import cv2
        if self.target_size is not None:
            h, w = self.target_size
            image = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)
        return image, mask

    def _basic_augment(self, image, mask):
        """Flip h/v + HSV value scaling (reference dataset.py:104-133)."""
        import cv2
        if self.rng.random() < 0.5:
            image, mask = cv2.flip(image, 1), cv2.flip(mask, 1)
        if self.rng.random() < 0.5:
            image, mask = cv2.flip(image, 0), cv2.flip(mask, 0)
        if self.rng.random() < 0.5:
            factor = 0.7 + self.rng.random() * 0.6
            hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
            hsv[:, :, 2] = np.clip(hsv[:, :, 2] * factor, 0, 255)
            image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image, mask

    def _finish(self, image, mask):
        if self.class_remap is not None:
            lut = np.arange(256, dtype=np.uint8)
            for k, v in self.class_remap.items():
                lut[k] = v
            mask = lut[mask]
        return image.astype(np.float32) / 255.0, mask.astype(np.int32)

    def __getitem__(self, idx: int):
        image, mask = self._load_pair(idx)
        image, mask = self._resize(image, mask)
        if self.transform is not None:
            image, mask = self.transform(image, mask)
            image, mask = self._resize(image, mask)
        elif self.augment:
            image, mask = self._basic_augment(image, mask)
        return self._finish(image, mask)

    def sample_weights(self, defect_classes: Sequence[int] = (3, 4, 5, 6),
                       boost: float = 2.0) -> np.ndarray:
        """Per-sample weights boosting defect-bearing images, the
        WeightedRandomSampler oversampling scheme (reference tools/train.py:254-273)."""
        w = np.ones(len(self), np.float64)
        for i, f in enumerate(self.image_files):
            mask = imread_mask(os.path.join(self.mask_dir,
                                            os.path.splitext(f)[0] + ".png"))
            if np.isin(mask, list(defect_classes)).any():
                w[i] = boost
        return w / w.sum()


class AdvancedDataset(SegmentationDataset):
    """Strong-augment dataset with tape-centred crops and hard negatives
    (reference CableDefectDatasetAdvanced, advanced_dataset.py:19-269)."""

    def __init__(self, image_dir, mask_dir, augment=True, target_size=(512, 512),
                 tape_crop_prob: float = 0.3, hard_negative_dir: Optional[str] = None,
                 hard_negative_prob: float = 0.15, class_remap=None, rng=None):
        from unet_tpu_torch.data.augment import StrongAugmentationPipeline
        super().__init__(image_dir, mask_dir, augment=augment,
                         target_size=target_size, class_remap=class_remap, rng=rng)
        self.tape_crop_prob = tape_crop_prob
        self.hard_negative_dir = hard_negative_dir
        self.hard_negative_prob = hard_negative_prob
        self.hard_negative_files: List[str] = []
        if hard_negative_dir and os.path.isdir(hard_negative_dir):
            self.hard_negative_files = sorted(
                f for f in os.listdir(hard_negative_dir)
                if f.lower().endswith(self.IMG_EXTS))
        self.strong = StrongAugmentationPipeline(rng=self.rng) if augment else None

    def _tape_focused_crop(self, image, mask):
        """Random crop centred on a tape pixel, 60-100% scale
        (reference advanced_dataset.py:143-186)."""
        h, w = mask.shape
        ys, xs = np.nonzero(mask == 2)
        if len(ys) == 0:
            return image, mask
        i = self.rng.integers(0, len(ys))
        cy, cx = int(ys[i]), int(xs[i])
        scale = 0.6 + self.rng.random() * 0.4
        ch, cw = int(h * scale), int(w * scale)
        y1 = max(0, cy - ch // 2); y2 = min(h, cy + ch // 2)
        x1 = max(0, cx - cw // 2); x2 = min(w, cx + cw // 2)
        if y2 - y1 < ch:
            y2 = min(h, y1 + ch) if y1 == 0 else y2
            y1 = max(0, y2 - ch)
        if x2 - x1 < cw:
            x2 = min(w, x1 + cw) if x1 == 0 else x2
            x1 = max(0, x2 - cw)
        return image[y1:y2, x1:x2], mask[y1:y2, x1:x2]

    def __getitem__(self, idx: int):
        if (self.augment and self.hard_negative_files
                and self.rng.random() < self.hard_negative_prob):
            hn = self.hard_negative_files[self.rng.integers(0, len(self.hard_negative_files))]
            image = imread_rgb(os.path.join(self.hard_negative_dir, hn))
            mask = np.zeros(image.shape[:2], np.uint8)
        else:
            image, mask = self._load_pair(idx)
            if self.augment and self.rng.random() < self.tape_crop_prob:
                image, mask = self._tape_focused_crop(image, mask)
        if self.augment and self.strong is not None:
            image, mask = self.strong(image, mask)
        image, mask = self._resize(image, mask)
        return self._finish(image, mask)


def three_class_dataset(image_dir, mask_dir, **kw) -> AdvancedDataset:
    """7->3-class training dataset (reference CableDefectDataset3Class,
    advanced_dataset.py:272-294): defects remapped to background."""
    return AdvancedDataset(image_dir, mask_dir, class_remap=REMAP_7_TO_3, **kw)


class PatchDefectDataset:
    """Defect-centred binary patch dataset (reference src/data/patch_dataset.py:
    14-233): 50/50 defect/normal patches, jittered crops, defect classes
    {3,4,5} -> 1, everything else -> 0."""

    def __init__(self, image_dir: str, mask_dir: str, patch_size: int = 640,
                 defect_classes: Sequence[int] = (3, 4, 5), jitter: int = 64,
                 rng: Optional[np.random.Generator] = None):
        self.base = SegmentationDataset(image_dir, mask_dir)
        self.patch_size = patch_size
        self.defect_classes = tuple(defect_classes)
        self.jitter = jitter
        self.rng = rng or np.random.default_rng()
        # mine defect bboxes once
        self.defect_boxes: List[Tuple[int, Tuple[int, int, int, int]]] = []
        for i in range(len(self.base)):
            _, mask = self.base._load_pair(i)
            sel = np.isin(mask, self.defect_classes)
            if sel.any():
                ys, xs = np.nonzero(sel)
                self.defect_boxes.append(
                    (i, (int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))))

    def __len__(self) -> int:
        return max(len(self.base), 2 * len(self.defect_boxes))

    def _crop(self, image, mask, cy, cx):
        p = self.patch_size
        h, w = mask.shape
        y1 = int(np.clip(cy - p // 2, 0, max(h - p, 0)))
        x1 = int(np.clip(cx - p // 2, 0, max(w - p, 0)))
        img = image[y1:y1 + p, x1:x1 + p]
        msk = mask[y1:y1 + p, x1:x1 + p]
        if img.shape[0] < p or img.shape[1] < p:  # pad small frames
            img = np.pad(img, ((0, p - img.shape[0]), (0, p - img.shape[1]), (0, 0)))
            msk = np.pad(msk, ((0, p - msk.shape[0]), (0, p - msk.shape[1])))
        return img, msk

    def __getitem__(self, idx: int):
        take_defect = self.defect_boxes and (idx % 2 == 0)
        if take_defect:
            i, (x0, y0, x1, y1) = self.defect_boxes[
                self.rng.integers(0, len(self.defect_boxes))]
            image, mask = self.base._load_pair(i)
            cy = (y0 + y1) // 2 + int(self.rng.integers(-self.jitter, self.jitter + 1))
            cx = (x0 + x1) // 2 + int(self.rng.integers(-self.jitter, self.jitter + 1))
        else:
            i = int(self.rng.integers(0, len(self.base)))
            image, mask = self.base._load_pair(i)
            cy = int(self.rng.integers(0, mask.shape[0]))
            cx = int(self.rng.integers(0, mask.shape[1]))
        img, msk = self._crop(image, mask, cy, cx)
        binary = np.isin(msk, self.defect_classes).astype(np.int32)
        return img.astype(np.float32) / 255.0, binary
