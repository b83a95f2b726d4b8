"""Counterpart of unet_tpu/data/augment.py, the same host code (the port keeps
its own copy): the same draws from the same generator give the same arrays.

Augmentation pipelines (host cv2/numpy, synced image+mask).

Mirrors the reference's two systems:
  * hand-rolled AugmentationPipeline: flip / rotate±15° / scale / brightness /
    contrast with nearest-neighbour mask warping
    (reference src/data/augmentation.py:11-302)
  * the albumentations strong stack used by the flagship training run —
    random-resized-crop, flips, shift-scale-rotate, color jitter/HSV, noise,
    blur, motion blur, and the p=0.2 RandomFog/RandomRain weather pair
    (reference src/data/advanced_dataset.py:87-120), re-implemented directly
    with albumentations' documented algorithms (the library isn't a
    dependency here).

Caveat (VERDICT r4 item 8): fog/rain follow albumentations' published
algorithms and are property-tested (tests/test_events_data.py), but the
library is absent from this image, so distribution-level agreement against
real albumentations outputs has not been measured.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_fog(image: np.ndarray, fog_coef: float,
               rng: np.random.Generator, alpha_coef: float = 0.08
               ) -> np.ndarray:
    """A.RandomFog-faithful fog (reference advanced_dataset.py:114 uses
    RandomFog(fog_coef 0.1-0.3)): white circles of size ~W/3*fog_coef
    alpha-blended at random positions densifying outward from the center,
    then a box blur of kernel hw//10 — NOT a uniform whitening haze."""
    import cv2
    h, w = image.shape[:2]
    hw = max(int(w // 3 * fog_coef), 10)
    img = image.copy()
    # haze centers: rings stepping outward from the image center, more
    # circles per ring (albumentations' get_params walk)
    index = 1
    midx, midy = w // 2 - 2 * hw, h // 2 - hw
    centers = []
    while midx > -hw or midy > -hw:
        for _ in range(max(hw // 10 * index, 1)):
            x = int(rng.integers(midx, max(w - midx - hw, midx + 1)))
            y = int(rng.integers(midy, max(h - midy - hw, midy + 1)))
            centers.append((x, y))
        midx -= 3 * hw * w // (w + h)
        midy -= 3 * hw * h // (w + h)
        index += 1
    alpha = alpha_coef * fog_coef
    for x, y in centers:
        overlay = img.copy()
        cv2.circle(overlay, (x + hw // 2, y + hw // 2), hw // 2,
                   (255, 255, 255), -1)
        img = cv2.addWeighted(overlay, alpha, img, 1 - alpha, 0)
    k = max(hw // 10, 1)
    return cv2.blur(img, (k, k))


def random_rain(image: np.ndarray, slant: int, rng: np.random.Generator,
                drop_length: int = 20, drop_width: int = 1,
                drop_color=(200, 200, 200), blur_value: int = 7,
                brightness_coefficient: float = 0.7) -> np.ndarray:
    """A.RandomRain-faithful rain (reference advanced_dataset.py:115 uses
    RandomRain(slant -10..10)): ~area/600 slanted streaks of drop_color,
    a blur_value box blur, then HSV brightness scaled by 0.7 (rain scenes
    are darker) — masks untouched, like albumentations."""
    import cv2
    h, w = image.shape[:2]
    num_drops = (h * w) // 600
    img = image.copy()
    drop_length = min(drop_length, max(h - 1, 1))
    for _ in range(num_drops):
        x = int(rng.integers(slant, w)) if slant >= 0 else \
            int(rng.integers(0, w + slant))
        y = int(rng.integers(0, max(h - drop_length, 1)))
        cv2.line(img, (x, y), (x + slant, y + drop_length), drop_color,
                 drop_width)
    img = cv2.blur(img, (blur_value, blur_value))
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 2] *= brightness_coefficient
    return cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                        cv2.COLOR_HSV2RGB)


def _warp(image, mask, M, out_wh):
    import cv2
    img = cv2.warpAffine(image, M, out_wh, flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    msk = cv2.warpAffine(mask, M, out_wh, flags=cv2.INTER_NEAREST,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    return img, msk


class AugmentationPipeline:
    """Reference AugmentationPipeline parity (augmentation.py:11-258):
    each op applied with its own probability; masks always nearest."""

    def __init__(self, flip_prob: float = 0.5, rotate_prob: float = 0.3,
                 max_rotate_deg: float = 15.0, scale_prob: float = 0.3,
                 scale_range: Tuple[float, float] = (0.9, 1.1),
                 brightness_prob: float = 0.5,
                 brightness_range: Tuple[float, float] = (0.7, 1.3),
                 contrast_prob: float = 0.3,
                 contrast_range: Tuple[float, float] = (0.8, 1.2),
                 rng: Optional[np.random.Generator] = None):
        self.p = dict(flip=flip_prob, rotate=rotate_prob, scale=scale_prob,
                      brightness=brightness_prob, contrast=contrast_prob)
        self.max_rotate_deg = max_rotate_deg
        self.scale_range = scale_range
        self.brightness_range = brightness_range
        self.contrast_range = contrast_range
        self.rng = rng or np.random.default_rng()

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        import cv2
        r = self.rng
        h, w = mask.shape
        if r.random() < self.p["flip"]:
            image, mask = cv2.flip(image, 1), cv2.flip(mask, 1)
        if r.random() < self.p["flip"]:
            image, mask = cv2.flip(image, 0), cv2.flip(mask, 0)
        if r.random() < self.p["rotate"]:
            ang = r.uniform(-self.max_rotate_deg, self.max_rotate_deg)
            M = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
            image, mask = _warp(image, mask, M, (w, h))
        if r.random() < self.p["scale"]:
            s = r.uniform(*self.scale_range)
            M = cv2.getRotationMatrix2D((w / 2, h / 2), 0.0, s)
            image, mask = _warp(image, mask, M, (w, h))
        if r.random() < self.p["brightness"]:
            f = r.uniform(*self.brightness_range)
            image = np.clip(image.astype(np.float32) * f, 0, 255).astype(np.uint8)
        if r.random() < self.p["contrast"]:
            f = r.uniform(*self.contrast_range)
            mean = image.mean()
            image = np.clip((image.astype(np.float32) - mean) * f + mean,
                            0, 255).astype(np.uint8)
        return image, mask


class StrongAugmentationPipeline:
    """The flagship strong stack (reference advanced_dataset.py:87-120 /
    augmentation.py:261-281)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        import cv2
        r = self.rng
        h, w = mask.shape[:2]

        # geometric: random-resized-crop OR keep (p=0.5 overall)
        if r.random() < 0.5 and r.random() < 0.5:
            scale = r.uniform(0.7, 1.0)
            ch, cw = int(h * scale), int(w * scale)
            y1 = int(r.integers(0, h - ch + 1))
            x1 = int(r.integers(0, w - cw + 1))
            image = image[y1:y1 + ch, x1:x1 + cw]
            mask = mask[y1:y1 + ch, x1:x1 + cw]
            h, w = ch, cw
        if r.random() < 0.5:
            image, mask = cv2.flip(image, 1), cv2.flip(mask, 1)
        if r.random() < 0.5:
            image, mask = cv2.flip(image, 0), cv2.flip(mask, 0)
        if r.random() < 0.5:  # shift-scale-rotate (0.1 / 0.2 / 15deg)
            ang = r.uniform(-15, 15)
            s = 1.0 + r.uniform(-0.2, 0.2)
            M = cv2.getRotationMatrix2D((w / 2, h / 2), ang, s)
            M[0, 2] += r.uniform(-0.1, 0.1) * w
            M[1, 2] += r.uniform(-0.1, 0.1) * h
            image, mask = _warp(image, mask, M, (w, h))

        # color (p=0.6): jitter OR HSV OR brightness/contrast
        if r.random() < 0.6:
            pick = r.integers(0, 3)
            img = image.astype(np.float32)
            if pick == 0:  # color jitter
                img *= 1.0 + r.uniform(-0.3, 0.3)
                mean = img.mean()
                img = (img - mean) * (1.0 + r.uniform(-0.3, 0.3)) + mean
                image = np.clip(img, 0, 255).astype(np.uint8)
                hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
                hsv[..., 0] = (hsv[..., 0] + r.uniform(-0.1, 0.1) * 180) % 180
                hsv[..., 1] = np.clip(hsv[..., 1] * (1 + r.uniform(-0.3, 0.3)), 0, 255)
                image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
            elif pick == 1:  # HueSaturationValue (20/30/20)
                hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
                hsv[..., 0] = (hsv[..., 0] + r.uniform(-20, 20)) % 180
                hsv[..., 1] = np.clip(hsv[..., 1] + r.uniform(-30, 30), 0, 255)
                hsv[..., 2] = np.clip(hsv[..., 2] + r.uniform(-20, 20), 0, 255)
                image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
            else:  # brightness/contrast 0.3
                img *= 1.0 + r.uniform(-0.3, 0.3)
                mean = img.mean()
                img = (img - mean) * (1.0 + r.uniform(-0.3, 0.3)) + mean
                image = np.clip(img, 0, 255).astype(np.uint8)

        # noise/blur (p=0.3)
        if r.random() < 0.3:
            pick = r.integers(0, 3)
            if pick == 0:  # gauss noise var 10-50
                sigma = np.sqrt(r.uniform(10, 50))
                noise = r.normal(0, sigma, image.shape)
                image = np.clip(image + noise, 0, 255).astype(np.uint8)
            elif pick == 1:  # gaussian blur 3-5
                k = int(r.choice([3, 5]))
                image = cv2.GaussianBlur(image, (k, k), 0)
            else:  # motion blur 3-5
                k = int(r.choice([3, 5]))
                kern = np.zeros((k, k), np.float32)
                kern[k // 2, :] = 1.0 / k
                image = cv2.filter2D(image, -1, kern)

        # weather (p=0.2): fog OR rain, the reference's albumentations pair
        # (advanced_dataset.py:113-116)
        if r.random() < 0.2:
            if r.integers(0, 2) == 0:
                image = random_fog(image, float(r.uniform(0.1, 0.3)), r)
            else:
                image = random_rain(image, int(r.integers(-10, 11)), r)
        return image, mask


class WeakAugmentationPipeline(AugmentationPipeline):
    """Low-probability variant (reference augmentation.py:284-302)."""

    def __init__(self, rng=None):
        super().__init__(flip_prob=0.3, rotate_prob=0.1, max_rotate_deg=5.0,
                         scale_prob=0.1, scale_range=(0.95, 1.05),
                         brightness_prob=0.3, brightness_range=(0.9, 1.1),
                         contrast_prob=0.1, contrast_range=(0.95, 1.05), rng=rng)
