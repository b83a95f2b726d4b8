"""Frame conditioning: grayscale detection and enhancement, non-local-means
denoising and the aspect-preserving model resize (counterpart of
unet_tpu/ops/frames.py; reference src/refactor/preprocess.py).

`nlm_denoise` is cv2.fastNlMeansDenoising in device form (reference
infer_enhanced_burr.py:57): the reflect-101 border, the patch distance as a
box sum of squared differences for every offset of the search window, the
weight exp(-d2 / h^2) and a centre weight of 1. Its work is one launch of
ops.nlm_kernels.nlm, the CUDA kernel on the card.

No preset's step calls the grayscale functions or `resize_for_model`, in
either package; they are the reference's refactored preprocessing, kept
for callers of the library.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from unet_tpu_torch.ops import clahe as _clahe
from unet_tpu_torch.ops import color as _color
from unet_tpu_torch.ops import image as _image
from unet_tpu_torch.ops import nlm_kernels


def is_grayscale_frame(frames_bgr: torch.Tensor, threshold: float = 10.0) -> torch.Tensor:
    """Per-frame grayscale detection by the largest mean channel difference
    (reference src/refactor/preprocess.py:12-32). (..., H, W, 3) -> (...,)
    bool."""
    x = frames_bgr.to(torch.float32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    d = [torch.mean(torch.abs(p - q), dim=(-2, -1)) for p, q in ((b, g), (g, r), (r, b))]
    return torch.maximum(torch.maximum(d[0], d[1]), d[2]) < threshold


def enhance_grayscale_frame(frames_bgr: torch.Tensor, clahe_clip: float = 2.0,
                            clahe_tile: int = 8, gamma: float = 0.8,
                            denoise: str = "bilateral",
                            denoise_strength: int = 5) -> torch.Tensor:
    """CLAHE, a gamma power and a denoiser on the luma, back to 3-channel BGR
    float32 (reference src/refactor/preprocess.py:35-74)."""
    gray = torch.clamp(torch.round(_color.bgr2gray(frames_bgr.to(torch.float32))), 0, 255)
    out = _clahe.clahe(gray, clahe_clip, (clahe_tile, clahe_tile))
    if gamma != 1.0:
        out = _color.gamma_lut(out / 255.0, gamma) * 255.0
        out = torch.clamp(torch.round(out), 0, 255)
    if denoise == "bilateral":
        out = _image.bilateral_filter(out, d=denoise_strength, sigma_color=75.0,
                                      sigma_space=75.0, channel_dim=False)
    elif denoise in ("fastNlMeans", "nlm"):
        out = nlm_denoise(out, h=float(denoise_strength))
    return out[..., None].expand(out.shape + (3,)).contiguous()


def conditional_grayscale_enhance(frames_bgr: torch.Tensor, threshold: float = 10.0,
                                  **enhance_kw) -> torch.Tensor:
    """preprocess_frame (reference preprocess.py:77-92): only the frames
    detected as grayscale are enhanced, by a per-frame select; float32 out."""
    is_gray = is_grayscale_frame(frames_bgr, threshold)
    enhanced = enhance_grayscale_frame(frames_bgr, **enhance_kw)
    return torch.where(is_gray[..., None, None, None], enhanced,
                       frames_bgr.to(torch.float32))


def nlm_denoise(gray: torch.Tensor, h: float = 10.0, template: int = 7,
                search: int = 21) -> torch.Tensor:
    """Non-local-means denoising of (..., H, W) planes; float32 out."""
    lead = gray.shape[:-2]
    H, W = gray.shape[-2:]
    x = gray.to(torch.float32).reshape(-1, H, W).contiguous()
    return nlm_kernels.nlm(x, h, template, search).reshape(lead + (H, W))


def nlm_denoise_colored(bgr: torch.Tensor, h: float = 10.0, h_color: float = 10.0,
                        template: int = 7, search: int = 21) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored-shaped: denoise L with `h` and the
    a/b chroma with `h_color` in CIELAB, then convert back
    (reference infer_enhanced_burr.py:57)."""
    L, a, b = _color.bgr2lab(bgr)
    L = nlm_denoise(L, h, template, search)
    a = nlm_denoise(a, h_color, template, search)
    b = nlm_denoise(b, h_color, template, search)
    return _color.lab2bgr(L, a, b)


def resize_for_model(frames: torch.Tensor, target_size: int = 512
                     ) -> Tuple[torch.Tensor, float]:
    """Aspect-preserving bilinear resize of (..., H, W, C) frames, zero-padded
    at the bottom and right to a target_size square (reference
    src/refactor/preprocess.py:147-172). Returns (frames, scale)."""
    h, w = frames.shape[-3], frames.shape[-2]
    scale = target_size / max(h, w)
    nh, nw = int(h * scale), int(w * scale)
    x = _image.resize_bilinear(frames, (nh, nw))
    return F.pad(x, (0, 0, 0, target_size - nw, 0, target_size - nh)), scale


def resize_mask_back(mask: torch.Tensor, original_hw: Sequence[int],
                     scale: float) -> torch.Tensor:
    """Inverse of `resize_for_model` for (..., S, S) masks (reference
    preprocess.py:175-197): the content region, nearest-resized back."""
    h, w = original_hw
    sh, sw = int(h * scale), int(w * scale)
    return _image.resize_nearest(mask[..., :sh, :sw], (h, w), channel_dim=False)
