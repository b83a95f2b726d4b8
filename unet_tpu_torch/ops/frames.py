"""Frame conditioning: non-local-means denoising (counterpart of
unet_tpu/ops/frames.py:60-139).

`nlm_denoise` is cv2.fastNlMeansDenoising in device form (reference
infer_enhanced_burr.py:57): the reflect-101 border, the patch distance as a
box sum of squared differences for every offset of the search window, the
weight exp(-d2 / h^2) and a centre weight of 1. Its work is one launch of
ops.nlm_kernels.nlm, the CUDA kernel on the card.
"""
from __future__ import annotations

import torch

from unet_tpu_torch.ops import color as _color
from unet_tpu_torch.ops import nlm_kernels


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
