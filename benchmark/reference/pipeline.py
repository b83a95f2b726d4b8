"""The inspection step of the `two_stage` and `enhanced` presets in plain
PyTorch: a frozen copy of the port's plain route
(`pipeline/stages.run_pipeline` with the branches these presets take),
driven by the constants in a configuration file's `pipeline` group, with
the NestedUNet of `nested_unet.py` in float32.

uint8 BGR frames -> float32 (rotate 90 CCW, resize to `normalize_wh`) ->
enhance (CLAHE on Lab L, non-local means on L, a, b, sharpen) -> RGB at the
model size / 255 -> logits -> argmax masks -> nearest resize to the frame
-> the ROI -> the burr stage on a static crop around the ROI (Canny in the
cable's outer band, or the multiscale Canny | Sobel | Laplacian fusion;
close, open, the CC area / aspect / size filter) -> class map (0 bg, 1
cable, 2 tape, 3 burr) and pixel counts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cc, clahe, color, edges, image, kernels, morph, nested_unet


class Step(NamedTuple):
    logits: torch.Tensor      # (B, C, h, w) float32 at the model's resolution
    gray: torch.Tensor        # (B, H, W) float32: the frame the burr stage reads
    class_map: torch.Tensor   # (B, H, W) uint8
    cable_px: torch.Tensor
    tape_px: torch.Tensor
    burr_px: torch.Tensor


def roi_box(pc: dict, frame_hw):
    """(y1, y2, x1, x2) of the ROI in frame pixels (`config.ROI.scaled`)."""
    H, W = frame_hw
    r = pc["roi"]
    sx, sy = W / r["space"][0], H / r["space"][1]
    return int(r["y1"] * sy), int(r["y2"] * sy), int(r["x1"] * sx), int(r["x2"] * sx)


def _roi_limit(mask: torch.Tensor, pc: dict) -> torch.Tensor:
    H, W = mask.shape[-2:]
    y1, y2, x1, x2 = roi_box(pc, (H, W))
    sel = torch.zeros((H, W), dtype=torch.bool, device=mask.device)
    sel[max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = True
    return mask & sel


def _burr_canny_band(gray, cable, b, mag_max=None):
    band = morph.outer_band(cable, morph.ellipse_kernel(b["band_px"]))
    blurred = torch.round(image.gaussian_blur(gray, b["blur_ksize"], b["blur_sigma"],
                                              channel_dim=False))
    cand = edges.canny(blurred, b["canny_low"], b["canny_high"]) & band
    cand = morph.close_(cand, morph.ellipse_kernel(b["close_ksize"]))
    cand = morph.open_(cand, morph.ellipse_kernel(b["open_ksize"]))
    return cc.filter_components_by_geometry(
        cand, b["min_area"], b["max_area"], max_aspect=b["max_aspect"],
        min_w=b["min_w"], min_h=b["min_h"], strict_min_wh=b["strict_min_wh"])


def _burr_multiscale(gray, cable, b, mag_max=None):
    band = morph.outer_band(cable, morph.ellipse_kernel(b["band_px"]))
    blurred = torch.round(image.gaussian_blur(gray, b["blur_ksize"], b["blur_sigma"],
                                              channel_dim=False))
    e_canny = edges.canny(blurred, b["canny_low"], b["canny_high"])
    mag = edges.sobel_magnitude(gray)
    maxmag = (torch.amax(mag, dim=(-2, -1), keepdim=True)
              if mag_max is None else mag_max[..., None, None])
    mag_u8 = torch.floor(mag / torch.clamp(maxmag, min=1e-6) * 255.0)
    e_sobel = mag_u8 > b["sobel_thresh"]
    e_lap = edges.uint8_wrap(torch.abs(edges.laplacian(gray))) > b["laplacian_thresh"]
    cand = (e_canny | e_sobel | e_lap) & band
    cand = morph.close_(cand, morph.ellipse_kernel(b["close_ksize"]))
    cand = morph.open_(cand, morph.ellipse_kernel(b["open_ksize"]))
    return cc.filter_components_by_geometry(
        cand, b["min_area"], b["max_area"], max_aspect=b["max_aspect"],
        min_w=b["min_w"], min_h=b["min_h"], strict_min_wh=b["strict_min_wh"])


_BURR = {"canny_band": _burr_canny_band, "multiscale": _burr_multiscale}


def _crop_box(pc: dict, frame_hw, margin: int = 24):
    """The static burr crop around the ROI, its width rounded up to a
    multiple of 128 columns (`stages.roi_crop_box`)."""
    H, W = frame_hw
    y1, y2, x1, x2 = roi_box(pc, frame_hw)
    b = pc["burr"]
    pad = b["band_px"] + max(b["close_ksize"], b["open_ksize"]) + margin
    x1, x2, y1, y2 = max(x1 - pad, 0), min(x2 + pad, W), max(y1 - pad, 0), min(y2 + pad, H)
    return y1, y2, x1, min(x1 + ((x2 - x1 + 127) // 128) * 128, W)


def burr(gray: torch.Tensor, cable: torch.Tensor, pc: dict) -> torch.Tensor:
    """The burr mask (B, H, W) of `cable` on `gray`, on the crop around the
    ROI, pasted back; empty where no frame of the batch holds cable."""
    fn = _BURR[pc["burr"]["method"]]
    H, W = gray.shape[-2:]
    y1, y2, x1, x2 = _crop_box(pc, (H, W))
    mag_max = (torch.amax(edges.sobel_magnitude(gray), dim=(-2, -1))
               if fn is _burr_multiscale else None)
    crop = fn(gray[..., y1:y2, x1:x2].contiguous(), cable[..., y1:y2, x1:x2].contiguous(),
              pc["burr"], mag_max)
    out = F.pad(crop, (x1, W - x2, y1, H - y2))
    return torch.where(cable.any(), out, False)


def conditioned(frames_u8: torch.Tensor, pc: dict,
                planes: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR frames -> the float32 BGR frames the model and the burr
    stage read: rotate, resize, enhance. `planes`: the type each stage's
    planes are kept in between stages (the control's bfloat16 is one step
    below the configuration's float32; uint8 frames convert exactly)."""
    pp = pc["preprocess"]
    keep = lambda t: t.to(planes).to(torch.float32)
    x = keep(frames_u8.to(torch.float32))
    if pp["rotate90_ccw"]:
        x = image.rotate90_ccw(x)
    if pp["normalize_wh"] is not None:
        w, h = pp["normalize_wh"]
        x = keep(image.resize_bilinear(x, (h, w)))
    if pp["enhance"]:
        L, a, b = (keep(t) for t in color.bgr2lab(x))
        L = keep(clahe.clahe(torch.clamp(torch.round(L), 0, 255), pp["clahe_clip"],
                             pp["clahe_grid"]))
        x = keep(color.lab2bgr(L, a, b))
        if pp["denoise"] != "nlm":
            raise NotImplementedError(f"denoise {pp['denoise']!r}: the reference has nlm only")
        L, a, b = (keep(t) for t in color.bgr2lab(x))
        L, a, b = (keep(kernels.nlm(p.contiguous(), 10.0, 7, 21)) for p in (L, a, b))
        x = keep(torch.clamp(image.sharpen(color.lab2bgr(L, a, b)), 0.0, 255.0))
    return x


def model_input(frames: torch.Tensor, pc: dict) -> torch.Tensor:
    """Conditioned BGR frames -> (B, 3, h, w) RGB / 255 at the model size."""
    w, h = pc["preprocess"]["model_size"]
    rgb = image.resize_bilinear(color.bgr2rgb(frames), (h, w))
    return (rgb / 255.0).permute(0, 3, 1, 2).contiguous()


def masks_to_frame(pred: torch.Tensor, frame_hw, pc: dict):
    """(B, h, w) classes -> the cable and tape masks at the frame, in the ROI."""
    cable = image.resize_nearest(pred == 1, frame_hw, channel_dim=False)
    tape = image.resize_nearest(pred == 2, frame_hw, channel_dim=False)
    return _roi_limit(cable, pc), _roi_limit(tape, pc)


def run(frames_u8: torch.Tensor, sd: Dict[str, torch.Tensor], pc: dict,
        quant: Optional[nested_unet.Quant] = None,
        planes: torch.dtype = torch.float32) -> Step:
    """The whole step on a (B, H, W, 3) uint8 batch; `quant` and `planes`
    as the control computes it (`nested_unet.forward`, `conditioned`)."""
    with torch.inference_mode():
        frames = conditioned(frames_u8, pc, planes)
        logits = nested_unet.forward(sd, model_input(frames, pc), quant)
        H, W = frames.shape[1:3]
        cable, tape = masks_to_frame(torch.argmax(logits, dim=1), (H, W), pc)
        gray = color.bgr2gray(frames)
        bur = burr(gray, cable, pc)
        cm = torch.zeros((frames.shape[0], H, W), dtype=torch.uint8, device=frames.device)
        cm = torch.where(cable, 1, cm).to(torch.uint8)
        cm = torch.where(tape, 2, cm).to(torch.uint8)
        cm = torch.where(bur, 3, cm).to(torch.uint8)
        count = lambda m: m.sum(dim=(-2, -1), dtype=torch.int32)
        return Step(logits, gray, cm, count(cable), count(tape), count(bur))
