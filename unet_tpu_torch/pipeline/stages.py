"""The per-batch inspection step (counterpart of
unet_tpu/pipeline/stages.py:62-72, 78-99, 113-179, 250-310, 339-364,
490-611, 695-697, 718-745).

The port runs the branches the `two_stage` and `enhanced` presets take:
  1. uint8 BGR frames -> float32 (optional rotate / normalize)
  2. optional enhancement: CLAHE on Lab L, a denoiser (non-local means, the
     bilateral filter or none), sharpen
  3. BGR -> RGB, bilinear resize to the model size, / 255
  4. model forward, argmax, nearest resize back to the frame, ROI limit.
     The forward is the model's own (cuDNN convs without TF32 in fp32:
     `forward_logits`), or, for a custom-encoder NestedUNet, the BN-folded
     fast forward (`segment.fast_forward`) or the calibrated int8 forward
     (`segment.int8_scales`, from `calibrate_int8`) in the model's compute
     dtype (`segment_forward`)
  5. the `canny_band` or `multiscale` burr stage on a static crop around the
     ROI
  6. class map (0 bg / 1 cable / 2 tape / 3 burr) and pixel counts
  7. geometry (`geometry.enabled`): per-frame diameters from the largest
     cable and tape components, labelled at model resolution where that is
     exact, else at frame resolution; with `geometry.analyze_defects` the
     hole, component and defect-class analysis
Every other branch raises NotImplementedError naming its ROADMAP item.

Frames and masks keep the JAX package's layout, (B, H, W, 3) and (B, H, W);
the model sees NCHW.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models import fast_forward as _ff
from unet_tpu_torch.models import quantized as _q
from unet_tpu_torch.models.blocks import fp32_convs
from unet_tpu_torch.ops import cc as _cc
from unet_tpu_torch.ops import clahe as _clahe
from unet_tpu_torch.ops import color as _color
from unet_tpu_torch.ops import edges as _edges
from unet_tpu_torch.ops import frames as _frames_ops
from unet_tpu_torch.ops import geometry as _geo
from unet_tpu_torch.ops import image as _image
from unet_tpu_torch.ops import morph as _morph
from unet_tpu_torch.pipeline.config import BurrCfg, PipelineCfg


class FrameOutputs(NamedTuple):
    """Per-frame results of one batch."""
    class_map: torch.Tensor  # (B, H, W) uint8: 0 bg / 1 cable / 2 tape / 3 burr
    cable_px: torch.Tensor   # (B,) int32
    tape_px: torch.Tensor    # (B,) int32
    burr_px: torch.Tensor    # (B,) int32
    diameters: Optional[_geo.DiameterMetrics] = None  # geometry.enabled
    defects: Optional[_geo.DefectAnalysis] = None     # geometry.analyze_defects


def _unsupported(cfg: PipelineCfg) -> None:
    """Raise for the config branches later slices port."""
    pp, seg, post = cfg.preprocess, cfg.segment, cfg.postprocess
    todo = [
        (pp.enhance and pp.denoise not in _DENOISERS,
         f"preprocess.denoise {pp.denoise!r}: not a denoiser of the JAX package "
         f"({', '.join(_DENOISERS)}); ROADMAP A9"),
        (pp.dynamic_roi, "preprocess.dynamic_roi: ROADMAP A11"),
        (pp.letterbox, "preprocess.letterbox: ROADMAP A11"),
        (pp.normalization != "unit", "preprocess.normalization: ROADMAP A11"),
        (seg.threshold_mode != "argmax",
         f"threshold_mode {seg.threshold_mode!r}: ROADMAP A11"),
        (post.enabled or post.close_ksize > 0, "postprocess: ROADMAP A11"),
        (seg.pred_full_from_thresholds,
         "segment.pred_full_from_thresholds: ROADMAP A11"),
        (cfg.inspect.quality_stats or cfg.inspect.track_defects,
         "inspect stats: ROADMAP A11"),
        (cfg.burr.method not in _BURR_METHODS,
         f"burr method {cfg.burr.method!r}: ROADMAP A11"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"{cfg.name}: {what}")


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

def geometric_preprocess(frames_bgr: torch.Tensor, cfg: PipelineCfg) -> torch.Tensor:
    """uint8 BGR (B, H, W, 3) -> float32 BGR at the pipeline working
    resolution (rotate / normalize only)."""
    if frames_bgr.ndim != 4 or frames_bgr.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) BGR frames, got {tuple(frames_bgr.shape)}")
    x = frames_bgr.to(torch.float32)
    if cfg.preprocess.rotate90_ccw:
        x = _image.rotate90_ccw(x)
    if cfg.preprocess.normalize_wh is not None:
        w, h = cfg.preprocess.normalize_wh
        x = _image.resize_bilinear(x, (h, w))
    return x


def enhance_frames(bgr: torch.Tensor, cfg: PipelineCfg) -> torch.Tensor:
    """CLAHE(L) + denoise + sharpen (reference infer_enhanced_burr.py:38-66).
    cfg.preprocess.denoise: 'nlm' / 'fastNlMeans' -- the enhanced preset's
    default -- is fastNlMeansDenoisingColored(h=10, hColor=10, 7, 21)
    (ops.frames.nlm_denoise_colored, kernel B2 on the card); 'bilateral' is
    the reference's configurable alternative; 'none' skips denoising."""
    l, a, b = _color.bgr2lab(bgr)
    l = _clahe.clahe(torch.clamp(torch.round(l), 0, 255),
                     cfg.preprocess.clahe_clip, cfg.preprocess.clahe_grid)
    out = _color.lab2bgr(l, a, b)
    if cfg.preprocess.denoise == "bilateral":
        out = _image.bilateral_filter(out, d=7, sigma_color=25.0, sigma_space=5.0)
    elif cfg.preprocess.denoise in ("nlm", "fastNlMeans"):
        out = _frames_ops.nlm_denoise_colored(out, h=10.0, h_color=10.0)
    return torch.clamp(_image.sharpen(out), 0.0, 255.0)


def preprocess_frames(frames_bgr: torch.Tensor, cfg: PipelineCfg) -> torch.Tensor:
    """uint8 BGR (B, H, W, 3) -> conditioned BGR float32 frames at the
    pipeline working resolution (rotate / normalize / enhance)."""
    x = geometric_preprocess(frames_bgr, cfg)
    if cfg.preprocess.enhance:
        x = enhance_frames(x, cfg)
    return x


def model_input(frames_bgr: torch.Tensor, cfg: PipelineCfg) -> torch.Tensor:
    """BGR float frames -> RGB / 255 at model resolution, (B, h, w, 3)
    (reference preprocess_image, infer_two_stage_burr.py:122-127)."""
    w, h = cfg.preprocess.model_size
    x = _image.resize_bilinear(_color.bgr2rgb(frames_bgr), (h, w))
    return x / 255.0


def forward_logits(model: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """The model forward, (B, 3, h, w) -> (B, C, h, w) logits (the first
    head where the model returns several), with cuDNN's float32 convs in
    full fp32 whatever the process-wide setting, which is restored on return
    (`models.blocks.fp32_convs`): TF32 would put the fp32 forward outside the
    1e-3 logits gate it is held to (tests/test_models_parity.py). Forwards
    from several threads run one at a time (their launches; the card's work
    stays asynchronous)."""
    with fp32_convs():
        logits = model(x)
    if isinstance(logits, (list, tuple)):
        logits = logits[0]
    return logits


def segment_forward(model: nn.Module, cfg: PipelineCfg,
                    device: Union[str, torch.device]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The stage-1 forward on `device`: (B, h, w, 3) model input -> (B, C,
    h, w) logits (unet_tpu/pipeline/stages.py:523-537). With
    `segment.int8_scales` the calibrated int8 forward, else with
    `segment.fast_forward` the BN-folded fast forward, both in the model's
    compute dtype (`NestedUNet.dtype`) and both only for a custom-encoder
    NestedUNet (ValueError otherwise); else the model itself.
    The weights are prepared here, once, not on every batch. The model is
    moved to `device` and put in eval mode."""
    seg = cfg.segment
    model = model.to(device).eval()
    if not (seg.fast_forward or seg.int8_scales):
        return lambda x: forward_logits(model, x.permute(0, 3, 1, 2).contiguous())
    if not isinstance(model, NestedUNet):
        raise ValueError("segment.fast_forward/int8_scales require a "
                         "custom-encoder NestedUNet (models/fast_forward)")
    sd = model.state_dict()
    if seg.int8_scales:
        qp = _q.prepare_int8_params(sd, seg.int8_scales, model.dtype, device)
        fwd = lambda x: _q.nested_unet_forward_int8(qp, x)
    else:
        fp = _ff.prepare_fast_params(sd, model.dtype, device)
        fwd = lambda x: _ff.nested_unet_forward_fast(fp, x)
    return lambda x: forward_logits(fwd, x).permute(0, 3, 1, 2)


def extract_masks(logits: torch.Tensor, cfg: PipelineCfg):
    """logits (B, C, h, w) -> (cable, tape) bool masks at model resolution;
    argmax mode (infer_two_stage_burr.py:299-300), first index on ties."""
    pred = torch.argmax(logits, dim=1)
    return pred == cfg.segment.cable_cls, pred == cfg.segment.tape_cls


def roi_limit(mask: torch.Tensor, roi, frame_hw) -> torch.Tensor:
    """Zero the mask outside the ROI (reference infer_two_stage_burr.py:310-314)."""
    if roi is None:
        return mask
    h, w = frame_hw
    r = roi.scaled((w, h)) if roi.space != (w, h) else roi
    sel = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    sel[max(r.y1, 0):min(r.y2, h), max(r.x1, 0):min(r.x2, w)] = True
    return mask & sel


# ---------------------------------------------------------------------------
# burr detection (stage 2)
# ---------------------------------------------------------------------------

def burr_canny_band(gray: torch.Tensor, cable: torch.Tensor, b: BurrCfg) -> torch.Tensor:
    """Two-stage burr detector (reference detect_burrs_on_cable,
    infer_two_stage_burr.py:50-119): Canny edges inside the dilate-band,
    close/open, then the CC area/aspect/size filter."""
    band = _morph.outer_band(cable, _morph.ellipse_kernel(b.band_px))
    blurred = torch.round(_image.gaussian_blur(gray, b.blur_ksize, b.blur_sigma,
                                               channel_dim=False))
    edges = _edges.canny(blurred, b.canny_low, b.canny_high)
    cand = edges & band
    cand = _morph.close_(cand, _morph.ellipse_kernel(b.close_ksize))
    cand = _morph.open_(cand, _morph.ellipse_kernel(b.open_ksize))
    return _cc.filter_components_by_geometry(
        cand, b.min_area, b.max_area, max_aspect=b.max_aspect,
        min_w=b.min_w, min_h=b.min_h, strict_min_wh=b.strict_min_wh)


def burr_multiscale(gray: torch.Tensor, cable: torch.Tensor, b: BurrCfg,
                    mag_max: torch.Tensor = None) -> torch.Tensor:
    """Multi-scale edge-fusion burr detector (reference
    detect_burrs_enhanced, infer_enhanced_burr.py:69-138): Canny |
    Sobel-magnitude | |Laplacian| inside a wide band, close/open, then the
    CC gates. `mag_max` (B,) is the FULL-frame Sobel-magnitude max when the
    stage runs on a crop (the reference normalizes over the frame, :97)."""
    band = _morph.outer_band(cable, _morph.ellipse_kernel(b.band_px))
    blurred = torch.round(_image.gaussian_blur(gray, b.blur_ksize, b.blur_sigma,
                                               channel_dim=False))
    e_canny = _edges.canny(blurred, b.canny_low, b.canny_high)
    mag = _edges.sobel_magnitude(gray)
    maxmag = (torch.amax(mag, dim=(-2, -1), keepdim=True)
              if mag_max is None else mag_max[..., None, None])
    mag_u8 = torch.floor(mag / torch.clamp(maxmag, min=1e-6) * 255.0)
    e_sobel = mag_u8 > b.sobel_thresh
    e_lap = _edges.uint8_wrap(torch.abs(_edges.laplacian(gray))) > b.laplacian_thresh
    cand = (e_canny | e_sobel | e_lap) & band
    cand = _morph.close_(cand, _morph.ellipse_kernel(b.close_ksize))
    cand = _morph.open_(cand, _morph.ellipse_kernel(b.open_ksize))
    return _cc.filter_components_by_geometry(
        cand, b.min_area, b.max_area, max_aspect=b.max_aspect,
        min_w=b.min_w, min_h=b.min_h, strict_min_wh=b.strict_min_wh)


_BURR_METHODS = {"canny_band": burr_canny_band, "multiscale": burr_multiscale,
                 "none": None}
_DENOISERS = ("nlm", "fastNlMeans", "bilateral", "none")


def roi_crop_box(cfg: PipelineCfg, frame_hw, margin: int = 24):
    """(y1, y2, x1, x2) of the static burr crop around the ROI, exactly the
    reference's box (stages.py:347-355), including the round-up of the width
    to a multiple of 128 columns. 800x448 frames with ROI(140, 0, 270, 512)
    (two_stage) give rows 0-448 and columns 183-567, a 448x384 crop; with
    ROI(200, 0, 600, 448) in (800, 448) (enhanced), rows 0-448 and columns
    146-658, a 448x512 crop."""
    h, w = frame_hw
    r = cfg.roi.scaled((w, h)) if cfg.roi.space != (w, h) else cfg.roi
    pad = cfg.burr.band_px + max(cfg.burr.close_ksize, cfg.burr.open_ksize) + margin
    x1 = max(r.x1 - pad, 0)
    x2 = min(r.x2 + pad, w)
    y1 = max(r.y1 - pad, 0)
    y2 = min(r.y2 + pad, h)
    x2 = min(x1 + ((x2 - x1 + 127) // 128) * 128, w)
    return y1, y2, x1, x2


def _burr_on_roi_crop(gray: torch.Tensor, cable: torch.Tensor,
                      cfg: PipelineCfg, burr_fn, frame_hw) -> torch.Tensor:
    """Run the burr stage on the static crop around the ROI and paste back.
    Hysteresis, the filters and the CC filter all see the crop edge, so the
    box is part of the result. The multiscale stage normalizes by the
    full-frame Sobel-magnitude max, taken before the crop."""
    y1, y2, x1, x2 = roi_crop_box(cfg, frame_hw)
    kw = {}
    if burr_fn is burr_multiscale:
        kw["mag_max"] = torch.amax(_edges.sobel_magnitude(gray), dim=(-2, -1))
    crop = burr_fn(gray[..., y1:y2, x1:x2].contiguous(),
                   cable[..., y1:y2, x1:x2].contiguous(), cfg.burr, **kw)
    out = torch.zeros(gray.shape, dtype=torch.bool, device=gray.device)
    out[..., y1:y2, x1:x2] = crop
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@torch.inference_mode()
def run_pipeline(forward: Callable[[torch.Tensor], torch.Tensor], frames_bgr: torch.Tensor,
                 cfg: PipelineCfg) -> FrameOutputs:
    """The full step over one (B, H, W, 3) uint8 BGR batch, on the device of
    `frames_bgr`. `forward` is the stage-1 forward on that device,
    `segment_forward(model, cfg, device)`."""
    _unsupported(cfg)
    frames = preprocess_frames(frames_bgr, cfg)
    B, H, W = frames.shape[:3]

    logits = forward(model_input(frames, cfg))
    cable_m, tape_m = extract_masks(logits, cfg)

    cable = roi_limit(_image.resize_nearest(cable_m, (H, W), channel_dim=False),
                      cfg.roi, (H, W))
    tape = roi_limit(_image.resize_nearest(tape_m, (H, W), channel_dim=False),
                     cfg.roi, (H, W))

    # the reference skips the burr stage when no frame holds cable
    # (infer_two_stage_burr.py:69-70), the JAX step by lax.cond on the
    # device. The port runs it and selects on the device: a host branch on
    # cable.any() would wait for the forward and keep the host from queueing
    # the next batch behind it
    burr_fn = _BURR_METHODS[cfg.burr.method]
    if burr_fn is not None:
        gray = _color.bgr2gray(frames)
        if cfg.roi is not None:
            burr = _burr_on_roi_crop(gray, cable, cfg, burr_fn, (H, W))
        else:
            burr = burr_fn(gray, cable, cfg.burr)
        burr = torch.where(cable.any(), burr, False)
    else:
        burr = torch.zeros_like(cable)

    class_map = torch.zeros((B, H, W), dtype=torch.uint8, device=cable.device)
    class_map = torch.where(cable, 1, class_map).to(torch.uint8)
    class_map = torch.where(tape, 2, class_map).to(torch.uint8)
    class_map = torch.where(burr, 3, class_map).to(torch.uint8)
    return FrameOutputs(
        class_map=class_map,
        cable_px=cable.sum(dim=(-2, -1), dtype=torch.int32),
        tape_px=tape.sum(dim=(-2, -1), dtype=torch.int32),
        burr_px=burr.sum(dim=(-2, -1), dtype=torch.int32),
        diameters=_diameters(cable_m, tape_m, cable, tape, cfg),
        defects=_defects(logits, cable, tape, cfg),
    )


def _diameters(cable_m: torch.Tensor, tape_m: torch.Tensor, cable: torch.Tensor,
               tape: torch.Tensor, cfg: PipelineCfg) -> Optional[_geo.DiameterMetrics]:
    """The geometry stage (unet_tpu/pipeline/stages.py:629-645): diameters
    from the largest cable and tape components of each frame, or None
    without `geometry.enabled`. Where the model's masks reach the frame by a
    nearest upscale alone (no ROI and H, W at least the model's h, w), the
    components are labelled at model resolution, which is exact and
    cheaper; otherwise at frame resolution, with a 50-pixel floor."""
    g = cfg.geometry
    if not g.enabled:
        return None
    H, W = cable.shape[-2:]
    mh, mw = cable_m.shape[-2:]
    pp, post = cfg.preprocess, cfg.postprocess
    if (cfg.roi is None and not post.enabled and not pp.letterbox and not pp.dynamic_roi
            and not post.close_ksize and H >= mh and W >= mw):
        cable_d = _geo.largest_component_lowres(cable_m, (H, W))
        tape_d = _geo.largest_component_lowres(tape_m, (H, W))
    else:
        cable_d = _cc.largest_component(cable, min_area=50)
        tape_d = _cc.largest_component(tape, min_area=50)
    return _geo.diameter_metrics_from_masks(cable_d, tape_d, mm_per_px=g.mm_per_px,
                                            min_valid_rows=g.min_valid_rows,
                                            smooth_ksize=g.smooth_ksize)


def _defects(logits: torch.Tensor, cable: torch.Tensor, tape: torch.Tensor,
             cfg: PipelineCfg) -> Optional[_geo.DefectAnalysis]:
    """`geometry.analyze_defects` (unet_tpu/pipeline/stages.py:612-627,
    647-660): the analysis of a frame-resolution map of cable (1) and tape
    (2) from the final masks, over which a model of more than 3 classes
    lays its defect classes (>= 3, argmax, through `segment.class_remap`)."""
    g, seg = cfg.geometry, cfg.segment
    if not g.analyze_defects:
        return None
    H, W = cable.shape[-2:]
    amap = torch.where(tape, 2, torch.where(cable, 1, 0)).to(torch.uint8)
    if seg.num_classes > 3:
        pred = torch.argmax(logits, dim=1)
        if seg.class_remap:
            pred = torch.as_tensor(np.asarray(seg.class_remap, np.uint8), device=pred.device)[pred]
        pred = _image.resize_nearest(pred.to(torch.uint8), (H, W), channel_dim=False)
        amap = torch.where(pred >= 3, pred, amap)
    return _geo.analyze_defects(amap, defect_classes=g.defect_classes,
                                hole_min_size=g.hole_min_size,
                                max_components=g.max_components)


def build_step(model: nn.Module, cfg: PipelineCfg, device: Union[str, torch.device] = "cuda"
               ) -> Callable[[Union[np.ndarray, torch.Tensor]], FrameOutputs]:
    """Returns step(frames_u8_bgr) -> FrameOutputs on `device`. The model is
    moved to `device` and put in eval mode, and the weights of the fast or
    int8 forward are prepared once (`segment_forward`); frames may be a
    numpy array or a tensor and are moved to `device`. There is no
    fallback: a `cuda` step without a card raises. A float32 forward runs
    with full-fp32 convs whatever the process-wide TF32 flags say, and
    leaves them as it found them (`forward_logits`)."""
    _unsupported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_step(device='cuda') needs a CUDA device")
    forward = segment_forward(model, cfg, device)

    def step(frames_bgr) -> FrameOutputs:
        frames = torch.as_tensor(frames_bgr).to(device)
        return run_pipeline(forward, frames, cfg)

    return step


@torch.inference_mode()
def calibrate_int8(model: nn.Module, cfg: PipelineCfg, frame_batches,
                   device: Union[str, torch.device] = "cuda") -> PipelineCfg:
    """Post-training int8 calibration on representative frames
    (unet_tpu/pipeline/stages.py:718-731): the step's preprocessing, then a
    float32 fast forward on `device` observing activation ranges. Returns
    cfg with `segment.int8_scales` filled, so that `build_step` runs the int8
    forward. `frame_batches`: (B, H, W, 3) uint8 BGR batches, numpy or
    tensors."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("calibrate_int8(device='cuda') needs a CUDA device")
    pre = (model_input(preprocess_frames(torch.as_tensor(b).to(device), cfg), cfg)
           for b in frame_batches)
    scales = _q.calibrate(model.state_dict(), pre)
    return cfg.replace_in("segment", int8_scales=scales)


def validate_int8(model: nn.Module, cfg: PipelineCfg, qcfg: PipelineCfg, frames,
                  device: Union[str, torch.device] = "cuda") -> float:
    """Class-map agreement between the float (`cfg`) and int8 (`qcfg`) steps
    on held-out frames (unet_tpu/pipeline/stages.py:734-745), the online
    proxy for the mIoU-delta gate; callers fall back to the float step below
    about 0.995."""
    ref = build_step(model, cfg, device)(frames)
    out = build_step(model, qcfg, device)(frames)
    return float((out.class_map == ref.class_map).float().mean())
