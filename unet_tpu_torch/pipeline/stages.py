"""The per-batch inspection step (counterpart of
unet_tpu/pipeline/stages.py).

Every branch of the JAX package's step runs here, so every preset of
`presets.PRESETS` does:
  1. uint8 BGR frames -> float32 (optional rotate / normalize); with
     `inspect.quality_stats` the quality gate's statistics of the gray
     frames (the first frame diffs against `prev_frame_bgr`, the previous
     batch's last frame, or against itself)
  2. optional enhancement: CLAHE on Lab L, a denoiser (non-local means, the
     bilateral filter or none), sharpen
  3. BGR -> RGB at the model size: a bilinear stretch, a letterbox
     (`preprocess.letterbox`) or the per-frame vertical ROI crop
     (`preprocess.dynamic_roi`: Canny, column projection, box smoothing);
     / 255 or ImageNet normalization
  4. model forward (cuDNN convs without TF32 in fp32: `forward_logits`;
     or the BN-folded fast forward or the calibrated int8 forward of a
     custom-encoder NestedUNet, `segment_forward`); cable and tape masks by
     `segment.threshold_mode` (argmax, per_class, relative, ultra_strict,
     exclusive: softmax probabilities in the logits' dtype)
  5. model-resolution component gates (`postprocess.mode` spatial or
     refine); back to the frame (nearest resize, un-letterbox or paste into
     the ROI span); the v3 close; the shape postprocess of `robust` (best
     scored cable component, tape in its ring, bbox limit, cleanup); the
     static ROI limit
  6. the burr stage (canny_band, multiscale, laplacian, dog) on a static
     crop around the ROI
  7. class map (0 bg / 1 cable / 2 tape / 3 burr) and pixel counts
  8. geometry (`geometry.enabled`): diameters from the largest cable and
     tape components, labelled at model resolution where that is exact,
     else at frame resolution; with `geometry.analyze_defects` the hole,
     component and defect-class analysis over the model's defect classes
     (argmax, or per-class probability thresholds with
     `segment.pred_full_from_thresholds`)
  9. `inspect.track_defects`: the top-K defect components (bbox, area,
     class at the root pixel) for the host's defect tracker
Connected components run on kernel B1 (`ops.cc_kernels.propagate`) on the
card. A denoiser the JAX package does not have raises NotImplementedError
(ROADMAP A9).

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
from unet_tpu_torch.models.blocks import ComputeDtype, fp32_convs
from unet_tpu_torch.ops import cc as _cc
from unet_tpu_torch.ops import clahe as _clahe
from unet_tpu_torch.ops import color as _color
from unet_tpu_torch.ops import edges as _edges
from unet_tpu_torch.ops import frames as _frames_ops
from unet_tpu_torch.ops import geometry as _geo
from unet_tpu_torch.ops import image as _image
from unet_tpu_torch.ops import morph as _morph
from unet_tpu_torch.parallel import spatial as _sp
from unet_tpu_torch.pipeline.config import BurrCfg, PipelineCfg, PostprocessCfg

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class QualityStats(NamedTuple):
    """Per-frame statistics of the frame quality gate (reference
    infer_video.py:73-118). The first frame of a batch diffs against the
    previous batch's last frame where the step is given one, else against
    itself (mad 0)."""
    lap_var: torch.Tensor   # (B,) Laplacian variance (blur)
    gray_std: torch.Tensor  # (B,) gray std (flat / glitch)
    mad: torch.Tensor       # (B,) mean abs diff against the previous frame


class DefectComponents(NamedTuple):
    """The top-K defect components of each frame for the host's
    DefectTracker (reference infer_video_optimized.py:66-189); (B, K)."""
    left: torch.Tensor
    top: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    area: torch.Tensor
    class_id: torch.Tensor  # uint8: the class at the component's root pixel
    valid: torch.Tensor


class FrameOutputs(NamedTuple):
    """Per-frame results of one batch."""
    class_map: torch.Tensor  # (B, H, W) uint8: 0 bg / 1 cable / 2 tape / 3 burr
    cable_px: torch.Tensor   # (B,) int32
    tape_px: torch.Tensor    # (B,) int32
    burr_px: torch.Tensor    # (B,) int32
    diameters: Optional[_geo.DiameterMetrics] = None      # geometry.enabled
    defects: Optional[_geo.DefectAnalysis] = None         # geometry.analyze_defects
    defect_components: Optional[DefectComponents] = None  # inspect.track_defects
    quality: Optional[QualityStats] = None                # inspect.quality_stats


def _unsupported(cfg: PipelineCfg) -> None:
    """Raise for what the JAX package does not have either: a denoiser
    other than its own."""
    pp = cfg.preprocess
    if pp.enhance and pp.denoise not in _DENOISERS:
        raise NotImplementedError(
            f"{cfg.name}: preprocess.denoise {pp.denoise!r}: not a denoiser of the JAX "
            f"package ({', '.join(_DENOISERS)}); ROADMAP A9")


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


def quality_stats(gray: torch.Tensor, prev_gray: Optional[torch.Tensor] = None) -> QualityStats:
    """The quality gate's statistics of a gray (B, H, W) batch
    (`inspect.detectors.quality_stats`); `prev_gray` (H, W), the previous
    batch's last gray frame, is what frame 0 diffs against."""
    from unet_tpu_torch.inspect.detectors import quality_stats as _qs
    return QualityStats(*_qs(gray, prev_gray))


def model_input(frames_bgr: torch.Tensor, cfg: PipelineCfg, roi_bounds=None) -> torch.Tensor:
    """BGR float frames -> normalized RGB at model resolution, (B, h, w, 3)
    (reference preprocess_image, infer_two_stage_burr.py:122-127; letterbox,
    infer_video_robust.py:40-61). `roi_bounds`: the per-frame (x0, x1) of
    `detect_vertical_roi`, whose horizontal crop the model sees (reference
    infer_video_roi.py:201-212). ImageNet normalization is computed as the
    jitted JAX step computes it on the CPU: fma(x, float32(1 / 255), -mean)
    (one rounding, here through float64) times float32(1 / std)."""
    w, h = cfg.preprocess.model_size
    rgb = _color.bgr2rgb(frames_bgr)
    if roi_bounds is not None:
        x = _image.crop_resize_bilinear(rgb, roi_bounds[0], roi_bounds[1], (h, w))
    elif cfg.preprocess.letterbox:
        x = _image.letterbox(rgb, (h, w))
    else:
        x = _image.resize_bilinear(rgb, (h, w))
    if cfg.preprocess.normalization == "imagenet":
        mean = torch.as_tensor(IMAGENET_MEAN.astype(np.float64), device=x.device)
        inv_std = torch.as_tensor(np.float32(1.0) / IMAGENET_STD, device=x.device)
        return (x.double() * _image.recip32(255.0) - mean).to(torch.float32) * inv_std
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
    if not (isinstance(model, NestedUNet) and not model.pretrained_encoder):
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


def striped_segment_forward(model: nn.Module, cfg: PipelineCfg,
                            device: Union[str, torch.device]
                            ) -> Callable[[torch.Tensor, tuple, _sp.Stripes], torch.Tensor]:
    """`segment_forward` on H stripes over a spatial group
    (parallel.spatial): fn(x, counts, stripes) takes this rank's frames'
    model input (k, h, w, 3), `counts` the slice's frames over the group
    (`spatial.frame_split`), and returns their (k, C, h', w') logits, equal
    to `segment_forward`'s on one device (bit for bit on the CPU): the
    slice's frames are re-split into H stripes of the model input (bounds on
    multiples of `model.stripe_unit`), the forward of the same dtype runs on
    the stripes (`model(x, stripes)` for every model of the zoo, in
    float32 or its compute dtype; the custom-encoder NestedUNet's BN-folded
    and int8 forwards `fast_forward.nested_unet_forward_fast_striped`,
    `quantized.nested_unet_forward_int8_striped`), and the logits are
    re-split into this rank's whole frames at their own level (a quarter or
    half of the input's side for the zoo's low-resolution models), in the
    layout `segment_forward` gives them. A collective of the spatial group.
    A model without a striped forward raises NotImplementedError; the
    BN-folded and int8 forwards of another model raise ValueError, as
    `segment_forward` does."""
    seg = cfg.segment
    if not isinstance(model, ComputeDtype):
        raise NotImplementedError(f"{type(model).__name__} has no forward on H stripes: the "
                                  f"models of the zoo (models.blocks.ComputeDtype) have one")
    model = model.to(device).eval()
    if not (seg.fast_forward or seg.int8_scales):
        def plain(x, counts, st):
            xs = _sp.frames_to_stripes(x, counts, st, axis=1).permute(0, 3, 1, 2).contiguous()
            logits = forward_logits(lambda t: model(t, st), xs)
            return _sp.stripes_to_frames(logits, counts, st.at(logits.shape[2]), axis=2)

        return plain
    if not (isinstance(model, NestedUNet) and not model.pretrained_encoder):
        raise ValueError("segment.fast_forward/int8_scales require a "
                         "custom-encoder NestedUNet (models/fast_forward)")
    sd = model.state_dict()
    if seg.int8_scales:
        qp = _q.prepare_int8_params(sd, seg.int8_scales, model.dtype, device)
        fwd = lambda x, st: _q.nested_unet_forward_int8_striped(qp, x, st)
    else:
        fp = _ff.prepare_fast_params(sd, model.dtype, device)
        fwd = lambda x, st: _ff.nested_unet_forward_fast_striped(fp, x, st)

    def nhwc(x, counts, st):
        xs = _sp.frames_to_stripes(x, counts, st, axis=1)
        logits = forward_logits(lambda t: fwd(t, st), xs)
        return _sp.stripes_to_frames(logits, counts, st, axis=1).permute(0, 3, 1, 2)

    return nhwc


def _c(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX types it beside an array of `dtype` (a weak
    type: rounded to that dtype)."""
    return float(torch.tensor(value, dtype=dtype))


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the class axis of (B, C, h, w) logits, in their
    dtype, as the jitted JAX function computes it on the CPU: x - max in
    the dtype, its exp in float32, the exps summed in float32 in class
    order, then each exp and the sum rounded to the dtype and divided (a
    true division)."""
    e = torch.exp((logits - logits.amax(dim=1, keepdim=True)).to(torch.float32))
    s = e[:, 0]
    for c in range(1, e.shape[1]):
        s = s + e[:, c]
    return e.to(logits.dtype) / s.to(logits.dtype)[:, None]


def extract_masks(logits: torch.Tensor, cfg: PipelineCfg):
    """logits (B, C, h, w) -> (cable, tape) bool masks at model resolution,
    by `segment.threshold_mode` (unet_tpu/pipeline/stages.py:165-247):
      argmax       argmax of the logits, first index on ties
                   (infer_two_stage_burr.py:299-300)
      per_class    per-class probability thresholds, tape over cable, or
                   the mutual ratio gate `ct_ratio` (infer_video_simple.py:82-154,
                   infer_video_v3_high_quality.py)
      relative     thresholds relative to the background, the higher
                   probability wins an overlap (infer_video_spatial.py:71-98)
      ultra_strict adaptive thresholds from the frame's mean probabilities
                   (infer_video_roi.py:60-126)
      exclusive    thresholds with background and cable/tape margins
                   (infer_video_robust.py:70-99)
    Probabilities are in the logits' dtype (`softmax`); a class threshold
    is a float32 array in the JAX package, so those comparisons are in
    float32; every other constant is rounded to the dtype first."""
    seg = cfg.segment
    if seg.threshold_mode == "argmax":
        pred = torch.argmax(logits, dim=1)
        return pred == seg.cable_cls, pred == seg.tape_cls
    if seg.threshold_mode not in ("per_class", "relative", "ultra_strict", "exclusive"):
        raise ValueError(seg.threshold_mode)
    probs = softmax(logits)
    dt = probs.dtype
    p_bg, p_c, p_t = probs[:, 0], probs[:, seg.cable_cls], probs[:, seg.tape_cls]
    th = np.asarray(seg.class_thresholds, np.float32)
    at_least = lambda p, k: p.to(torch.float32) >= float(th[k])

    if seg.threshold_mode == "per_class":
        cable, tape = at_least(p_c, seg.cable_cls), at_least(p_t, seg.tape_cls)
        if seg.ct_ratio > 0:
            r = _c(seg.ct_ratio, dt)
            return cable & (p_c > p_t * r), tape & (p_t > p_c * r)
        return cable & ~tape, tape

    if seg.threshold_mode == "relative":
        cable = p_c > p_bg * _c(seg.bg_ratio_cable, dt)
        tape = p_t > p_bg * _c(seg.bg_ratio_tape, dt)
        overlap = cable & tape
        cable_wins = p_c >= p_t
        return torch.where(overlap, cable_wins, cable), torch.where(overlap, ~cable_wins, tape)

    if seg.threshold_mode == "ultra_strict":
        n = p_c.shape[-2] * p_c.shape[-1]
        mean = lambda p: (p.to(torch.float32).sum(dim=(-2, -1), keepdim=True)
                          * _image.recip32(n)).to(dt)
        mean_c, mean_t, mean_bg = mean(p_c), mean(p_t), mean(p_bg)
        t_cable = torch.where(mean_c > _c(0.3, dt),
                              torch.clamp(mean_c + _c(0.4, dt), max=_c(0.85, dt)), _c(0.5, dt))
        t_tape = torch.where(mean_t > _c(0.15, dt),
                             torch.clamp(mean_t + _c(0.5, dt), max=_c(0.85, dt)), _c(0.55, dt))
        bg_margin = torch.clamp(1.0 - mean_bg, min=_c(0.2, dt))
        winner = torch.argmax(probs, dim=1)
        two = _c(2.0, dt)
        cable = ((winner == seg.cable_cls) & (p_c >= t_cable) & (p_c > p_bg * two)
                 & (p_c >= p_bg + bg_margin))
        tape = ((winner == seg.tape_cls) & (p_t >= t_tape) & (p_t > p_bg * two)
                & (p_t >= p_bg + bg_margin))
        return cable, tape

    bg_m, ct_m = _c(seg.bg_margin, dt), _c(seg.ct_margin, dt)
    c_ok = at_least(p_c, seg.cable_cls) & (p_c > p_bg + bg_m)
    t_ok = at_least(p_t, seg.tape_cls) & (p_t > p_bg + bg_m)
    cable = c_ok & (p_c > p_t + ct_m)
    tape = t_ok & (p_t >= p_c - ct_m)
    return cable, tape & ~cable


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


def burr_laplacian(gray: torch.Tensor, cable: torch.Tensor, b: BurrCfg) -> torch.Tensor:
    """Laplacian band threshold (reference src/refactor/burr_detector.py:11-66):
    band_px is the reference's band_out, the SE a (2 * band_out + 1) ellipse."""
    band = _morph.outer_band(cable, _morph.ellipse_kernel(2 * b.band_px + 1))
    lap_u8 = _edges.uint8_wrap(torch.abs(_edges.laplacian(gray)))
    return _cc.filter_components_by_geometry((lap_u8 > b.laplacian_thresh) & band,
                                             b.min_area, b.max_area)


def burr_dog(gray: torch.Tensor, cable: torch.Tensor, b: BurrCfg) -> torch.Tensor:
    """Difference-of-Gaussians alternative (reference
    src/refactor/burr_detector.py:69-118)."""
    band = _morph.outer_band(cable, _morph.ellipse_kernel(2 * b.band_px + 1))
    return _cc.filter_components_by_geometry((_edges.dog(gray) > b.laplacian_thresh) & band,
                                             b.min_area, b.max_area)


_BURR_METHODS = {"canny_band": burr_canny_band, "multiscale": burr_multiscale,
                 "laplacian": burr_laplacian, "dog": burr_dog, "none": None}
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
    H, W = frame_hw
    return torch.nn.functional.pad(crop, (x1, W - x2, y1, H - y2))


# ---------------------------------------------------------------------------
# component postprocess: at model resolution (spatial, roi_first), and the
# shape postprocess of robust at frame resolution
# ---------------------------------------------------------------------------

def spatial_strip_filter(mask: torch.Tensor, w_bounds, p: PostprocessCfg) -> torch.Tensor:
    """Vertical-strip component gates at model resolution: components with
    area > spatial_min_area, width within `w_bounds` and height >= H *
    spatial_min_height_ratio (reference spatial_filter,
    infer_video_spatial.py:24-53)."""
    H = mask.shape[-2]
    labels = _cc.connected_components(mask)
    st = _cc.component_stats(labels, p.max_components)
    keep = ((st.area > p.spatial_min_area) & (st.width >= w_bounds[0])
            & (st.width <= w_bounds[1])
            & (st.height.to(torch.float32) >= float(np.float32(H * p.spatial_min_height_ratio))))
    return _cc.keep_mask(labels, st, keep)


def refine_mask_by_geometry(mask: torch.Tensor, p: PostprocessCfg) -> torch.Tensor:
    """Aspect and position gates at model resolution (reference
    refine_mask_by_geometry, infer_video_roi.py:128-167): drop area <
    refine_min_area, wide squat components (h / w < refine_aspect while w >
    refine_wide_w), and components whose centroid lies within
    refine_edge_frac of the left or right edge unless area >=
    refine_edge_area. The centroid is `component_stats`' exactly rounded
    one (ROADMAP C: the JAX package sums it in float32)."""
    W = mask.shape[-1]
    labels = _cc.connected_components(mask)
    st = _cc.component_stats(labels, p.max_components)
    aspect = st.height.to(torch.float32) / torch.clamp(st.width.to(torch.float32), min=1.0)
    keep = (st.area >= p.refine_min_area) & ~((aspect < p.refine_aspect)
                                              & (st.width > p.refine_wide_w))
    near_edge = ((st.cx < float(np.float32(W * p.refine_edge_frac)))
                 | (st.cx > float(np.float32(W * (1.0 - p.refine_edge_frac)))))
    keep = keep & ~(near_edge & (st.area < p.refine_edge_area))
    return _cc.keep_mask(labels, st, keep)


def defect_map_from_thresholds(logits: torch.Tensor, cable: torch.Tensor, tape: torch.Tensor,
                               cfg: PipelineCfg, frame_hw) -> torch.Tensor:
    """Frame-resolution class map whose defect classes come from
    per-channel probability thresholds and per-mask open/close, not the
    argmax, later channels over earlier ones over tape over cable
    (reference infer_video_v3_high_quality.py predict()). Channel k is
    class `class_remap[k]`."""
    seg = cfg.segment
    probs = softmax(logits)
    remap = seg.class_remap or tuple(range(seg.num_classes))
    out = torch.where(tape, 2, torch.where(cable, 1, 0)).to(torch.uint8)
    thr = _c(seg.defect_threshold, probs.dtype)
    for k in range(3, seg.num_classes):
        m = probs[:, k].to(torch.float32) >= thr
        if seg.defect_open_ksize:
            m = _morph.open_(m, _morph.ellipse_kernel(seg.defect_open_ksize))
        if seg.defect_close_ksize:
            m = _morph.close_(m, _morph.ellipse_kernel(seg.defect_close_ksize))
        m = _image.resize_nearest(m, frame_hw, channel_dim=False)
        out = torch.where(m, remap[k], out).to(torch.uint8)
    return out


def filter_cable_by_shape(cable: torch.Tensor, p: PostprocessCfg, roi_width: int) -> torch.Tensor:
    """The best-scored cable component, score = area * aspect * (1 -
    offset) under area, aspect and centre gates (reference
    src/refactor/postprocess.py:12-76). The offset's `/ roi_width` is the
    jitted product with float32(1 / roi_width); ties of the score go to
    the first of the top-16 components."""
    labels = _cc.connected_components(cable)
    st = _cc.component_stats(labels, 16)
    aspect = (torch.maximum(st.width, st.height)
              / (torch.minimum(st.width, st.height) + 1e-6))
    offset = torch.abs(st.cx - roi_width / 2.0) * _image.recip32(roi_width)
    ok = (st.valid & (st.area >= p.cable_min_area) & (aspect >= p.cable_min_aspect)
          & (offset <= p.cable_max_center_offset))
    score = torch.where(ok, st.area * aspect * (1.0 - offset), -1.0)
    best = torch.argmax(score, dim=-1, keepdim=True)
    keep = torch.zeros_like(ok).scatter_(-1, best, True) & (score.gather(-1, best) > 0)
    return _cc.keep_mask(labels, st, keep)


def cable_bbox_limit(mask: torch.Tensor, cable: torch.Tensor, pad: int) -> torch.Tensor:
    """`mask` outside the cable's bounding box + `pad` zeroed; all zero
    without cable (reference apply_roi_limit, infer_video_robust.py:201-216)."""
    H, W = mask.shape[-2:]
    rows_any, cols_any = cable.any(dim=-1), cable.any(dim=-2)
    first = lambda v: torch.argmax(v.to(torch.uint8), dim=-1)
    r0, r1 = first(rows_any) - pad, H - 1 - first(rows_any.flip(-1)) + pad
    c0, c1 = first(cols_any) - pad, W - 1 - first(cols_any.flip(-1)) + pad
    ri = torch.arange(H, device=mask.device)
    ci = torch.arange(W, device=mask.device)
    row_ok = (ri >= r0[..., None]) & (ri <= r1[..., None])
    col_ok = (ci >= c0[..., None]) & (ci <= c1[..., None])
    box = row_ok[..., :, None] & col_ok[..., None, :]
    return mask & box & rows_any.any(dim=-1)[..., None, None]


def constrain_tape_to_ring(tape: torch.Tensor, cable: torch.Tensor,
                           p: PostprocessCfg) -> torch.Tensor:
    """Tape in the dilate-erode ring around the cable, its largest
    component kept (reference src/refactor/postprocess.py:79-118)."""
    ring = (_morph.dilate(cable, _morph.ellipse_kernel(p.tape_ring_dilate))
            & ~_morph.erode(cable, _morph.ellipse_kernel(p.tape_ring_erode)))
    return _cc.largest_component(tape & ring)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@torch.inference_mode()
def run_pipeline(forward: Callable[[torch.Tensor], torch.Tensor], frames_bgr: torch.Tensor,
                 cfg: PipelineCfg, prev_frame_bgr: Optional[torch.Tensor] = None) -> FrameOutputs:
    """The full step over one (B, H, W, 3) uint8 BGR batch, on the device of
    `frames_bgr`. `forward` is the stage-1 forward on that device,
    `segment_forward(model, cfg, device)`. `prev_frame_bgr` (1, H, W, 3):
    the previous batch's last frame, read only by the quality statistics'
    motion diff."""
    _unsupported(cfg)
    pp, post = cfg.preprocess, cfg.postprocess
    frames = geometric_preprocess(frames_bgr, cfg)
    B, H, W = frames.shape[:3]

    quality = None
    if cfg.inspect.quality_stats:
        # on the frames before enhancement, as the reference's gate
        # (infer_video.py:84)
        prev_gray = None
        if prev_frame_bgr is not None:
            prev_gray = _color.bgr2gray(geometric_preprocess(prev_frame_bgr, cfg))[0]
        quality = quality_stats(_color.bgr2gray(frames), prev_gray)

    if pp.enhance:
        frames = enhance_frames(frames, cfg)

    roi_bounds = None
    if pp.dynamic_roi:
        roi_bounds = _image.detect_vertical_roi(
            _color.bgr2gray(frames), smooth=pp.dynamic_roi_smooth,
            rel_thresh=pp.dynamic_roi_thresh, margin_frac=pp.dynamic_roi_margin)

    logits = forward(model_input(frames, cfg, roi_bounds))
    cable_m, tape_m = extract_masks(logits, cfg)

    if post.enabled and post.mode == "spatial":
        cable_m = spatial_strip_filter(cable_m, post.spatial_cable_w, post)
        tape_m = spatial_strip_filter(tape_m, post.spatial_tape_w, post)
    elif post.enabled and post.mode == "refine":
        cable_m = refine_mask_by_geometry(cable_m, post)
        tape_m = refine_mask_by_geometry(tape_m, post)

    # back to the frame: the ROI crop's span, the letterbox's content, or a
    # nearest resize (infer_video_roi.py:238-247, robust.py:52-61,
    # infer_two_stage_burr.py:307-308)
    if roi_bounds is not None:
        to_frame = lambda m: _image.uncrop_resize_nearest(m, roi_bounds[0], roi_bounds[1], (H, W))
    elif pp.letterbox:
        to_frame = lambda m: _image.unletterbox_mask(m, (H, W), m.shape[-2:])
    else:
        to_frame = lambda m: _image.resize_nearest(m, (H, W), channel_dim=False)
    cable, tape = to_frame(cable_m), to_frame(tape_m)

    if post.close_ksize:
        se = _morph.ellipse_kernel(post.close_ksize)
        cable, tape = _morph.close_(cable, se), _morph.close_(tape, se)

    if post.enabled and post.mode == "shape":
        roi_w = W if cfg.roi is None else (cfg.roi.scaled((W, H)).x2 - cfg.roi.scaled((W, H)).x1)
        cable = filter_cable_by_shape(cable, post, roi_w)
        tape = constrain_tape_to_ring(tape, cable, post)
        if post.cable_bbox_pad > 0:
            tape = cable_bbox_limit(tape, cable, post.cable_bbox_pad)
        if post.morph_cleanup_ksize:
            se = _morph.ellipse_kernel(post.morph_cleanup_ksize)
            cable = _morph.close_(_morph.open_(cable, se), se)
            tape = _morph.close_(_morph.open_(tape, se), se)

    cable = roi_limit(cable, cfg.roi, (H, W))
    tape = roi_limit(tape, cfg.roi, (H, W))

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

    pred_full = _pred_full(logits, cable, tape, cfg)
    return FrameOutputs(
        class_map=class_map,
        cable_px=cable.sum(dim=(-2, -1), dtype=torch.int32),
        tape_px=tape.sum(dim=(-2, -1), dtype=torch.int32),
        burr_px=burr.sum(dim=(-2, -1), dtype=torch.int32),
        diameters=_diameters(cable_m, tape_m, cable, tape, cfg),
        defects=_defects(pred_full, cable, tape, cfg),
        defect_components=defect_components(pred_full, burr, cfg),
        quality=quality,
    )


def _pred_full(logits: torch.Tensor, cable: torch.Tensor, tape: torch.Tensor,
               cfg: PipelineCfg) -> Optional[torch.Tensor]:
    """The frame-resolution class map with the model's defect classes
    (>= 3), for defect analysis and tracking on a model of more than 3
    classes (unet_tpu/pipeline/stages.py:613-627): per-class thresholds
    (`segment.pred_full_from_thresholds`) or the argmax through
    `segment.class_remap`. None otherwise."""
    seg = cfg.segment
    if seg.num_classes <= 3 or not (cfg.geometry.analyze_defects or cfg.inspect.track_defects):
        return None
    H, W = cable.shape[-2:]
    if seg.pred_full_from_thresholds:
        return defect_map_from_thresholds(logits, cable, tape, cfg, (H, W))
    pred = torch.argmax(logits, dim=1).to(torch.uint8)
    if seg.class_remap:
        pred = torch.as_tensor(np.asarray(seg.class_remap, np.uint8),
                               device=pred.device)[pred.long()]
    return _image.resize_nearest(pred, (H, W), channel_dim=False)


def _diameters(cable_m: torch.Tensor, tape_m: torch.Tensor, cable: torch.Tensor,
               tape: torch.Tensor, cfg: PipelineCfg) -> Optional[_geo.DiameterMetrics]:
    """The geometry stage (unet_tpu/pipeline/stages.py:629-648): diameters
    from the largest cable and tape components of each frame, or None
    without `geometry.enabled`. Where the model's masks reach the frame by a
    nearest upscale alone (no ROI, no postprocess, no letterbox or dynamic
    ROI, and H, W at least the model's h, w), the components are labelled at
    model resolution, which is exact and cheaper; otherwise at frame
    resolution, with a 50-pixel floor."""
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


def _defects(pred_full: Optional[torch.Tensor], cable: torch.Tensor, tape: torch.Tensor,
             cfg: PipelineCfg) -> Optional[_geo.DefectAnalysis]:
    """`geometry.analyze_defects` (unet_tpu/pipeline/stages.py:650-663): the
    analysis of a frame-resolution map of cable (1) and tape (2) from the
    final masks, over which `pred_full` lays its defect classes (>= 3)."""
    g = cfg.geometry
    if not g.analyze_defects:
        return None
    amap = torch.where(tape, 2, torch.where(cable, 1, 0)).to(torch.uint8)
    if pred_full is not None:
        amap = torch.where(pred_full >= 3, pred_full, amap)
    return _geo.analyze_defects(amap, defect_classes=g.defect_classes,
                                hole_min_size=g.hole_min_size,
                                max_components=g.max_components)


def defect_components(pred_full: Optional[torch.Tensor], burr: torch.Tensor,
                      cfg: PipelineCfg) -> Optional[DefectComponents]:
    """`inspect.track_defects` (unet_tpu/pipeline/stages.py:665-681): the
    top-`track_max_components` components of the defect classes of
    `pred_full` (or of the burr mask, class 3, where there is none),
    labelled at frame resolution, each with the class at its root pixel,
    which lies inside the component by construction."""
    if not cfg.inspect.track_defects:
        return None
    if pred_full is not None:
        mask, class_src = pred_full >= 3, pred_full
    else:
        mask, class_src = burr, torch.where(burr, 3, 0).to(torch.uint8)
    B, H, W = mask.shape
    st = _cc.component_stats(_cc.connected_components(mask), cfg.inspect.track_max_components)
    cls = class_src.reshape(B, H * W).gather(1, st.label.clamp(min=0).to(torch.int64))
    return DefectComponents(left=st.left, top=st.top, width=st.width, height=st.height,
                            area=st.area, class_id=torch.where(st.valid, cls, 0).to(torch.uint8),
                            valid=st.valid)


def build_step(model: nn.Module, cfg: PipelineCfg, device: Union[str, torch.device] = "cuda"
               ) -> Callable[[Union[np.ndarray, torch.Tensor]], FrameOutputs]:
    """Returns step(frames_u8_bgr, prev_frame_bgr=None) -> FrameOutputs on
    `device`. The model is moved to `device` and put in eval mode, and the
    weights of the fast or int8 forward are prepared once
    (`segment_forward`); frames (and the previous batch's last frame, (1, H,
    W, 3), for the quality statistics) may be numpy arrays or tensors and
    are moved to `device`. There is no
    fallback: a `cuda` step without a card raises. A float32 forward runs
    with full-fp32 convs whatever the process-wide TF32 flags say, and
    leaves them as it found them (`forward_logits`)."""
    _unsupported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_step(device='cuda') needs a CUDA device")
    forward = segment_forward(model, cfg, device)

    def step(frames_bgr, prev_frame_bgr=None) -> FrameOutputs:
        frames = torch.as_tensor(frames_bgr).to(device)
        prev = None if prev_frame_bgr is None else torch.as_tensor(prev_frame_bgr).to(device)
        return run_pipeline(forward, frames, cfg, prev)

    step.parts = (model, cfg, device)   # for parallel.shard_pipeline_step(spatial=True)
    return step


def _stack(outs):
    """K outputs of one structure stacked field by field to (K, ...); a
    None field stays None."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(*(_stack([o[i] for o in outs]) for i in range(len(first))))


def build_chunked_step(model: nn.Module, cfg: PipelineCfg,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Callable[[Union[np.ndarray, torch.Tensor]], FrameOutputs]:
    """The offline, throughput form of `build_step`
    (unet_tpu/pipeline/stages.py:700-715): step(frames) with frames (K, B,
    H, W, 3) uint8 BGR runs the K batches from one call and returns a
    `FrameOutputs` whose every tensor is stacked to (K, ...), nested tuples
    field by field, None fields None. The forward is prepared once
    (`segment_forward`); the K batches are queued on the card with no host
    sync between them. Each batch's quality statistics diff its first frame
    against itself, as the JAX function's do (no previous frame). A `cuda`
    step without a card raises."""
    _unsupported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_chunked_step(device='cuda') needs a CUDA device")
    forward = segment_forward(model, cfg, device)

    def step(frame_chunks) -> FrameOutputs:
        chunks = torch.as_tensor(frame_chunks).to(device)
        return _stack([run_pipeline(forward, fb, cfg) for fb in chunks])

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
