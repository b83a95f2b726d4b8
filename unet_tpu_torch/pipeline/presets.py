"""Named pipeline presets reproducing the reference CLI zoo (PyTorch port).

A copy of unet_tpu/pipeline/presets.py. All 17 presets exist as config;
unet_tpu_torch.pipeline.stages runs the branches `two_stage` takes and
raises NotImplementedError, naming the ROADMAP item, for the others.

Each preset is a PipelineCfg (+EngineConfig hints) carrying the exact
constants of its reference script — the 22 infer_* scripts collapse to
`cli infer --preset <name>` (SURVEY §1/§7).
"""
from __future__ import annotations

from unet_tpu_torch.pipeline.config import (ROI, BurrCfg, GeometryCfg,
                                            InspectCfg, PipelineCfg,
                                            PostprocessCfg, PreprocessCfg,
                                            SegmentCfg)

# Burr sensitivity presets (reference infer_two_stage_burr.py:194-198; only
# the area bounds reach the detector — band_out/laplacian_threshold are dead
# config in the reference's canny path).
BURR_SENSITIVITY = {
    "low": dict(min_area=50, max_area=800),
    "medium": dict(min_area=30, max_area=800),
    "high": dict(min_area=20, max_area=1000),
}


def two_stage(sensitivity: str = "medium", rotate: bool = False,
              normalize: bool = False) -> PipelineCfg:
    """Flagship detector (reference infer_two_stage_burr.py): NestedUNet
    3-class @512, FIXED_ROI_512 {x 140-270}, Canny(50,150) band burr."""
    s = BURR_SENSITIVITY[sensitivity]
    return PipelineCfg(
        name="two_stage",
        preprocess=PreprocessCfg(rotate90_ccw=rotate,
                                 normalize_wh=(800, 448) if normalize else None),
        segment=SegmentCfg(num_classes=3),
        burr=BurrCfg(method="canny_band", band_px=8, canny_low=50, canny_high=150,
                     close_ksize=3, open_ksize=2, max_aspect=5.0, min_w=3, min_h=3,
                     strict_min_wh=False, **s),
        roi=ROI(140, 0, 270, 512),
    )


def enhanced(enhance: bool = True, denoise: str = "nlm") -> PipelineCfg:
    """Enhanced detector (reference infer_enhanced_burr.py): CLAHE+denoise+
    sharpen preprocessing, multi-scale Canny|Sobel|Laplacian fusion, wide
    25px band, VERTICAL_ROI {x 200-600 in 800x448}, forced rotate+normalize."""
    return PipelineCfg(
        name="enhanced",
        # denoise="nlm": the reference's enhanced path uses
        # fastNlMeansDenoisingColored (infer_enhanced_burr.py:58), and the
        # recorded fidelity measurement (docs/PERF.md §6) shows bilateral is
        # NOT mask-equivalent to that chain (class-map agreement 0.91 vs
        # nlm's 0.989, +65 % spurious burr px) — bilateral remains the
        # config default elsewhere, matching the reference's refactor
        # pipeline default (src/refactor/config.py:51)
        preprocess=PreprocessCfg(rotate90_ccw=True, normalize_wh=(800, 448),
                                 enhance=enhance, denoise=denoise),
        segment=SegmentCfg(num_classes=3),
        burr=BurrCfg(method="multiscale", band_px=25, canny_low=30, canny_high=100,
                     sobel_thresh=50, laplacian_thresh=15, close_ksize=5,
                     open_ksize=3, min_area=50, max_area=500, max_aspect=6.0,
                     min_w=5, min_h=5, strict_min_wh=True),
        roi=ROI(200, 0, 600, 448, space=(800, 448)),
    )


def high_res_roi() -> PipelineCfg:
    """2448x2048 path (reference infer_high_res_custom_roi.py): rotate 90 CCW,
    normalize to 800x448, CUSTOM_ROI {x 250-550}."""
    cfg = two_stage()
    return cfg.replace(
        name="high_res_roi",
        preprocess=PreprocessCfg(rotate90_ccw=True, normalize_wh=(800, 448)),
        roi=ROI(250, 0, 550, 448, space=(800, 448)),
    )


def wrap_uniformity(num_classes: int = 4) -> PipelineCfg:
    """Wrap-uniformity inspection (reference infer_wrap_uniformity.py:33-131):
    4-class model @256, tape/cable diameter ratio per frame, no burr stage."""
    return PipelineCfg(
        name="wrap_uniformity",
        preprocess=PreprocessCfg(model_size=(256, 256)),
        segment=SegmentCfg(num_classes=num_classes),
        burr=BurrCfg(method="none"),
        geometry=GeometryCfg(enabled=True),
    )


def wrap_7class() -> PipelineCfg:
    """7-class uniformity variant (reference infer_wrap_7class.py)."""
    return wrap_uniformity(num_classes=7).replace(name="wrap_7class")


def production() -> PipelineCfg:
    """Production engine wiring geometry + per-frame defect analysis +
    window aggregation (reference infer_video_production.py:110-226 calling
    geometry_enhanced.compute_diameter_metrics + analyze_defects)."""
    cfg = two_stage()
    return cfg.replace(name="production",
                       geometry=GeometryCfg(enabled=True, analyze_defects=True))


def video_full() -> PipelineCfg:
    """Full-featured 7-class pipeline (reference infer_video.py): 256-input
    model, frame quality gate, geometry for thickness rules, per-class-
    priority mask merge (per_class thresholding), window-aggregation mode."""
    return PipelineCfg(
        name="video_full",
        preprocess=PreprocessCfg(model_size=(256, 256)),
        segment=SegmentCfg(num_classes=7, threshold_mode="per_class",
                           class_thresholds=(0.0, 0.35, 0.35, 0.70, 0.70, 0.70, 0.70)),
        burr=BurrCfg(method="none"),
        geometry=GeometryCfg(enabled=True, analyze_defects=True),
        inspect=InspectCfg(quality_stats=True),
    )


def optimized() -> PipelineCfg:
    """Defect-tracking variant (reference infer_video_optimized.py:66-189):
    IoU-matched multi-frame confirmation of defect components."""
    return video_full().replace(
        name="optimized",
        inspect=InspectCfg(quality_stats=True, track_defects=True),
    )


def robust() -> PipelineCfg:
    """Best post-processing stack (reference infer_video_robust.py:70-216):
    exclusive thresholds, shape-scored cable CC, tape ring."""
    return PipelineCfg(
        name="robust",
        preprocess=PreprocessCfg(letterbox=True),
        segment=SegmentCfg(num_classes=3, threshold_mode="exclusive",
                           class_thresholds=(0.0, 0.5, 0.5),
                           bg_margin=0.05, ct_margin=0.05),
        burr=BurrCfg(method="none"),
        postprocess=PostprocessCfg(enabled=True, cable_bbox_pad=80,
                                   morph_cleanup_ksize=3),
        geometry=GeometryCfg(enabled=True),
    )


def simple_7class() -> PipelineCfg:
    """SimpleUNet 7-class @256 with per-class probability thresholds
    (reference infer_video_simple.py:82-154)."""
    return PipelineCfg(
        name="simple_7class",
        preprocess=PreprocessCfg(model_size=(256, 256)),
        segment=SegmentCfg(num_classes=7, threshold_mode="per_class",
                           class_thresholds=(0.0, 0.35, 0.35, 0.70, 0.70, 0.70, 0.70)),
        burr=BurrCfg(method="none"),
        geometry=GeometryCfg(enabled=True),
    )


def three_class_full() -> PipelineCfg:
    """Full-frame 3-class segmentation, no ROI, no burr stage
    (reference infer_video_3class_full.py)."""
    return PipelineCfg(
        name="three_class_full",
        segment=SegmentCfg(num_classes=3),
        burr=BurrCfg(method="none"),
        geometry=GeometryCfg(enabled=True),
    )


def strict() -> PipelineCfg:
    """High-threshold low-false-positive variant
    (reference infer_video_strict.py family): per-class thresholds raised."""
    return PipelineCfg(
        name="strict",
        preprocess=PreprocessCfg(model_size=(256, 256)),
        segment=SegmentCfg(num_classes=7, threshold_mode="per_class",
                           class_thresholds=(0.0, 0.5, 0.5, 0.8, 0.8, 0.8, 0.8)),
        burr=BurrCfg(method="none"),
        geometry=GeometryCfg(enabled=True),
    )


def three_class_best() -> PipelineCfg:
    """3-class finetuned checkpoint path (reference infer_video_3class_best.py,
    checkpoints_3class_finetuned mIoU 70.96%): full-frame argmax @512 with
    real-time diameter measurement, thickness-uniformity analysis and event
    recording (windows)."""
    return three_class_full().replace(name="three_class_best")


def v3_high_quality() -> PipelineCfg:
    """High-quality 6-class variant (reference infer_video_v3_high_quality.py):
    the checkpoints_v3 model's output channels map to class ids (0,1,2,4,5,6)
    (its :33-36 channel table); per-class thresholds 0.60 with x1.2 cable/tape
    mutual exclusion, defect thresholds 0.70 with open3/close5 morphology,
    'simple 3x3 close' on cable/tape, diameter measurement."""
    return PipelineCfg(
        name="v3_high_quality",
        preprocess=PreprocessCfg(model_size=(256, 256)),
        segment=SegmentCfg(num_classes=6, threshold_mode="per_class",
                           class_thresholds=(0.0, 0.60, 0.60, 0.70, 0.70, 0.70),
                           ct_ratio=1.2, class_remap=(0, 1, 2, 4, 5, 6),
                           pred_full_from_thresholds=True),
        burr=BurrCfg(method="none"),
        postprocess=PostprocessCfg(close_ksize=3),
        geometry=GeometryCfg(enabled=True, analyze_defects=True,
                             defect_classes=(4, 5, 6)),
    )


def spatial() -> PipelineCfg:
    """Spatial-filter variant for severe domain shift
    (reference infer_video_spatial.py): relative-to-background thresholds
    (cable 2.0x, tape 2.5x bg), vertical-strip component gates at model res
    (cable width 30-200, tape 20-150, area>1000, height>=30%), central-half
    vertical focus band."""
    return PipelineCfg(
        name="spatial",
        segment=SegmentCfg(num_classes=3, threshold_mode="relative",
                           bg_ratio_cable=2.0, bg_ratio_tape=2.5),
        burr=BurrCfg(method="none"),
        postprocess=PostprocessCfg(enabled=True, mode="spatial"),
        geometry=GeometryCfg(enabled=True),
        roi=ROI(128, 0, 384, 512),  # central 50% focus (spatial.py:55-68)
    )


def roi_first() -> PipelineCfg:
    """ROI-first variant (reference infer_video_roi.py): per-frame vertical-
    edge-projection ROI detection, model runs on the dynamic horizontal crop,
    ultra-strict adaptive thresholds, aspect/position CC refinement (the
    dynamic box becomes gather coords)."""
    return PipelineCfg(
        name="roi_first",
        preprocess=PreprocessCfg(dynamic_roi=True),
        segment=SegmentCfg(num_classes=3, threshold_mode="ultra_strict"),
        burr=BurrCfg(method="none"),
        postprocess=PostprocessCfg(enabled=True, mode="refine"),
        geometry=GeometryCfg(enabled=True),
    )


def debug() -> PipelineCfg:
    """No-filter diagnostic preset (reference infer_video_debug.py:1-5):
    plain argmax, no ROI, no postprocess, no burr — 'is the model itself
    working'."""
    return PipelineCfg(
        name="debug",
        preprocess=PreprocessCfg(model_size=(256, 256)),
        segment=SegmentCfg(num_classes=7),
        burr=BurrCfg(method="none"),
    )


PRESETS = {
    "two_stage": two_stage,
    "enhanced": enhanced,
    "high_res_roi": high_res_roi,
    "wrap_uniformity": wrap_uniformity,
    "wrap_7class": wrap_7class,
    "production": production,
    "video_full": video_full,
    "optimized": optimized,
    "robust": robust,
    "simple_7class": simple_7class,
    "three_class_full": three_class_full,
    "three_class_best": three_class_best,
    "v3_high_quality": v3_high_quality,
    "spatial": spatial,
    "roi_first": roi_first,
    "strict": strict,
    "debug": debug,
}

# EngineConfig overrides each preset implies — which host-side consumers its
# reference script runs. Wrap presets use the px-ratio monitor, NOT the
# mm-threshold window rules (the reference wrap scripts never call
# make_decision); production runs windows + evidence dirs.
ENGINE_HINTS = {
    "two_stage": {},
    "enhanced": {},
    "high_res_roi": {},
    "wrap_uniformity": dict(wrap_monitor_enabled=True, window_enabled=False),
    "wrap_7class": dict(wrap_monitor_enabled=True, window_enabled=False),
    "production": dict(window_enabled=True, evidence_dirs=True),
    "video_full": dict(window_enabled=True, quality_enabled=True,
                       event_detector_enabled=True),
    "optimized": dict(window_enabled=True, quality_enabled=True,
                      tracker_enabled=True),
    # robust: windows + the N-consecutive-confirm/cooldown EventGate
    # (reference infer_video_robust.py:219-239)
    "robust": dict(window_enabled=True, event_gate_enabled=True),
    "simple_7class": dict(window_enabled=True),
    "three_class_full": dict(window_enabled=True),
    # 3class_best runs thickness-uniformity + event recording (its script's
    # docstring feature list) -> windows
    "three_class_best": dict(window_enabled=True),
    "v3_high_quality": dict(window_enabled=True),
    # spatial/roi_first are diagnostic domain-shift presets: overlays +
    # per-frame stats only, no window aggregation in their scripts
    "spatial": dict(window_enabled=False),
    "roi_first": dict(window_enabled=False),
    "strict": dict(window_enabled=True),
    "debug": dict(window_enabled=False),
}


def get_preset(name: str, **kwargs) -> PipelineCfg:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](**kwargs)


def engine_hints(name: str) -> dict:
    """EngineConfig field overrides implied by the preset's reference script."""
    return dict(ENGINE_HINTS.get(name, {}))
