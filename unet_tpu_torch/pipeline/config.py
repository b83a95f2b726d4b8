"""Unified typed config tree for the inference pipeline (PyTorch port).

A copy of unet_tpu/pipeline/config.py: the port keeps its own so that it
never imports the JAX package. tests/test_torch_config.py holds the two
trees equal preset by preset.

Replaces the reference's three overlapping config systems (SURVEY §5):
argparse-per-CLI, `AppCfg` yaml (reference src/utils/config.py:12-107), and
`RefactorConfig` (reference src/refactor/config.py:11-157) — plus the
hard-coded ROI constants (FIXED_ROI_512 infer_two_stage_burr.py:29-34,
VERTICAL_ROI infer_enhanced_burr.py:23-28, CUSTOM_ROI
infer_high_res_custom_roi.py:25-30), which become named presets here
(pipeline.presets).

Everything is a frozen dataclass, so a config is hashable and immutable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ROI:
    """ROI in model-input (512-space) or frame coordinates; scaled like
    map_roi_to_original (reference infer_two_stage_burr.py:37-47)."""
    x1: int
    y1: int
    x2: int
    y2: int
    space: Tuple[int, int] = (512, 512)  # (w, h) the coords are expressed in

    def scaled(self, frame_wh: Tuple[int, int]) -> "ROI":
        sx = frame_wh[0] / self.space[0]
        sy = frame_wh[1] / self.space[1]
        return ROI(int(self.x1 * sx), int(self.y1 * sy),
                   int(self.x2 * sx), int(self.y2 * sy), space=frame_wh)


@dataclass(frozen=True)
class PreprocessCfg:
    """Device-side frame conditioning (reference infer_two_stage_burr.py:275-280,
    infer_enhanced_burr.py:38-66, src/refactor/preprocess.py:35-74)."""
    rotate90_ccw: bool = False
    normalize_wh: Optional[Tuple[int, int]] = None   # e.g. (800, 448)
    enhance: bool = False                             # CLAHE(L)+denoise+sharpen
    clahe_clip: float = 3.0
    clahe_grid: Tuple[int, int] = (8, 8)
    denoise: str = "bilateral"                        # "nlm" | "bilateral" | "none"
    model_size: Tuple[int, int] = (512, 512)          # (w, h) fed to the model
    normalization: str = "unit"                       # "unit" (/255) | "imagenet"
    letterbox: bool = False   # aspect-preserving pad instead of stretch
                              # (reference infer_video_robust.py:40-61)
    # ROI-first inference (reference infer_video_roi.py:23-57): per-frame
    # vertical-edge-projection ROI detection, model runs on the dynamic
    # horizontal crop, masks paste back — all on device with static shapes
    # (dynamic box -> gather-based crop-resize, no recompiles)
    dynamic_roi: bool = False
    dynamic_roi_margin: float = 0.1    # bound expansion as a span fraction
    dynamic_roi_thresh: float = 0.3    # column active at > thresh * max
    dynamic_roi_smooth: int = 30       # projection box-smoothing width


@dataclass(frozen=True)
class SegmentCfg:
    """Stage-1 model + mask extraction."""
    num_classes: int = 3
    cable_cls: int = 1
    tape_cls: int = 2
    # phase-packed MXU forward (models/fast_forward.py); custom-encoder
    # NestedUNet only — equal outputs up to float reassociation
    fast_forward: bool = False
    # int8 quantized forward (models/quantized.py): calibrated (tap, scale)
    # pairs from pipeline.stages.calibrate_int8; empty = stay bf16/f32
    int8_scales: Tuple[Tuple[str, float], ...] = ()
    # "argmax" | "per_class" | "exclusive" | "relative" | "ultra_strict"
    threshold_mode: str = "argmax"
    # per-class probability thresholds (infer_video_simple.py:82-154)
    class_thresholds: Tuple[float, ...] = ()
    # exclusive-threshold params (infer_video_robust.py:70-99)
    bg_margin: float = 0.05
    ct_margin: float = 0.05
    # relative-to-background thresholds (infer_video_spatial.py:71-98:
    # p_cable > p_bg*ratio; overlap -> higher prob wins)
    bg_ratio_cable: float = 2.0
    bg_ratio_tape: float = 2.5
    # per_class mutual-exclusion ratio (infer_video_v3_high_quality.py:
    # cable only when p_cable > p_tape*ct_ratio and vice versa); 0 = off
    ct_ratio: float = 0.0
    # model output channel -> class id map for the full defect map, e.g. the
    # 6-class v3 model's channels map to ids (0,1,2,4,5,6)
    # (infer_video_v3_high_quality.py:33-36); () = identity
    class_remap: Tuple[int, ...] = ()
    # build the full defect map from per-channel probability thresholds +
    # priority merge instead of argmax (infer_video_v3_high_quality.py:
    # defect_thresh=0.70, open3/close5 per defect mask)
    pred_full_from_thresholds: bool = False
    defect_threshold: float = 0.70
    defect_open_ksize: int = 3
    defect_close_ksize: int = 5


@dataclass(frozen=True)
class BurrCfg:
    """Stage-2 burr detection. `method` selects the reference variant:
      canny_band   — infer_two_stage_burr.py:50-119 (band 8, Canny 50/150)
      multiscale   — infer_enhanced_burr.py:69-138 (Canny|Sobel|Laplacian)
      laplacian    — src/refactor/burr_detector.py:11-66
      dog          — src/refactor/burr_detector.py:69-118
    """
    method: str = "canny_band"
    band_px: int = 8                   # dilate SE size (canny_band) / band_out*2+1 (laplacian)
    canny_low: float = 50.0
    canny_high: float = 150.0
    blur_ksize: int = 5
    blur_sigma: float = 1.0
    sobel_thresh: float = 50.0         # multiscale
    laplacian_thresh: float = 15.0     # multiscale / laplacian / dog
    close_ksize: int = 3
    open_ksize: int = 2
    min_area: int = 30
    max_area: int = 800
    max_aspect: float = 5.0
    min_w: int = 3
    min_h: int = 3
    strict_min_wh: bool = False        # multiscale uses >= (w,h >= 5); canny uses >
    max_components: int = 64


@dataclass(frozen=True)
class PostprocessCfg:
    """Shape-constraint mask cleanup (reference src/refactor/postprocess.py,
    infer_video_robust.py:102-216)."""
    enabled: bool = False
    # "shape" (robust: scored cable CC + tape ring) | "spatial" (vertical
    # strip gates at model res, infer_video_spatial.py:24-53) | "refine"
    # (aspect/position gates at model res, infer_video_roi.py:128-167)
    mode: str = "shape"
    cable_min_area: int = 500
    cable_min_aspect: float = 2.0
    cable_max_center_offset: float = 0.35
    tape_ring_dilate: int = 25
    tape_ring_erode: int = 5
    morph_cleanup_ksize: int = 0
    cable_bbox_pad: int = 0   # >0: zero tape outside cable bbox + pad
                              # (reference infer_video_robust.py:201-216)
    # >0: elliptical close on cable/tape after resize-to-frame (the v3
    # preset's "simple 3x3 close", infer_video_v3_high_quality.py)
    close_ksize: int = 0
    # spatial mode (widths in model-res pixels)
    spatial_min_area: int = 1000
    spatial_cable_w: Tuple[int, int] = (30, 200)
    spatial_tape_w: Tuple[int, int] = (20, 150)
    spatial_min_height_ratio: float = 0.3
    # refine mode
    refine_min_area: int = 2000
    refine_aspect: float = 2.0
    refine_wide_w: int = 100
    refine_edge_frac: float = 0.1
    refine_edge_area: int = 10000
    # component budget for the spatial/refine gates: stats cover the top-K
    # by area and anything beyond K is DROPPED, so K must exceed any
    # plausible fragment count whose members pass the area gates — at 64,
    # truncation needs >64 components each >= spatial_min_area (the
    # reference's cv2 loop gates every component, infer_video_spatial.py:24)
    max_components: int = 64


@dataclass(frozen=True)
class GeometryCfg:
    """Diameter/uniformity measurement (reference geometry_enhanced.py:113-185)."""
    enabled: bool = False
    mm_per_px: float = 0.05
    min_valid_rows: int = 20
    smooth_ksize: int = 31
    # per-frame defect analysis feeding the window decision rules
    # (reference geometry_enhanced.py:246-330, infer_video_production.py:169-226)
    analyze_defects: bool = False
    hole_min_size: int = 10
    defect_classes: Tuple[int, ...] = (3, 4, 5, 6)
    max_components: int = 32


@dataclass(frozen=True)
class InspectCfg:
    """Device-side inputs for the host inspection gates/trackers."""
    # per-frame Laplacian-variance / gray-std / frame-diff MAD for the
    # FrameQualityGate (reference infer_video.py:73-118)
    quality_stats: bool = False
    # per-component defect stats (bbox/area/class) for the DefectTracker
    # (reference infer_video_optimized.py:66-189)
    track_defects: bool = False
    track_max_components: int = 16


@dataclass(frozen=True)
class PipelineCfg:
    """Full per-preset pipeline description; fixed for the life of a step."""
    name: str = "two_stage"
    preprocess: PreprocessCfg = field(default_factory=PreprocessCfg)
    segment: SegmentCfg = field(default_factory=SegmentCfg)
    burr: BurrCfg = field(default_factory=BurrCfg)
    postprocess: PostprocessCfg = field(default_factory=PostprocessCfg)
    geometry: GeometryCfg = field(default_factory=GeometryCfg)
    inspect: InspectCfg = field(default_factory=InspectCfg)
    roi: Optional[ROI] = None
    batch: int = 1

    def replace(self, **kw) -> "PipelineCfg":
        return dataclasses.replace(self, **kw)

    def replace_in(self, section: str, **kw) -> "PipelineCfg":
        """Replace fields of one sub-config:
        cfg.replace_in('segment', fast_forward=True)."""
        return dataclasses.replace(self, **{
            section: dataclasses.replace(getattr(self, section), **kw)})
