"""Inference pipeline of the port: config tree, presets, the fused step,
overlays, the inference engine and sliding-window patch inference."""
from unet_tpu_torch.pipeline.config import (  # noqa: F401
    ROI, BurrCfg, GeometryCfg, InspectCfg, PipelineCfg, PostprocessCfg,
    PreprocessCfg, SegmentCfg)
from unet_tpu_torch.pipeline import stages, visualize  # noqa: F401
from unet_tpu_torch.pipeline.presets import (  # noqa: F401
    PRESETS, engine_hints, get_preset)
from unet_tpu_torch.pipeline.engine import EngineConfig, InferenceEngine  # noqa: F401
from unet_tpu_torch.pipeline.sliding_window import (  # noqa: F401
    SlidingWindowInference, apply_hysteresis, filter_by_cc_and_prob, scan_thresholds)
