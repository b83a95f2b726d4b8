"""Inference pipeline of the port: config tree, presets and the fused step."""
from unet_tpu_torch.pipeline.config import (  # noqa: F401
    ROI, BurrCfg, GeometryCfg, InspectCfg, PipelineCfg, PostprocessCfg,
    PreprocessCfg, SegmentCfg)
from unet_tpu_torch.pipeline.presets import PRESETS, get_preset  # noqa: F401
