"""YAML-config inspection serve, the reference's production entry point
(counterpart of unet_tpu/serve/inspect_tool.py; reference
tools/inspect_tool.py:56-466): config -> model + window aggregator + event
logger -> per-window OK/NG JSONL events over a video or image directory.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch


@dataclass
class InspectionConfig:
    """Typed view of the inspection YAML (reference inspect_tool.py:56-110)."""
    model_path: str = ""
    arch: str = "nested_unet"
    num_classes: int = 3
    input_size: int = 512
    preset: str = "production"
    batch: int = 8
    frame_stride: int = 1
    mm_per_px: float = 0.05
    camera_id: str = "cam0"
    window_duration_sec: float = 3.0
    window_min_frames: int = 6
    window_max_frames: int = 12
    thresholds: Dict[str, Any] = field(default_factory=dict)
    roi: Optional[Dict[str, int]] = None
    output_dir: str = "./inspection_output"

    @classmethod
    def from_yaml(cls, path: str) -> "InspectionConfig":
        import yaml
        raw = yaml.safe_load(Path(path).read_text()) or {}
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in raw.items() if k in known})


class InspectionSystem:
    """Model + pipeline + aggregator wiring (reference inspect_tool.py:113-153),
    on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: InspectionConfig, device: Union[str, torch.device] = "cuda"):
        from unet_tpu_torch.cli.main import load_model
        from unet_tpu_torch.inspect import ThresholdConfig
        from unet_tpu_torch.pipeline import (EngineConfig, GeometryCfg, InferenceEngine,
                                             PreprocessCfg, ROI, get_preset)

        self.config = config
        cfg = get_preset(config.preset)
        cfg = cfg.replace(
            preprocess=PreprocessCfg(model_size=(config.input_size, config.input_size)),
            geometry=GeometryCfg(enabled=True, mm_per_px=config.mm_per_px))
        if config.roi:
            r = config.roi
            cfg = cfg.replace(roi=ROI(r["x1"], r["y1"], r["x2"], r["y2"],
                                      space=tuple(r.get("space", (512, 512)))))
        model, num_classes, _ = load_model(config.model_path or None, config.arch,
                                           "bfloat16", config.num_classes)
        cfg = cfg.replace_in("segment", num_classes=num_classes)

        thr = ThresholdConfig(**config.thresholds) if config.thresholds else ThresholdConfig()
        self.engine = InferenceEngine(model, cfg, EngineConfig(
            batch=config.batch, frame_stride=config.frame_stride,
            output_dir=config.output_dir, window_enabled=True,
            window_duration_sec=config.window_duration_sec,
            window_min_frames=config.window_min_frames,
            window_max_frames=config.window_max_frames,
            thresholds=thr, camera_id=config.camera_id), device=device)

    def process_video(self, video_path: str, max_frames: Optional[int] = None):
        return self.engine.process_video(video_path, max_frames=max_frames)

    process_images = process_video  # ImageDirReader handles directories


def run_inspection(config_path: str, video_path: str, output_dir: Optional[str] = None,
                   device: Union[str, torch.device] = "cuda") -> int:
    config = InspectionConfig.from_yaml(config_path)
    if output_dir:
        config.output_dir = output_dir
    system = InspectionSystem(config, device=device)
    summary = system.process_video(video_path)
    print(f"inspection complete: {summary}")
    return 0
