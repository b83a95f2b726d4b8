"""Pipeline configs as YAML, and the reference's legacy layouts (counterpart
of unet_tpu/core/config.py:42-149).

The reference ships three overlapping config systems: per-CLI argparse,
`AppCfg` YAML (src/utils/config.py:12-107) and `RefactorConfig`
(src/refactor/config.py:11-157). Here the port's `pipeline.config.PipelineCfg`
is the one typed tree: this module round-trips it through YAML and migrates
the two legacy layouts, so a station's existing files run unedited
(`cli infer --config`). The JAX package's compile-cache helpers
(`jax_cache_dir`, `enable_compilation_cache`) have no counterpart: the
port's kernels are built into `_build.py`'s directory. `yaml` is imported
at first use.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

from unet_tpu_torch.pipeline.config import (ROI, BurrCfg, GeometryCfg, PipelineCfg,
                                            PostprocessCfg, PreprocessCfg, SegmentCfg)

# the sections a YAML file sets; `inspect` is written but not read back, as
# in the JAX package
_SECTIONS = {"preprocess": PreprocessCfg, "segment": SegmentCfg,
             "burr": BurrCfg, "postprocess": PostprocessCfg,
             "geometry": GeometryCfg}


def _dc_to_dict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _dc_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def pipeline_cfg_to_dict(cfg: PipelineCfg) -> Dict[str, Any]:
    """The config as plain dicts, lists and scalars."""
    return _dc_to_dict(cfg)


def pipeline_cfg_from_dict(data: Dict[str, Any]) -> PipelineCfg:
    """The inverse of `pipeline_cfg_to_dict` for the sections of _SECTIONS,
    `roi`, `name` and `batch`; a section left out keeps its defaults."""
    kw: Dict[str, Any] = {}
    for key, cls in _SECTIONS.items():
        if key in data and data[key] is not None:
            section = dict(data[key])
            for f in dataclasses.fields(cls):
                if f.name in section and isinstance(section[f.name], list):
                    section[f.name] = tuple(section[f.name])
            kw[key] = cls(**section)
    if data.get("roi"):
        r = dict(data["roi"])
        if isinstance(r.get("space"), list):
            r["space"] = tuple(r["space"])
        kw["roi"] = ROI(**r)
    for scalar in ("name", "batch"):
        if scalar in data:
            kw[scalar] = data[scalar]
    return PipelineCfg(**kw)


def read_yaml(path: str) -> Dict[str, Any]:
    """A YAML file as a dict ({} for an empty file)."""
    import yaml
    return yaml.safe_load(Path(path).read_text()) or {}


def save_pipeline_yaml(cfg: PipelineCfg, path: str) -> None:
    import yaml
    Path(path).write_text(yaml.safe_dump(pipeline_cfg_to_dict(cfg), default_flow_style=False))


def load_pipeline_yaml(path: str) -> PipelineCfg:
    """Load a PipelineCfg YAML, or migrate a legacy AppCfg layout (`camera`
    and `model` sections) or RefactorConfig layout (`event`, `burr` and an
    `roi` with `x`) when its sections are recognized."""
    data = read_yaml(path)
    if "camera" in data and "model" in data:
        return migrate_app_cfg(data)
    if "event" in data and "burr" in data and "roi" in data \
            and "x" in (data.get("roi") or {}):
        return migrate_refactor_cfg(data)
    return pipeline_cfg_from_dict(data)


def migrate_app_cfg(data: Dict[str, Any]) -> PipelineCfg:
    """Legacy AppCfg YAML (reference src/utils/config.py:82-107) ->
    PipelineCfg. The camera, mqtt and event sections belong to the serving
    and engine configs; this maps the model, roi and scale parts."""
    model = data.get("model", {})
    size = model.get("input_size", [512, 512])
    cfg = PipelineCfg(
        name="app_cfg",
        preprocess=PreprocessCfg(model_size=(int(size[0]), int(size[1]))),
        segment=SegmentCfg(num_classes=int(model.get("num_classes", 3))),
        geometry=GeometryCfg(
            enabled=True,
            mm_per_px=float(data.get("scale", {}).get("mm_per_px") or 0.05)),
    )
    roi = data.get("camera", {}).get("roi") or {}
    if roi.get("enabled"):
        x, y, w, h = roi["x"], roi["y"], roi["w"], roi["h"]
        cam_w = data["camera"].get("width", x + w)
        cam_h = data["camera"].get("height", y + h)
        cfg = cfg.replace(roi=ROI(x, y, x + w, y + h, space=(cam_w, cam_h)))
    return cfg


def migrate_refactor_cfg(data: Dict[str, Any]) -> PipelineCfg:
    """Legacy RefactorConfig YAML (reference src/refactor/config.py:110-157)
    -> PipelineCfg: the laplacian burr method, the shape postprocess, and
    geometry on."""
    burr = data.get("burr", {})
    post = data.get("postprocess", {})
    roi = data.get("roi", {})
    cfg = PipelineCfg(
        name="refactor_cfg",
        burr=BurrCfg(method="laplacian",
                     band_px=int(burr.get("band_out", 10)),
                     laplacian_thresh=float(burr.get("laplacian_threshold", 30)),
                     min_area=int(burr.get("min_area", 20)),
                     max_area=int(burr.get("max_area", 500))),
        postprocess=PostprocessCfg(
            enabled=True,
            cable_min_area=int(post.get("cable_min_area", 1000)),
            cable_min_aspect=float(post.get("cable_min_aspect", 1.6)),
            cable_max_center_offset=float(post.get("cable_max_center_offset", 0.3)),
            tape_ring_dilate=int(post.get("tape_ring_dilate", 15)),
            tape_ring_erode=int(post.get("tape_ring_erode", 5))),
        geometry=GeometryCfg(enabled=True),
    )
    if roi and "x" in roi:
        x, y, w, h = roi["x"], roi["y"], roi.get("w", 640), roi.get("h", 480)
        cfg = cfg.replace(roi=ROI(x, y, x + w, y + h, space=(x + w, y + h)))
    return cfg
