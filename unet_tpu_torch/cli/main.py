"""Command-line interface of the port (counterpart of unet_tpu/cli/main.py).

  infer     video or image-dir inference with a preset (pipeline.presets)
            or a pipeline YAML, legacy AppCfg and RefactorConfig layouts
            included (--config, core.config)
  serve     N videos/cameras through one batched step (serve.service)
  inspect   YAML-configured window inspection (serve.inspect_tool)
  train     the training recipes (train.recipes; tools/train*.py family)
  evaluate  dataset mIoU, confusion CSV and metrics JSON (tools.evaluate)
  tools     the dataset, calibration and annotation tools (tools/), 15 of
            them; annotate, calibrate-roi and calibrate-scale also as
            mouse-driven windows (--interactive, tools.interactive)
  export    a torch.export program (.pt2) of the model forward, or of the
            whole fused step with --pipeline (export.aot); the hand-written
            kernels are custom ops of the program

Every model of the JAX package runs (--arch): nested_unet,
nested_unet_resnet50, simple_unet and lightweight[:encoder] with the
custom, resnet18, resnet34, mobilenet_v3_small (the default),
mobilenet_v3_large or shufflenet_v2_x1_0 encoder; a reference .pth of the
first three families loads with its family read from its keys, and a
checkpoint of `train` (`best.pth`, `last.pth`) with its family read from
its sidecar.

`bench` is not ported yet (ROADMAP A5): it names its item and exits
non-zero. `train` runs over every rank that `torchrun --nproc-per-node N`
starts (parallel.mesh's data axis); the spatial train step is ROADMAP A15d. An
orbax checkpoint directory of the JAX package is read after
`convert_orbax.py` has turned it into a .pth.

Every command runs on the card (`--device cuda`, the default) unless asked
for the CPU. Run `python -m unet_tpu_torch.cli <cmd> --help`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Optional

import torch
import torch.nn as nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NOT_PORTED = {"bench": "ROADMAP A5 (the port bench)"}
N_CALIB = 16
ARCHS = ("nested_unet", "nested_unet_resnet50", "simple_unet",
         "lightweight[:custom|resnet18|resnet34|mobilenet_v3_small|mobilenet_v3_large|"
         "shufflenet_v2_x1_0]")
_ARCH_HELP = (f"model: {', '.join(ARCHS)}; lightweight alone is "
              f"lightweight:mobilenet_v3_small. A --model .pth sets its own family")


def _build_model(num_classes: int, arch: str, dtype_str: str,
                 deep_supervision: bool = True) -> nn.Module:
    """The model of `arch` (unet_tpu/cli/main.py:44-60) with compute type
    `dtype_str`: float32 parameters, the forward in float32 or bfloat16.
    `deep_supervision` gives the NestedUNets their heads (the lightweight
    model has none, as in the JAX package; SimpleUNet has none)."""
    from unet_tpu_torch.models import LightweightNestedUNet, NestedUNet, SimpleUNet

    dtype = _DTYPES[dtype_str]
    if arch in ("nested_unet", "nested_unet_resnet50"):
        return NestedUNet(num_classes=num_classes, deep_supervision=deep_supervision,
                          pretrained_encoder=arch == "nested_unet_resnet50", dtype=dtype)
    if arch == "simple_unet":
        return SimpleUNet(num_classes=num_classes, dtype=dtype)
    if arch == "lightweight" or arch.startswith("lightweight:"):
        enc = arch.split(":", 1)[1] if ":" in arch else "mobilenet_v3_small"
        try:
            return LightweightNestedUNet(num_classes=num_classes, encoder=enc, dtype=dtype)
        except ValueError as e:
            raise SystemExit(f"arch {arch!r}: {e}")
    raise SystemExit(f"unknown arch {arch!r}; one of {', '.join(ARCHS)}")


def _seed_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """PyTorch's default initialisation of every conv, drawn from a
    torch.Generator seeded with `seed` (BatchNorm keeps its defaults)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    nn.init.uniform_(m.bias, -bound, bound, generator=g)
    return model


def load_model(model_path: Optional[str], arch: str, dtype_str: str, fallback_classes: int):
    """(model in eval mode, num_classes, arch) from a reference .pth (its
    family -- nested_unet, nested_unet_resnet50 or simple_unet -- and class
    count read from its keys) or a checkpoint of `train` (its family from
    the `.meta.json` sidecar beside it, every family), loaded strictly,
    whatever `arch` says; or, without a path, the model of `arch` with
    seeded random weights (smoke mode)."""
    from unet_tpu_torch.core.checkpoint import read_meta
    from unet_tpu_torch.models import LightweightNestedUNet, convert

    if model_path:
        if Path(model_path).is_dir():
            raise SystemExit(f"--model {model_path}: an orbax checkpoint directory of the JAX "
                             f"package; convert it with convert_orbax.py (python "
                             f"convert_orbax.py {model_path} OUT.pth, where the JAX package "
                             f"runs) and pass the .pth")
        sd = convert.load_pth(model_path)
        kind = read_meta(model_path).get("config", {}).get("arch") or \
            convert.detect_model_kind(sd)
        num_classes = convert.infer_num_classes(sd)
        heads = "ds1_3.weight" in sd
        if kind.startswith("lightweight") and heads:   # trained with its heads
            model = LightweightNestedUNet(num_classes, kind.split(":", 1)[1],
                                          deep_supervision=True, dtype=_DTYPES[dtype_str])
        else:
            model = _build_model(num_classes, kind, dtype_str, deep_supervision=heads)
        model.load_state_dict(sd, strict=True)
        return model.eval(), num_classes, kind
    print("warning: no --model given; using random weights (smoke mode)")
    model = _seed_weights(_build_model(fallback_classes, arch, dtype_str))
    return model.eval(), fallback_classes, arch


def int8_cfg(model: nn.Module, cfg, video: str, device: str):
    """The int8 config of `cfg`, calibrated on frames strided across the
    whole video or directory (an unrepresentative intro would give tiny
    scales and saturate later activations), or `cfg` itself when the int8
    step agrees with it on less than 0.995 of the pixels of held-out frames.
    Even-strided frames calibrate, odd-strided ones feed the agreement gate,
    so that on a short source the gate never scores the frames it
    calibrated on."""
    from unet_tpu_torch.io.video import ImageDirReader, VideoReader
    from unet_tpu_torch.pipeline import stages

    if Path(video).is_dir():
        src = ImageDirReader(video)
        stride = max(1, len(src.paths) // N_CALIB)
        src.paths = src.paths[::stride][:N_CALIB]
    else:
        probe = VideoReader(video)
        total = probe.meta.total_frames
        probe.cap.release()
        stride = max(1, total // N_CALIB)
        src = VideoReader(video, stride, N_CALIB)
    try:
        batch = next(iter(src.batches(N_CALIB)), None)
    finally:
        cap = getattr(src, "cap", None)
        if cap is not None:
            cap.release()
    if batch is None:
        raise SystemExit(f"--int8: no frames decodable from {video}")
    _, frames, n_valid = batch
    valid = frames[:max(n_valid, 1)]
    calib = valid[0::2] if len(valid) >= 2 else valid
    holdout = valid[1::2][:8] if len(valid) >= 2 else valid
    qcfg = stages.calibrate_int8(model, cfg, [calib], device=device)
    print(f"int8: calibrated on {len(calib)} frames "
          f"(stride {stride} across the video, "
          f"{len(holdout)} held out for the agreement gate)")
    agree = stages.validate_int8(model, cfg, qcfg, holdout, device=device)
    if agree < 0.995:
        print(f"int8: class-map agreement {agree:.4f} < 0.995 on this "
              f"video; falling back to the bf16 forward")
        return cfg
    print(f"int8: class-map agreement {agree:.4f} (gate 0.995)")
    return qcfg


def config_hints(path: str, cfg) -> dict:
    """The engine's settings for a `--config` file (unet_tpu/cli/main.py:
    156-175): a YAML saved from a named preset keeps that preset's engine
    behaviour (its name round-trips through the file); a legacy
    RefactorConfig file runs the event detector with the file's `event`
    section."""
    from unet_tpu_torch.core.config import read_yaml
    from unet_tpu_torch.inspect import EventConfig
    from unet_tpu_torch.pipeline import engine_hints

    if cfg.name != "refactor_cfg":
        return engine_hints(cfg.name)
    ev = read_yaml(path).get("event") or {}
    allowed = {f.name for f in dataclasses.fields(EventConfig)}
    return dict(event_detector_enabled=True,
                event_cfg=EventConfig(**{k: v for k, v in ev.items() if k in allowed}))


def infer_engine(args):
    """The InferenceEngine that `infer` runs with `args`."""
    from unet_tpu_torch.inspect import ThresholdConfig
    from unet_tpu_torch.pipeline import EngineConfig, InferenceEngine, engine_hints, get_preset

    if args.config:
        from unet_tpu_torch.core.config import load_pipeline_yaml
        cfg = load_pipeline_yaml(args.config)
        hints = config_hints(args.config, cfg)
    else:
        hints = engine_hints(args.preset)
        preset_kwargs = {}
        if args.preset == "two_stage":
            preset_kwargs = dict(sensitivity=args.burr_sensitivity, rotate=args.rotate,
                                 normalize=args.normalize_resolution)
        cfg = get_preset(args.preset, **preset_kwargs)
    if args.model_size:
        cfg = cfg.replace_in("preprocess", model_size=(args.model_size, args.model_size))

    model, num_classes, arch = load_model(args.model, args.arch, args.dtype,
                                          cfg.segment.num_classes)
    if num_classes != cfg.segment.num_classes:
        print(f"note: checkpoint has {num_classes} classes; "
              f"overriding preset's {cfg.segment.num_classes}")
        cfg = cfg.replace_in("segment", num_classes=num_classes)

    # the BN-folded forward: on for the custom-encoder NestedUNet unless
    # the user turns it off
    use_fast = {"auto": arch == "nested_unet", "on": True, "off": False}[args.fast]
    for flag, on in (("--fast on", use_fast), ("--int8", args.int8)):
        if on and arch != "nested_unet":
            raise SystemExit(f"{flag} requires the custom-encoder NestedUNet "
                             f"(models/fast_forward, models/quantized); this model is {arch}")
    if use_fast:
        cfg = cfg.replace_in("segment", fast_forward=True)
    if args.int8:
        cfg = int8_cfg(model, cfg, args.video, args.device)

    if args.window is not None:
        hints["window_enabled"] = bool(args.window)
    if hints.get("window_enabled") and not cfg.geometry.enabled:
        cfg = cfg.replace_in("geometry", enabled=True)
    ecfg = EngineConfig(
        batch=args.batch, frame_stride=args.frame_stride, turn_hz=args.turn_hz,
        print_interval=args.print_interval, write_video=not args.no_video,
        output_dir=args.output, thresholds=ThresholdConfig(), **hints)
    return InferenceEngine(model, cfg, ecfg, device=args.device)


def cmd_infer(args) -> int:
    infer_engine(args).process_video(args.video, max_frames=args.max_frames)
    return 0


def cmd_inspect(args) -> int:
    from unet_tpu_torch.serve.inspect_tool import run_inspection

    return run_inspection(args.config, args.video, args.output, device=args.device)


def cmd_serve(args) -> int:
    """Serve N videos/cameras through one fixed-batch step
    (serve/multistream.py): every stream is a slot of one device batch."""
    from unet_tpu_torch.pipeline import get_preset
    from unet_tpu_torch.serve.service import open_sources, serve_streams

    cfg = get_preset(args.preset)
    if args.model_size:
        cfg = cfg.replace_in("preprocess", model_size=(args.model_size, args.model_size))
    model, num_classes, arch = load_model(args.model, args.arch, args.dtype,
                                          cfg.segment.num_classes)
    if num_classes != cfg.segment.num_classes:
        cfg = cfg.replace_in("segment", num_classes=num_classes)
    if arch == "nested_unet":
        cfg = cfg.replace_in("segment", fast_forward=True)

    named = open_sources(args.videos, args.cameras, frame_stride=args.frame_stride,
                         max_frames=args.max_frames)
    print(f"serving {len(named)} streams "
          f"({', '.join(n for n, _ in named)}) -> {args.output}")
    summary = serve_streams(model, cfg, named, args.output,
                            burr_event_px=args.burr_event_px, device=args.device)
    print(json.dumps(summary, indent=2))
    return 0


def cmd_train(args) -> int:
    """A training recipe (train.recipes) on --device, over every rank of the
    run: `torchrun --nproc-per-node N -m unet_tpu_torch.cli train ...`
    trains over N devices, one process each (the JAX CLI uses all devices
    of its one process). A --n-devices other than the world size refuses."""
    from unet_tpu_torch.parallel import multihost
    from unet_tpu_torch.train.recipes import run_recipe

    if args.n_devices is not None:
        backend = "gloo" if args.device == "cpu" else "cpu:gloo,cuda:nccl"
        _, world = multihost.initialize(backend=backend)
        if args.n_devices != world:
            raise SystemExit(
                f"--n-devices {args.n_devices}: this run's world size is {world} (one process "
                f"per device); launch torchrun --nproc-per-node {args.n_devices} -m "
                f"unet_tpu_torch.cli train ...")
    return run_recipe(args)


def cmd_evaluate(args) -> int:
    """Dataset mIoU/precision/recall + confusion CSV/JSON
    (reference tools/evaluate.py:22-114) on --device."""
    import os

    from unet_tpu_torch.data.dataset import SegmentationDataset
    from unet_tpu_torch.tools import evaluate_dataset

    model, num_classes, _ = load_model(args.model, args.arch, args.dtype, args.num_classes)
    split_dir = os.path.join(args.data_root, args.split)
    if not os.path.isdir(split_dir) and args.split == "test":
        split_dir = os.path.join(args.data_root, "val")
        print("note: no test split; evaluating on val")
    ds = SegmentationDataset(os.path.join(split_dir, "images"), os.path.join(split_dir, "masks"),
                             augment=False, target_size=(args.image_size, args.image_size))
    result = evaluate_dataset(model, ds, num_classes, batch_size=args.batch,
                              output_dir=args.output, device=args.device)
    result.pop("confusion", None)
    print(json.dumps(result, indent=2))
    return 0


# per-tool required flags (the tools share one parser's optional flags, so
# argparse cannot enforce them); a tuple means "at least one of"
_TOOL_REQUIRES = {
    "extract-frames": ["video", "out"],
    "audit": ["labelme_dir"],
    "class-dist": ["mask_dir"],
    "remap-masks": ["mask_dir", "out", "mapping"],
    "prepare-dataset": ["labelme_dir", "images_dir", "out"],
    "hard-negatives": ["videos_dir", "out"],
    "calibrate-roi": ["video"],
    "calibrate-scale": ["points", "known_mm"],
    "diagnose-mask": [("mask", "mask_dir")],
    "update-dataset": ["images_dir", "mask_dir", "out"],
    "render-masks": ["images_dir", "mask_dir", "out"],
    "render-predictions": ["images_dir", "out"],
    "annotate": ["out", "frame_id", "filename", "box"],
    "annotate-to-labelme": ["annotations_dir", "images_dir", "out"],
    "summarize-checkpoints": ["ckpt_dir"],
}
TOOLS = tuple(_TOOL_REQUIRES)


def _cmd_tools_interactive(args) -> int:
    """Mouse-driven annotate / calibrate-roi / calibrate-scale (reference
    tools/annotate_burr.py, calibrate_roi.py, calibrate_scale.py): the
    sessions of tools/interactive.py in a cv2 window."""
    from unet_tpu_torch.tools import interactive as I

    def first_frame():
        import cv2
        if args.video:
            cap = cv2.VideoCapture(args.video)
            ok, frame = cap.read()
            cap.release()
            if not ok:
                raise SystemExit(f"cannot read a frame from {args.video}")
            return frame
        if args.filename:
            im = cv2.imread(args.filename)
            if im is None:
                raise SystemExit(f"cannot read {args.filename}")
            return im
        raise SystemExit("--video or --filename is required")

    if args.tool == "annotate":
        if not (args.frames_dir and args.out):
            raise SystemExit("annotate --interactive needs --frames-dir + --out")
        sess = I.AnnotationSession(args.frames_dir, args.out)
        I.run_window(sess, window="annotate burrs")
        print(f"{len(sess.annotations)} frames annotated -> {args.out}")
    elif args.tool == "calibrate-roi":
        sess = I.RoiCalibrationSession(first_frame(), out_path=args.out or "roi.json")
        I.run_window(sess, window="calibrate ROI")
        print(f"ROI: {sess.roi}" + (f" -> {sess.out_path}" if sess.saved else " (not saved)"))
    elif args.tool == "calibrate-scale":
        if args.known_mm is None:
            raise SystemExit("calibrate-scale --interactive needs --known-mm")
        sess = I.ScaleCalibrationSession(first_frame(), args.known_mm)
        I.run_window(sess, window="calibrate scale")
        if sess.mm_per_px is None:
            raise SystemExit("need two clicked points")
        out = {"mm_per_px": sess.mm_per_px, "known_mm": args.known_mm}
        print(json.dumps(out))
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=2))
    else:
        raise SystemExit(f"tools {args.tool} has no --interactive mode")
    return 0


def cmd_tools(args) -> int:
    """The dataset, calibration and annotation tools (unet_tpu/cli/main.py:
    389-520); render-predictions runs its model on --device."""
    from unet_tpu_torch import tools as T

    if args.interactive:
        return _cmd_tools_interactive(args)

    for req in _TOOL_REQUIRES[args.tool]:
        names = req if isinstance(req, tuple) else (req,)
        if not any(getattr(args, n, None) not in (None, "", []) for n in names):
            opts = " or ".join("--" + n.replace("_", "-") for n in names)
            raise SystemExit(f"tools {args.tool}: {opts} is required")

    if args.tool == "extract-frames":
        roi = tuple(map(int, args.roi.split(","))) if args.roi else None
        T.extract_frames(args.video, args.out, fps=args.fps, roi=roi, dedup=args.dedup)
    elif args.tool == "audit":
        report = T.audit_labelme_dir(args.labelme_dir)
        print(json.dumps({k: (v if not isinstance(v, list) else len(v))
                          for k, v in report.items()}, indent=2))
        if args.out:
            Path(args.out).write_text(json.dumps(report, indent=2, default=str))
    elif args.tool == "class-dist":
        print(json.dumps(T.class_pixel_distribution(args.mask_dir, args.num_classes), indent=2))
    elif args.tool == "remap-masks":
        mapping = dict(pair.split(":") for pair in args.mapping.split(","))
        n = T.remap_masks(args.mask_dir, args.out, {int(k): int(v) for k, v in mapping.items()})
        print(f"remapped {n} masks")
    elif args.tool == "prepare-dataset":
        from unet_tpu_torch.data.labelme import prepare_dataset
        prepare_dataset(args.labelme_dir, args.images_dir, args.out)
    elif args.tool == "hard-negatives":
        T.create_hard_negative_dataset(args.videos_dir, args.out, num_frames=args.num_frames)
    elif args.tool == "calibrate-roi":
        roi = T.propose_roi_from_video(args.video)
        T.save_roi_json(args.out or "roi.json", roi["x"], roi["y"], roi["w"], roi["h"])
        print(f"proposed ROI: {roi}")
    elif args.tool == "calibrate-scale":
        # two points spanning a known distance -> mm/px (reference
        # tools/calibrate_scale.py:17-52, headless)
        vals = [float(v) for v in args.points.split(",")]
        if len(vals) != 4:
            raise SystemExit("--points must be x1,y1,x2,y2")
        mm_per_px = T.scale_from_two_points((vals[0], vals[1]), (vals[2], vals[3]),
                                            args.known_mm)
        out = {"mm_per_px": mm_per_px, "known_mm": args.known_mm}
        print(json.dumps(out))
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=2))
    elif args.tool == "diagnose-mask":
        import os

        from unet_tpu_torch.data.dataset import imread_mask
        paths = ([os.path.join(args.mask_dir, f) for f in sorted(os.listdir(args.mask_dir))
                  if f.lower().endswith(".png")] if args.mask_dir else [args.mask])
        resized = tuple(int(v) for v in args.resize.split(",")) if args.resize else None
        report = {p: T.diagnose_mask(imread_mask(p), args.num_classes, resized_hw=resized)
                  for p in paths}
        print(json.dumps(report, indent=2, default=str))
    elif args.tool == "update-dataset":
        counts = T.update_dataset(args.images_dir, args.mask_dir, args.out,
                                  val_ratio=args.val_ratio, test_ratio=args.test_ratio,
                                  seed=args.seed)
        print(f"split counts: {counts}")
    elif args.tool == "render-masks":
        n = T.render_masks(args.images_dir, args.mask_dir, args.out, limit=args.limit)
        print(f"rendered {n} overlays to {args.out}")
    elif args.tool == "render-predictions":
        model, num_classes, _ = load_model(args.model, args.arch, args.dtype, args.num_classes)
        inf = T.SingleImageInference(model, input_size=args.image_size or 512,
                                     num_classes=num_classes, device=args.device)
        n = T.render_predictions(inf, args.images_dir, args.mask_dir, args.out, limit=args.limit)
        print(f"rendered {n} comparison grids to {args.out}")
    elif args.tool == "annotate":
        # headless rectangle burr annotation: the burr_annotations.json
        # schema of the reference's mouse tool (tools/annotate_burr.py)
        ann = T.load_annotations(args.out)
        try:
            boxes = [[float(v) for v in b.split(",")] for b in args.box]
        except ValueError:
            raise SystemExit("--box must be x1,y1,x2,y2") from None
        if any(len(b) != 4 for b in boxes):
            raise SystemExit("--box must be x1,y1,x2,y2")
        T.add_boxes(ann, args.frame_id, args.filename, boxes, replace=args.replace)
        path = T.save_annotations(args.out, ann)
        n = len(ann[str(args.frame_id)]["burr_regions"])
        print(f"frame {args.frame_id}: {n} boxes -> {path}")
    elif args.tool == "annotate-to-labelme":
        ann = T.load_annotations(args.annotations_dir)
        n = T.annotations_to_labelme(ann, args.images_dir, args.out, label=args.label)
        print(f"wrote {n} labelme JSONs to {args.out}")
    else:   # summarize-checkpoints
        T.summarize_checkpoints(args.ckpt_dir)
    return 0


def cmd_export(args) -> int:
    """A torch.export program of the model forward, or with --pipeline of
    the whole fused step, traced on --device (unet_tpu/cli/main.py:265-278)."""
    from unet_tpu_torch.export.aot import export_model, export_pipeline

    if args.pipeline:
        h, w = (int(v) for v in args.frame_hw.split(","))
        export_pipeline(args.model, args.output, preset=args.pipeline, batch=args.batch,
                        frame_hw=(h, w), arch=args.arch, device=args.device)
        return 0
    export_model(args.model, args.output, arch=args.arch, input_size=args.input_size,
                 batch=args.batch, device=args.device)
    return 0


def cmd_not_ported(args) -> int:
    raise SystemExit(f"{args.cmd}: not ported to unet_tpu_torch yet, "
                     f"{_NOT_PORTED[args.cmd]}; the JAX package has it "
                     f"(python -m unet_tpu.cli {args.cmd})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="unet_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions of the kernels")

    pi = sub.add_parser("infer", help="video/image-dir inference with a preset")
    pi.add_argument("--video", required=True, help="video file or image dir")
    pi.add_argument("--output", required=True)
    pi.add_argument("--preset", default="two_stage")
    pi.add_argument("--config", default=None,
                    help="pipeline YAML overriding --preset; legacy AppCfg and "
                         "RefactorConfig layouts are migrated (core/config.py)")
    pi.add_argument("--model", default=None, help="reference .pth")
    pi.add_argument("--arch", default="nested_unet", help=_ARCH_HELP)
    pi.add_argument("--dtype", default="bfloat16", choices=list(_DTYPES))
    pi.add_argument("--batch", type=int, default=8)
    pi.add_argument("--frame-stride", type=int, default=1)
    pi.add_argument("--max-frames", type=int, default=None)
    pi.add_argument("--print-interval", type=int, default=60)
    pi.add_argument("--no-video", action="store_true")
    pi.add_argument("--model-size", type=int, default=None)
    pi.add_argument("--rotate", action="store_true",
                    help="rotate 90 CCW (reference --rotate)")
    pi.add_argument("--normalize-resolution", action="store_true",
                    help="resize to 800x448 (reference --normalize-resolution)")
    pi.add_argument("--burr-sensitivity", default="medium",
                    choices=["low", "medium", "high"])
    pi.add_argument("--window", type=int, default=None, choices=[0, 1],
                    help="force window/production mode on (1) or off (0); "
                         "default follows the preset")
    pi.add_argument("--turn-hz", type=float, default=None,
                    help="turn-rate frame sampling (reference infer_video.py)")
    pi.add_argument("--fast", default="auto", choices=["auto", "on", "off"],
                    help="BN-folded forward (models/fast_forward.py)")
    pi.add_argument("--int8", action="store_true",
                    help="int8 forward, calibrated on frames strided across the video "
                         "(models/quantized.py)")
    device_flag(pi)
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("inspect", help="yaml-config inspection serve")
    ps.add_argument("--config", required=True)
    ps.add_argument("--video", required=True)
    ps.add_argument("--output", default="./inspection_output")
    device_flag(ps)
    ps.set_defaults(fn=cmd_inspect)

    pm = sub.add_parser(
        "serve", help="serve N videos/cameras through one batched device step")
    pm.add_argument("--videos", nargs="*", default=[],
                    help="video files and/or image dirs, one stream each")
    pm.add_argument("--cameras", nargs="*", default=[],
                    help="GigE specs <cti_path>[:serial], one stream each")
    pm.add_argument("--output", required=True)
    pm.add_argument("--preset", default="wrap_7class")
    pm.add_argument("--model", default=None, help="reference .pth")
    pm.add_argument("--arch", default="nested_unet", help=_ARCH_HELP)
    pm.add_argument("--dtype", default="bfloat16", choices=list(_DTYPES))
    pm.add_argument("--model-size", type=int, default=None)
    pm.add_argument("--frame-stride", type=int, default=1)
    pm.add_argument("--max-frames", type=int, default=None,
                    help="per-stream cap (required for endless cameras)")
    pm.add_argument("--burr-event-px", type=int, default=50,
                    help="burr pixel count that logs an events.jsonl entry")
    device_flag(pm)
    pm.set_defaults(fn=cmd_serve)

    pt = sub.add_parser("train", help="training recipes (tools/train*.py family)")
    pt.add_argument("--recipe", default="3class_advanced")
    pt.add_argument("--data-root", required=True)
    pt.add_argument("--output", default="checkpoints")
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--batch", type=int, default=8)
    pt.add_argument("--image-size", type=int, default=None)
    pt.add_argument("--resume", default=None,
                    help="checkpoint dir of an earlier run; its last.pth goes on")
    pt.add_argument("--seed", type=int, default=42)
    pt.add_argument("--n-devices", type=int, default=None,
                    help="the world size expected (torchrun --nproc-per-node); "
                         "the run refuses another")
    pt.add_argument("--encoder", default="mobilenet_v3_small")
    pt.add_argument("--train-dtype", default="bfloat16", choices=list(_DTYPES),
                    help="compute dtype for training (params stay float32); "
                         "bfloat16 is the reference's AMP analogue")
    pt.add_argument("--remat", action="store_true",
                    help="recompute ConvBlocks in the backward pass (less activation "
                         "memory for more compute)")
    device_flag(pt)
    pt.set_defaults(fn=cmd_train)

    pv = sub.add_parser("evaluate", help="dataset mIoU + confusion CSV/JSON")
    pv.add_argument("--model", default=None,
                    help="reference .pth or a checkpoint of train (best.pth, last.pth)")
    pv.add_argument("--arch", default="nested_unet", help=_ARCH_HELP)
    pv.add_argument("--dtype", default="float32", choices=list(_DTYPES))
    pv.add_argument("--data-root", required=True,
                    help="root with <split>/images + <split>/masks")
    pv.add_argument("--split", default="test")
    pv.add_argument("--num-classes", type=int, default=3)
    pv.add_argument("--image-size", type=int, default=512)
    pv.add_argument("--batch", type=int, default=8)
    pv.add_argument("--output", default=None,
                    help="dir for confusion_matrix.csv + metrics.json")
    device_flag(pv)
    pv.set_defaults(fn=cmd_evaluate)

    pe = sub.add_parser("export", help="torch.export program (.pt2) of the model or the step")
    pe.add_argument("--model", required=True,
                    help="reference .pth or a checkpoint of train (best.pth, last.pth)")
    pe.add_argument("--output", required=True)
    pe.add_argument("--arch", default="nested_unet", help=_ARCH_HELP)
    pe.add_argument("--input-size", type=int, default=512)
    pe.add_argument("--batch", type=int, default=None,
                    help="None = dynamic batch dim (reference export_onnx.py)")
    pe.add_argument("--pipeline", default=None,
                    help="export the whole fused pipeline step of this preset "
                         "(preprocess+forward+burr+stats) instead of the bare model forward")
    pe.add_argument("--frame-hw", default="448,800",
                    help="input frame H,W for --pipeline artifacts")
    device_flag(pe)
    pe.set_defaults(fn=cmd_export)

    pk = sub.add_parser("tools", help="dataset/calibration utilities")
    pk.add_argument("tool", choices=TOOLS)
    pk.add_argument("--video", default=None)
    pk.add_argument("--videos-dir", default=None)
    pk.add_argument("--labelme-dir", default=None)
    pk.add_argument("--images-dir", default=None)
    pk.add_argument("--mask-dir", default=None)
    pk.add_argument("--mask", default=None, help="single mask png (diagnose-mask)")
    pk.add_argument("--out", default=None)
    pk.add_argument("--fps", type=float, default=5.0)
    pk.add_argument("--roi", default="")
    pk.add_argument("--dedup", type=float, default=0.97)
    pk.add_argument("--num-classes", type=int, default=7)
    pk.add_argument("--num-frames", type=int, default=200)
    pk.add_argument("--mapping", default="")
    pk.add_argument("--points", default="", help="x1,y1,x2,y2 for calibrate-scale")
    pk.add_argument("--known-mm", type=float, default=None,
                    help="real distance between --points")
    pk.add_argument("--resize", default=None,
                    help="H,W to test nearest-resize value preservation")
    pk.add_argument("--val-ratio", type=float, default=0.1)
    pk.add_argument("--test-ratio", type=float, default=0.1)
    pk.add_argument("--seed", type=int, default=42)
    pk.add_argument("--limit", type=int, default=None)
    pk.add_argument("--frame-id", type=int, default=None,
                    help="frame id to annotate (annotate)")
    pk.add_argument("--filename", default=None, help="frame image filename (annotate)")
    pk.add_argument("--box", action="append", default=[],
                    help="x1,y1,x2,y2 burr rectangle; repeatable (annotate)")
    pk.add_argument("--replace", action="store_true",
                    help="replace the frame's existing boxes (annotate)")
    pk.add_argument("--annotations-dir", default=None,
                    help="dir holding burr_annotations.json (annotate-to-labelme)")
    pk.add_argument("--label", default="burr_defect",
                    help="labelme class label (annotate-to-labelme)")
    pk.add_argument("--interactive", action="store_true",
                    help="mouse-driven cv2 window (annotate / calibrate-roi / "
                         "calibrate-scale); needs a display, headless hosts use the "
                         "flag-driven variants")
    pk.add_argument("--frames-dir", default=None,
                    help="extracted-frames dir (annotate --interactive)")
    pk.add_argument("--ckpt-dir", default=None, help="checkpoint dir (summarize-checkpoints)")
    pk.add_argument("--model", default=None,
                    help="reference .pth or a checkpoint of train (render-predictions)")
    pk.add_argument("--arch", default="nested_unet", help=_ARCH_HELP)
    pk.add_argument("--dtype", default="float32", choices=list(_DTYPES))
    pk.add_argument("--image-size", type=int, default=512)
    device_flag(pk)
    pk.set_defaults(fn=cmd_tools)

    for name, item in _NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet: {item}").set_defaults(fn=cmd_not_ported)
    return p


def main(argv: Optional[list] = None) -> int:
    parser = build_parser()
    # a command not ported yet takes any flags of the JAX package's and names its item
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not cmd_not_ported:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
