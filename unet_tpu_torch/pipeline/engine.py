"""The inference engine: the host loop around the step (counterpart of
unet_tpu/pipeline/engine.py:43-632).

One engine for the reference's per-script main loops: batched decode ->
upload -> dispatch of the step on the device -> per-frame host logic (event
detection and gating, the wrap-uniformity monitor, per-frame CSV stats,
window aggregation, OK/NG events, overlay video), in four threads so that
decode, the copies, the card and the host's work overlap.

On a card, frames go up from a pool of pinned host buffers on an upload
stream, and the dispatch stream waits for each copy's event before the step
reads the frames; every output of the step comes back into pinned host
tensors on the dispatch stream, and the sink waits for that copy's event
before it reads them. Each thread names its stream. On the CPU
(`device="cpu"`) the same four threads run without streams or copies.

Outputs, as the JAX engine's: events.csv (every frame's percentages and
burr pixels), detector_events.csv, gated_events.csv, wrap_uniformity.csv,
events/inspection_events.jsonl and the OK/NG images of window mode,
windows/<id>/ evidence of NG windows, result.mp4, and, from the step's
quality statistics and defect components, the frame quality gate's
skipped.csv and the defect tracker's confirmed_defects.csv. The quality
statistics' first frame of a batch diffs against the previous batch's last
valid frame (the first batch's against itself), which goes up from a
pinned buffer of its own beside the frames'.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from unet_tpu_torch.events.emitters import EventOutputConfig, InspectionEventLogger, _imwrite
from unet_tpu_torch.inspect import (DefectTracker, EventConfig, EventDetector, EventGate,
                                    FrameMetrics, FrameQualityGate, FrameResult,
                                    ThresholdConfig, WindowAggregator, WrapUniformityMonitor,
                                    make_decision)
from unet_tpu_torch.io.video import ImageDirReader, VideoReader, VideoWriter, _cv2
from unet_tpu_torch.pipeline import stages
from unet_tpu_torch.pipeline.config import PipelineCfg
from unet_tpu_torch.pipeline.visualize import draw_hud, two_stage_overlay


@dataclass
class EngineConfig:
    batch: int = 8
    frame_stride: int = 1
    # turn-rate-based sampling: stride = fps / (turn_hz * eval_per_turn)
    # (reference infer_video.py:333); overrides frame_stride when set
    turn_hz: Optional[float] = None
    eval_per_turn: int = 4
    print_interval: int = 60
    write_video: bool = True
    output_dir: str = "./output"
    # window/production mode (requires cfg.geometry.enabled)
    window_enabled: bool = False
    window_duration_sec: float = 3.0
    window_min_frames: int = 6
    window_max_frames: int = 12
    thresholds: ThresholdConfig = field(default_factory=ThresholdConfig)
    # per-NG-window evidence dirs: every window frame + overlay +
    # window_info.json (reference infer_video_production.py:299-456)
    evidence_dirs: bool = False
    # frame quality gate (requires cfg.inspect.quality_stats; reference
    # infer_video.py:73-118)
    quality_enabled: bool = False
    quality_blur_th: float = 80.0
    quality_flat_th: float = 8.0
    quality_motion_th: float = 10.0
    quality_glitch_flat_th: float = 3.0
    # consecutive-frame event detector with per-type cooldown (requires
    # cfg.geometry.enabled; reference src/refactor/event_detector.py:24-175)
    event_detector_enabled: bool = False
    event_cfg: EventConfig = field(default_factory=EventConfig)
    # N-consecutive abnormal-frame confirmation + cooldown before an event
    # is logged (requires cfg.geometry.enabled; reference
    # infer_video_robust.py:219-239). A frame is abnormal when the wrap
    # ratio dt/dc leaves [gate_ratio_min, gate_ratio_max] or a burr is present.
    event_gate_enabled: bool = False
    gate_hold_frames: int = 8
    gate_cooldown_sec: float = 3.0
    gate_ratio_min: float = 1.05
    gate_ratio_max: float = 1.5
    # IoU-matched multi-frame defect confirmation (requires
    # cfg.inspect.track_defects; reference infer_video_optimized.py:66-189)
    tracker_enabled: bool = False
    tracker_confirm_frames: int = 3
    tracker_iou: float = 0.3
    tracker_stale_frames: int = 10
    # wrap-uniformity monitor + CSV (requires cfg.geometry.enabled;
    # reference infer_wrap_uniformity.py:33-131)
    wrap_monitor_enabled: bool = False
    wrap_ratio_min: float = 1.05
    wrap_ratio_max: float = 1.5
    wrap_window: int = 30
    wrap_std_threshold: float = 0.15
    camera_id: str = "cam0"
    max_in_flight: int = 2  # device batches in flight (double buffering)

    def merged(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


CLASS_NAMES = {3: "bulge_defect", 4: "loose_defect", 5: "damage_defect",
               6: "thin_defect"}


class _Stop(Exception):
    """The pipeline was told to stop while waiting on a queue."""


class _PinnedPool:
    """`n` pinned host buffers for the uploads, used in turn; a buffer is
    handed out again only after the event of its last copy has completed."""

    def __init__(self, n: int):
        self.n, self.bufs, self.events, self.k = n, [], [], -1

    def take(self, shape) -> torch.Tensor:
        if not self.bufs or tuple(self.bufs[0].shape) != tuple(shape):
            self.bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                         for _ in range(self.n)]
            self.events = [None] * self.n
        self.k = (self.k + 1) % self.n
        if self.events[self.k] is not None:
            self.events[self.k].synchronize()
        return self.bufs[self.k]

    def copied(self, event: "torch.cuda.Event") -> None:
        """The copy out of the buffer last taken is marked by `event`."""
        self.events[self.k] = event


class InferenceEngine:
    """Runs `model` through the step of `cfg` on `device` ("cuda" unless the
    caller asks for the CPU; without a card a "cuda" engine raises, as
    `stages.build_step` does) over a video file or an image directory."""

    def __init__(self, model: torch.nn.Module, cfg: PipelineCfg,
                 engine_cfg: Optional[EngineConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.model = model
        self.cfg = cfg
        self.ecfg = e = engine_cfg or EngineConfig()
        self.quality_gate: Optional[FrameQualityGate] = (
            FrameQualityGate(True, e.quality_blur_th, e.quality_flat_th,
                             e.quality_motion_th, e.quality_glitch_flat_th)
            if e.quality_enabled else None)
        if self.quality_gate is not None and not cfg.inspect.quality_stats:
            raise ValueError("quality_enabled requires cfg.inspect.quality_stats "
                             "(the gate's statistics come from the device step)")
        if e.tracker_enabled and not cfg.inspect.track_defects:
            raise ValueError("tracker_enabled requires cfg.inspect.track_defects")
        if e.event_gate_enabled and not cfg.geometry.enabled:
            raise ValueError("event_gate_enabled requires cfg.geometry.enabled "
                             "(abnormality comes from the wrap ratio)")
        self.device = torch.device(device)
        self.step = stages.build_step(model, cfg, device=self.device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._upload_stream = torch.cuda.Stream(self.device)
            self._dispatch_stream = torch.cuda.Stream(self.device)
        # the detector, the tracker and the gate carry frame-indexed state
        # and are rebuilt for every video: frame ids restart with each one
        self.event_detector: Optional[EventDetector] = None
        self.tracker: Optional[DefectTracker] = None
        self.event_gate: Optional[EventGate] = None

    def _reset_per_video(self) -> None:
        e = self.ecfg
        self.event_detector = EventDetector(e.event_cfg) if e.event_detector_enabled else None
        self.tracker = (DefectTracker(e.tracker_confirm_frames, e.tracker_iou,
                                      e.tracker_stale_frames, CLASS_NAMES)
                        if e.tracker_enabled else None)
        # the gate's cooldown runs on video time (frame_id / source fps), not
        # the wall clock, so that gated_events.csv does not depend on the
        # engine's throughput
        self._video_time = 0.0
        self.event_gate = (EventGate(e.gate_hold_frames, e.gate_cooldown_sec,
                                     clock=lambda: self._video_time)
                           if e.event_gate_enabled else None)

    def _host_preprocess(self, frame: np.ndarray, hw) -> np.ndarray:
        """The step's geometric preprocess (rotate, normalize) on the host
        copy used for overlays, so that masks line up."""
        if self.cfg.preprocess.rotate90_ccw or frame.shape[:2] != tuple(hw):
            cv2 = _cv2("overlays of rotated or resized frames")
            if self.cfg.preprocess.rotate90_ccw:
                frame = cv2.rotate(frame, cv2.ROTATE_90_COUNTERCLOCKWISE)
            if frame.shape[:2] != tuple(hw):
                frame = cv2.resize(frame, (hw[1], hw[0]))
        return frame

    # -- the copies ----------------------------------------------------------

    def _on_device(self):
        """The engine's card as the thread's current device (the CPU: nothing)."""
        return torch.cuda.device(self.device) if self._cuda else contextlib.nullcontext()

    def _upload(self, frames: np.ndarray, pool: "_PinnedPool",
                prev: Optional[np.ndarray] = None, prev_pool: Optional["_PinnedPool"] = None):
        """(B, H, W, 3) uint8 frames, and the (1, H, W, 3) previous frame of
        the quality statistics or None -> (frames on the device, previous
        frame on the device or None, the copies' event or None). On a card:
        each copied into its pool's next pinned buffer, then to the device
        on the upload stream; a buffer is refilled only after the event of
        its last copy."""
        if not self._cuda:
            return (torch.from_numpy(frames),
                    None if prev is None else torch.from_numpy(prev), None)
        bufs = [(pool, frames)] + ([] if prev is None else [(prev_pool, prev)])
        dev = []
        with torch.cuda.stream(self._upload_stream):
            for p, a in bufs:
                buf = p.take(a.shape)
                buf.numpy()[...] = a
                dev.append(buf.to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self._upload_stream)
        for p, _ in bufs:
            p.copied(done)
        return dev[0], (dev[1] if prev is not None else None), done

    def _download(self, out: stages.FrameOutputs):
        """Every output of the step into host tensors: on a card, pinned
        tensors filled on the current (dispatch) stream, and the event that
        marks the copies done; on the CPU the outputs and None."""
        if not self._cuda:
            return out, None

        def leaf(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h

        host = type(out)(*(v if v is None else
                           type(v)(*map(leaf, v)) if isinstance(v, tuple) else leaf(v)
                           for v in out))
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _numpy(out: stages.FrameOutputs) -> stages.FrameOutputs:
        """Host tensors of every output as numpy arrays."""
        return type(out)(*(v if v is None else
                           type(v)(*(t.numpy() for t in v)) if isinstance(v, tuple)
                           else v.numpy() for v in out))

    # -- host-side consumers -------------------------------------------------

    def _close_window(self, state: Dict[str, Any], frame: np.ndarray,
                      vis: Optional[np.ndarray], class_map_i, roi) -> None:
        """The window is complete: decide, log, write evidence."""
        agg = state["aggregator"]
        stats = agg.get_statistics()
        decision = make_decision(stats, self.ecfg.thresholds)
        state["decisions"].append(decision)
        if state["event_logger"] is not None:
            if vis is None:
                vis = two_stage_overlay(frame, class_map_i, roi)
            state["event_logger"].log_event(
                decision, stats, frame_bgr=frame, overlay_bgr=vis,
                camera_id=self.ecfg.camera_id)
        if self.ecfg.evidence_dirs and decision.result == "NG":
            # per-window evidence dir: all frames + overlays + window_info.json
            # (reference infer_video_production.py:299-456)
            wdir = Path(self.ecfg.output_dir) / "windows" / decision.window_id
            wdir.mkdir(parents=True, exist_ok=True)
            for fid, wf, wo in state["window_frames"]:
                _imwrite(wdir / f"frame_{fid:06d}.jpg", wf)
                _imwrite(wdir / f"overlay_{fid:06d}.jpg", wo)
            (wdir / "window_info.json").write_text(json.dumps({
                "window_id": decision.window_id,
                "result": decision.result,
                "severity": decision.severity,
                "reasons": decision.reasons,
                "metrics": decision.metrics,
                "num_frames": stats.num_frames,
                "frame_ids": [fid for fid, _, _ in state["window_frames"]],
            }, ensure_ascii=False, indent=2), encoding="utf-8")
        state["window_frames"].clear()
        agg.reset()

    def _consume(self, ids: List[int], frames: np.ndarray, n_valid: int,
                 out: stages.FrameOutputs, state: Dict[str, Any]) -> None:
        """Per-frame host logic over one batch's outputs, numpy arrays."""
        t_host = time.perf_counter()
        class_map, cable_px, tape_px, burr_px = (out.class_map, out.cable_px, out.tape_px,
                                                 out.burr_px)
        dc_all = dt_all = None
        if out.diameters is not None:
            dc_all, dt_all = out.diameters.dc_px, out.diameters.dt_px
        h, w = class_map.shape[-2:]

        roi = None
        if self.cfg.roi is not None:
            r = self.cfg.roi.scaled((w, h)) if self.cfg.roi.space != (w, h) else self.cfg.roi
            roi = (r.x1, r.y1, r.x2, r.y2)
        roi_area = ((roi[2] - roi[0]) * (roi[3] - roi[1])) if roi else h * w

        quality, comps = out.quality, out.defect_components
        for i in range(n_valid):
            fid = ids[i]
            state["processed"] += 1

            if self.quality_gate is not None and quality is not None:
                q = self.quality_gate.check(float(quality.lap_var[i]), float(quality.gray_std[i]),
                                            float(quality.mad[i]))
                if q.is_bad:
                    state["skipped"].append([fid, q.reason, f"{q.lap_var:.2f}",
                                             f"{q.gray_std:.2f}", f"{q.mad:.2f}"])
                    if state["writer"] is not None:
                        frame = self._host_preprocess(frames[i], (h, w))
                        draw_hud(frame, [f"Frame: {fid} [SKIPPED] {q.reason}"])
                        state["writer"].write(frame)
                    continue

            cable_ratio = cable_px[i] / roi_area * 100
            tape_ratio = tape_px[i] / roi_area * 100
            burr_ratio = burr_px[i] / roi_area * 100
            has_burr = burr_px[i] > 0
            if has_burr:
                state["burr_frames"] += 1
            status = "[BURR!]" if has_burr else "[OK]"

            state["csv_rows"].append([fid, f"{cable_ratio:.2f}", f"{tape_ratio:.2f}",
                                      f"{burr_ratio:.2f}", int(burr_px[i]), status])

            dc_px = dt_px = None
            if dc_all is not None:
                dc_px, dt_px = float(dc_all[i]), float(dt_all[i])

            if state["wrap_monitor"] is not None and dc_px is not None:
                r = state["wrap_monitor"].update(fid, dc_px, dt_px)
                if r["is_thin"]:
                    state["wrap_events"].append((fid, "thin"))
                if r["is_thick"]:
                    state["wrap_events"].append((fid, "thick"))

            if self.event_gate is not None and dc_px is not None:
                self._video_time = fid / max(state["fps_in"], 1e-6)
                ratio = dt_px / dc_px if dc_px > 0 else None
                abnormal = bool(has_burr) or (
                    ratio is not None and not
                    (self.ecfg.gate_ratio_min <= ratio <= self.ecfg.gate_ratio_max))
                self.event_gate.update(abnormal)
                if self.event_gate.should_fire():
                    state["gated_events"].append(
                        (fid, "abnormal_confirmed",
                         f"{ratio:.3f}" if ratio is not None else "",
                         int(has_burr)))

            if self.event_detector is not None and dc_px is not None:
                ratio = dt_px / dc_px if dc_px > 0 else None
                fired = self.event_detector.add_frame(FrameMetrics(
                    frame_id=fid, dc_px=dc_px, dt_px=dt_px,
                    delta_d_px=dt_px - dc_px, ratio=ratio,
                    has_burr=bool(has_burr),
                    cable_coverage=cable_ratio / 100,
                    tape_coverage=tape_ratio / 100))
                for name in fired:
                    state["detector_events"].append((fid, name))

            if self.tracker is not None and comps is not None:
                detections = [
                    {"class_id": int(comps.class_id[i, k]),
                     "bbox": (float(comps.left[i, k]), float(comps.top[i, k]),
                              float(comps.left[i, k] + comps.width[i, k]),
                              float(comps.top[i, k] + comps.height[i, k])),
                     "area": int(comps.area[i, k])}
                    for k in range(comps.valid.shape[-1]) if comps.valid[i, k]]
                state["confirmed_defects"].extend(self.tracker.update(detections, fid))

            vis = None
            frame = None
            if state["writer"] is not None or (
                    self.ecfg.evidence_dirs and state["aggregator"] is not None):
                frame = self._host_preprocess(frames[i], (h, w))
                vis = two_stage_overlay(frame, class_map[i], roi)
            if state["writer"] is not None:
                elapsed = time.time() - state["t0"]
                fps_now = state["processed"] / elapsed if elapsed > 0 else 0.0
                # the HUD goes on a copy: `vis` also feeds evidence dirs and
                # event images, which stay clean overlays
                hud = vis.copy()
                draw_hud(hud, [
                    f"Frame: {fid} | FPS: {fps_now:.1f}",
                    f"{status} Cable:{cable_ratio:.1f}% Tape:{tape_ratio:.1f}% "
                    f"Burr:{burr_ratio:.1f}%",
                ])
                state["writer"].write(hud)

            if state["aggregator"] is not None and out.diameters is not None:
                state["aggregator"].add_frame(FrameResult.from_device(
                    timestamp_ns=int(fid / max(state["fps_in"], 1e-6) * 1e9),
                    frame_id=fid, diameter=out.diameters, defects=out.defects,
                    index=i))
                if self.ecfg.evidence_dirs:
                    if frame is None:
                        frame = self._host_preprocess(frames[i], (h, w))
                        vis = two_stage_overlay(frame, class_map[i], roi)
                    state["window_frames"].append((fid, frame, vis))
                if state["aggregator"].is_ready():
                    if frame is None:
                        frame = self._host_preprocess(frames[i], (h, w))
                    self._close_window(state, frame, vis, class_map[i], roi)

            if state["processed"] % self.ecfg.print_interval == 0:
                print(f"[{state['processed']:4d}] Frame {fid} {status} | "
                      f"Cable:{cable_ratio:5.1f}% Tape:{tape_ratio:5.1f}% "
                      f"Burr:{burr_ratio:5.1f}%")
        state["legs"]["host"] += time.perf_counter() - t_host

    # -- main loop -----------------------------------------------------------

    def process_video(self, video_path: str, max_frames: Optional[int] = None
                      ) -> Dict[str, Any]:
        self._reset_per_video()
        if Path(video_path).is_dir():
            source = ImageDirReader(video_path, max_frames)
        else:
            stride = self.ecfg.frame_stride
            if self.ecfg.turn_hz:
                probe = VideoReader(video_path)
                fps_in = probe.meta.fps
                probe.cap.release()
                stride = max(1, int(round(
                    fps_in / (self.ecfg.turn_hz * self.ecfg.eval_per_turn))))
            source = VideoReader(video_path, stride, max_frames)
        if self.ecfg.wrap_monitor_enabled and not self.cfg.geometry.enabled:
            raise ValueError("wrap_monitor_enabled requires cfg.geometry.enabled")
        out_dir = Path(self.ecfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)

        state: Dict[str, Any] = {
            "processed": 0, "burr_frames": 0, "csv_rows": [], "skipped": [],
            "detector_events": [], "wrap_events": [], "confirmed_defects": [],
            "gated_events": [], "window_frames": [], "batch_lat_ms": [],
            "legs": {"decode": 0.0, "upload": 0.0, "dispatch": 0.0,
                     "download": 0.0, "host": 0.0},
            "t0": time.time(), "decisions": [], "fps_in": source.meta.fps,
            "writer": VideoWriter(str(out_dir / "result.mp4"), source.meta.fps)
            if self.ecfg.write_video else None,
            "aggregator": WindowAggregator(
                self.ecfg.window_duration_sec, self.ecfg.window_min_frames,
                self.ecfg.window_max_frames) if self.ecfg.window_enabled else None,
            "event_logger": InspectionEventLogger(EventOutputConfig(
                output_dir=str(out_dir / "events")))
            if self.ecfg.window_enabled else None,
            "wrap_monitor": WrapUniformityMonitor(
                self.ecfg.wrap_ratio_min, self.ecfg.wrap_ratio_max,
                self.ecfg.wrap_window, self.ecfg.wrap_std_threshold,
                csv_path=str(out_dir / "wrap_uniformity.csv"))
            if self.ecfg.wrap_monitor_enabled else None,
        }
        self._run_threads(source, state)

        if state["writer"] is not None:
            state["writer"].close()

        with open(out_dir / "events.csv", "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["frame_id", "cable_pct", "tape_pct", "burr_pct",
                         "burr_px", "status"])
            wr.writerows(state["csv_rows"])
        if self.quality_gate is not None:
            with open(out_dir / "skipped.csv", "w", newline="") as f:
                wr = csv.writer(f)
                wr.writerow(["frame_id", "reason", "lap_var", "gray_std", "mad"])
                wr.writerows(state["skipped"])
        if self.event_detector is not None:
            with open(out_dir / "detector_events.csv", "w", newline="") as f:
                wr = csv.writer(f)
                wr.writerow(["frame_id", "event_type"])
                wr.writerows(state["detector_events"])
        if self.event_gate is not None:
            with open(out_dir / "gated_events.csv", "w", newline="") as f:
                wr = csv.writer(f)
                wr.writerow(["frame_id", "event_type", "ratio", "has_burr"])
                wr.writerows(state["gated_events"])
        if self.tracker is not None:
            with open(out_dir / "confirmed_defects.csv", "w", newline="") as f:
                wr = csv.writer(f)
                wr.writerow(["defect_id", "type", "class_id", "start_frame",
                             "duration", "area", "confidence"])
                for c in state["confirmed_defects"]:
                    wr.writerow([c["defect_id"], c["type"], c["class_id"],
                                 c["start_frame"], c["duration"], c["area"],
                                 f"{c['confidence']:.2f}"])

        elapsed = time.time() - state["t0"]
        n = max(state["processed"], 1)
        legs_ms = {k: round(v * 1000 / n, 3) for k, v in state["legs"].items()}
        # with the four stages overlapped, throughput is bound by the slowest
        # (decode | upload | dispatch | sink's download wait + host work);
        # 'download' includes waiting out device work not yet done
        bottleneck = max(legs_ms["decode"], legs_ms["upload"], legs_ms["dispatch"],
                         legs_ms["download"] + legs_ms["host"])
        lat = sorted(state["batch_lat_ms"])
        batch_latency = None
        if lat:
            batch_latency = {
                "batch": self.ecfg.batch,
                "p50": round(lat[len(lat) // 2], 1),
                "p99": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 1),
                "max": round(lat[-1], 1)}
        summary = {
            "processed": state["processed"],
            "elapsed_sec": round(elapsed, 2),
            "fps": round(state["processed"] / elapsed, 2) if elapsed > 0 else 0.0,
            "legs_ms_per_frame": legs_ms,
            "pipelined_fps_bound": round(1000.0 / bottleneck, 2) if bottleneck > 0 else None,
            # per-batch dispatch -> consumed latency percentiles (ms)
            "batch_latency_ms": batch_latency,
            "burr_frames": state["burr_frames"],
            "skipped_frames": len(state["skipped"]),
            "detector_events": len(state["detector_events"]),
            "gated_events": len(state["gated_events"]),
            "confirmed_defects": len(state["confirmed_defects"]),
            "wrap_events": len(state["wrap_events"]),
            "ng_windows": sum(1 for d in state["decisions"] if d.result == "NG"),
            "total_windows": len(state["decisions"]),
            "output_dir": str(out_dir),
        }
        print("-" * 70)
        print(f"done: {summary['processed']} frames in {summary['elapsed_sec']}s "
              f"(avg {summary['fps']} FPS), burr frames: {summary['burr_frames']}")
        if state["event_logger"] is not None:
            state["event_logger"].print_summary()
        return summary

    def _run_threads(self, source, state: Dict[str, Any]) -> None:
        """decode thread -> upload thread -> dispatch (this thread) -> sink
        thread. Decode of batch N+3 overlaps the upload of N+2, the card's
        work on N+1 and the host's work on N. Every blocking queue operation
        polls `stop`, so that a stage that fails can never leave another
        waiting on a full or empty queue; the first error is raised here."""
        decode_q: queue.Queue = queue.Queue(maxsize=2)
        upload_q: queue.Queue = queue.Queue(maxsize=max(self.ecfg.max_in_flight, 1))
        consume_q: queue.Queue = queue.Queue(maxsize=max(self.ecfg.max_in_flight, 1))
        errors: List[BaseException] = []
        legs = state["legs"]
        stop = threading.Event()

        def put(q: queue.Queue, item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue
            raise _Stop

        def get(q: queue.Queue):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            raise _Stop

        def stage(fn):
            """Run `fn` as a stage: its error is recorded (and raised by
            `_run_threads` once every stage has ended) and stops the
            others; a stage stopped by another's failure ends quietly."""
            def run():
                try:
                    fn()
                except _Stop:
                    pass
                except BaseException as e:
                    errors.append(e)
                    stop.set()
            return run

        def decoder():
            try:
                it = source.batches(self.ecfg.batch)
                while True:
                    t0 = time.perf_counter()
                    item = next(it, None)
                    legs["decode"] += time.perf_counter() - t0
                    if item is None:
                        break
                    put(decode_q, item)
            finally:
                if not stop.is_set():
                    put(decode_q, None)

        def uploader():
            pool = _PinnedPool(max(self.ecfg.max_in_flight, 1) + 2)
            prev_pool = _PinnedPool(max(self.ecfg.max_in_flight, 1) + 2)
            prev_last: Optional[np.ndarray] = None
            with self._on_device():
                try:
                    while (item := get(decode_q)) is not None:
                        ids, frames, n_valid = item
                        t0 = time.perf_counter()
                        prev = None
                        if self.cfg.inspect.quality_stats:
                            # the previous batch's last valid frame; the first
                            # batch diffs frame 0 against itself, as the
                            # reference does (infer_video.py:101-104)
                            prev = frames[:1] if prev_last is None else prev_last
                            prev_last = frames[n_valid - 1:n_valid].copy()
                        fr_dev, prev_dev, ready = self._upload(frames, pool, prev, prev_pool)
                        legs["upload"] += time.perf_counter() - t0
                        put(upload_q, (ids, frames, n_valid, fr_dev, prev_dev, ready))
                finally:
                    if not stop.is_set():
                        put(upload_q, None)

        def dispatcher():
            stream = self._dispatch_stream if self._cuda else None
            with self._on_device(), (torch.cuda.stream(stream) if stream is not None
                                     else contextlib.nullcontext()):
                try:
                    while (item := get(upload_q)) is not None:
                        ids, frames, n_valid, fr_dev, prev_dev, ready = item
                        t0 = time.perf_counter()
                        if ready is not None:
                            stream.wait_event(ready)
                            for t in (fr_dev, prev_dev):
                                if t is not None:
                                    t.record_stream(stream)
                        out = self.step(fr_dev, prev_dev)
                        host, done = self._download(out)
                        legs["dispatch"] += time.perf_counter() - t0
                        put(consume_q, (ids, frames, n_valid, host, done, t0))
                finally:
                    if not stop.is_set():
                        put(consume_q, None)

        def sink():
            while (item := get(consume_q)) is not None:
                ids, frames, n_valid, host, done, t_dispatch = item
                t0 = time.perf_counter()
                if done is not None:
                    done.synchronize()   # the copies' event: reading earlier reads garbage
                out = self._numpy(host)
                legs["download"] += time.perf_counter() - t0
                self._consume(ids, frames, n_valid, out, state)
                # per-batch latency: dispatch -> results consumed (device
                # step, copies back, host logic)
                state["batch_lat_ms"].append((time.perf_counter() - t_dispatch) * 1000.0)

        threads = [threading.Thread(target=stage(f), daemon=True)
                   for f in (decoder, uploader, sink)]
        for t in threads:
            t.start()
        try:
            stage(dispatcher)()
            threads[2].join()   # drain the batches in flight
        finally:
            stop.set()          # unblocks any stage still waiting on a queue
            for t in threads:
                t.join(timeout=10.0)
        if errors:
            raise errors[0]

