"""`cli serve` product wiring: N videos/cameras through MultiStreamServer,
with per-stream CSV + burr-event JSONL + wrap-uniformity outputs (counterpart
of unet_tpu/serve/service.py).

The reference runs one process per video (every infer_video*.py script loops a
single cv2.VideoCapture); serving N streams means N python processes and N GPU
contexts. Here all streams share ONE fixed-slot compiled step (batch =
n_streams), so device utilization grows with stream count instead of process
count (SURVEY §2.2 'multi-stream batched inference').
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from unet_tpu_torch.io.video import _cv2
from unet_tpu_torch.serve.multistream import MultiStreamServer, StreamResult


class _CommonSize:
    """Thread-safe shared (H, W) for a stream group. Seeded from the first
    source that publishes a .meta; otherwise (camera-only serving, where the
    resolution is unknown until acquisition starts) the first decoded frame
    across ALL streams wins. Reader threads race on resolve(); the lock makes
    first-set-wins deterministic enough — every later stream resizes to it."""

    def __init__(self, hw: Optional[Tuple[int, int]] = None):
        import threading
        self._hw = hw
        self._lock = threading.Lock()

    def resolve(self, frame_hw: Tuple[int, int]) -> Tuple[int, int]:
        with self._lock:
            if self._hw is None:
                self._hw = tuple(frame_hw)
            return self._hw


class _ResizedSource:
    """Adapter normalizing a stream to the group's common (H, W) so
    mixed-resolution streams can share the fixed batch (slots are stacked
    into one array). Resized on the host by OpenCV's uint8 INTER_LINEAR,
    whose fixed-point bytes the float `ops.image.resize_bilinear` does not
    give."""

    def __init__(self, source, common: _CommonSize):
        self.source = source
        self.common = common

    def frames(self):
        for fid, frame in self.source.frames():
            h, w = self.common.resolve(frame.shape[:2])
            if frame.shape[:2] != (h, w):
                frame = _cv2("resizing mixed-resolution streams").resize(frame, (w, h))
            yield fid, frame


class _LimitedSource:
    """Caps an endless source (camera) at n frames so serve() terminates."""

    def __init__(self, source, n: int):
        self.source = source
        self.n = n

    def frames(self):
        for i, item in enumerate(self.source.frames()):
            if i >= self.n:
                break
            yield item


def open_sources(videos: Sequence[str], cameras: Sequence[str] = (),
                 frame_stride: int = 1, max_frames: Optional[int] = None,
                 ) -> List[Tuple[str, Any]]:
    """(name, source) per stream. Videos may be files or image dirs; cameras
    are GigE serials (io.camera). All streams are normalized to the first
    stream's resolution so the serving batch has one static shape."""
    from unet_tpu_torch.io.video import ImageDirReader, VideoReader

    named: List[Tuple[str, Any]] = []
    for v in videos:
        name = Path(v).stem or f"video{len(named)}"
        if Path(v).is_dir():
            named.append((name, ImageDirReader(v, max_frames=max_frames)))
        else:
            named.append((name, VideoReader(v, frame_stride, max_frames)))
    for spec in cameras:
        # camera spec: <cti_path>[:serial]
        from unet_tpu_torch.io.camera import GigECameraHarvester
        cti, _, serial = spec.partition(":")
        cam = GigECameraHarvester(cti, serial=serial or None)
        cam.open()
        src = _LimitedSource(cam, max_frames) if max_frames else cam
        named.append((f"cam_{serial or len(named)}", src))
    if not named:
        raise ValueError("serve: no streams (need --videos and/or --cameras)")
    # normalize EVERY stream to one common resolution — seeded from the
    # first source that knows its size, else (camera-only) from the first
    # decoded frame; without this a mixed group would crash np.stack on the
    # first assembled batch
    hw = None
    for _, s in named:
        meta = getattr(s, "meta", None)
        if meta is not None:
            hw = (meta.height, meta.width)
            break
    common = _CommonSize(hw)
    return [(n, _ResizedSource(s, common)) for n, s in named]


class StreamWriter:
    """Per-stream outputs under <output>/<name>/:
    results.csv        every processed frame's device stats
    events.jsonl       burr events (burr_px >= burr_event_px)
    wrap_uniformity.csv  when the pipeline reports diameters (wrap presets)
    """

    def __init__(self, stream_id: int, name: str, out_dir: Path,
                 burr_event_px: int, wrap: bool):
        self.stream_id = stream_id
        self.name = name
        self.dir = out_dir / f"stream_{stream_id:02d}_{name}"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.burr_event_px = burr_event_px
        self._csv_f = open(self.dir / "results.csv", "w", newline="")
        self._csv = csv.writer(self._csv_f)
        self._csv.writerow(["frame_id", "cable_px", "tape_px", "burr_px",
                            "dc_px", "dt_px"])
        self._events_f = open(self.dir / "events.jsonl", "w")
        self.monitor = None
        if wrap:
            from unet_tpu_torch.inspect.uniformity import WrapUniformityMonitor
            self.monitor = WrapUniformityMonitor(
                csv_path=str(self.dir / "wrap_uniformity.csv"))
        self.frames = 0
        self.events = 0
        self._t0 = time.time()

    def on_result(self, r: StreamResult) -> None:
        self.frames += 1
        self._csv.writerow([
            r.frame_id, r.cable_px, r.tape_px, r.burr_px,
            "" if r.dc_px is None else f"{r.dc_px:.2f}",
            "" if r.dt_px is None else f"{r.dt_px:.2f}"])
        if r.burr_px >= self.burr_event_px:
            self.events += 1
            self._events_f.write(json.dumps({
                "type": "burr", "frame_id": r.frame_id,
                "burr_px": r.burr_px, "cable_px": r.cable_px,
                "wallclock": round(time.time() - self._t0, 3)}) + "\n")
        if self.monitor is not None and r.dc_px is not None:
            self.monitor.update(r.frame_id, r.dc_px, r.dt_px or 0.0)

    def close(self) -> Dict[str, Any]:
        self._csv_f.close()
        self._events_f.close()
        summary = {"stream": self.name, "frames": self.frames,
                   "burr_events": self.events}
        (self.dir / "summary.json").write_text(json.dumps(summary, indent=2))
        return summary


def serve_streams(model: torch.nn.Module, cfg, named_sources: Sequence[Tuple[str, Any]],
                  output_dir: str, burr_event_px: int = 50,
                  mesh=None, max_batches: Optional[int] = None,
                  max_in_flight: int = 2,
                  device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Serve all streams to completion on `device`, or over `mesh` (every
    rank calls this with the same sources; rank 0 writes the outputs);
    returns the aggregate summary (also written to
    <output>/serve_summary.json), a follower rank its own loop's stats."""
    out = Path(output_dir)
    lead = mesh is None or mesh.rank == 0
    wrap = bool(cfg.geometry.enabled)
    writers = []
    if lead:
        out.mkdir(parents=True, exist_ok=True)
        writers = [StreamWriter(i, name, out, burr_event_px, wrap)
                   for i, (name, _) in enumerate(named_sources)]

    def on_result(r: StreamResult) -> None:
        writers[r.stream_id].on_result(r)

    server = MultiStreamServer(model, cfg, mesh=mesh, max_in_flight=max_in_flight,
                               device=device)
    stats = server.serve([s for _, s in named_sources], on_result,
                         max_batches=max_batches)
    if not lead:
        return stats
    summary = {"streams": [w.close() for w in writers], **stats}
    (out / "serve_summary.json").write_text(json.dumps(summary, indent=2))
    return summary
