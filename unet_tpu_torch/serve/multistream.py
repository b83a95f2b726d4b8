"""Multi-stream batched serving: N video or camera streams through one step
(counterpart of unet_tpu/serve/multistream.py).

Reader threads decode each stream into its own queue; the serving loop
assembles batches with one fixed slot per stream, runs the port's step
(`stages.build_step`) on `device`, and hands each fresh frame's result back
as a `StreamResult`. With `geometry.enabled` (the wrap-uniformity presets)
each result carries the frame's cable and tape diameters in pixels.

Not ported: serving over a device mesh (`mesh`, ROADMAP A15).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from unet_tpu_torch.pipeline import stages
from unet_tpu_torch.pipeline.config import PipelineCfg


@dataclass
class StreamResult:
    stream_id: int
    frame_id: int
    cable_px: int
    tape_px: int
    burr_px: int
    class_map: Optional[np.ndarray] = None
    # filled when the pipeline has geometry enabled (wrap-uniformity serving)
    dc_px: Optional[float] = None
    dt_px: Optional[float] = None


class MultiStreamServer:
    """The batch size is FIXED at len(sources) for a whole serve() call:
    slots of exhausted or starved streams are padded with that stream's last
    frame (zeros before its first) and their outputs discarded. A starved
    stream delays its slot by at most `starvation_timeout` seconds per
    batch; it never stalls the batch. The step runs on `device` ("cuda"
    unless the caller asks for the CPU; without a card a "cuda" server
    raises, as `build_step` does)."""

    def __init__(self, model: torch.nn.Module, cfg: PipelineCfg,
                 mesh=None, return_class_map: bool = False,
                 queue_depth: int = 8, starvation_timeout: float = 0.02,
                 max_in_flight: int = 2, device: Union[str, torch.device] = "cuda"):
        if mesh is not None:
            raise NotImplementedError("MultiStreamServer(mesh=...): serving over a "
                                      "device mesh is ROADMAP A15")
        self.cfg = cfg
        self.return_class_map = return_class_map
        self.step = stages.build_step(model, cfg, device=device)
        self.queue_depth = queue_depth
        self.starvation_timeout = starvation_timeout
        # dispatched but unconsumed batches: the step queues its work on the
        # card and returns, so keeping a couple in flight overlaps host batch
        # assembly with device compute
        self.max_in_flight = max(int(max_in_flight), 1)
        self._queues: List[queue.Queue] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    def _put(self, q: queue.Queue, item) -> bool:
        """Stop-aware put: a reader must never wedge on a full queue after
        the serving loop exits (max_batches early exit, on_result exception):
        that would leak the thread and its open source."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _reader(self, stream_id: int, source) -> None:
        q = self._queues[stream_id]
        for frame_id, frame in source.frames():
            if self._stop.is_set() or not self._put(q, (frame_id, frame)):
                break
        self._put(q, None)  # exhausted

    def serve(self, sources: Sequence[Any],
              on_result: Callable[[StreamResult], None],
              max_batches: Optional[int] = None) -> Dict[str, Any]:
        """Run until every source is exhausted. `sources` expose .frames(),
        yielding (frame_id, (H, W, 3) uint8 BGR frame). Returns summary
        stats."""
        n = len(sources)
        self._stop.clear()  # serve() is reusable (e.g. warmup then measure)
        self._queues = [queue.Queue(maxsize=self.queue_depth) for _ in range(n)]
        self._threads = [threading.Thread(target=self._reader, args=(i, s),
                                          daemon=True)
                         for i, s in enumerate(sources)]
        for t in self._threads:
            t.start()

        live = [True] * n                              # reader still producing
        pending: List[Optional[tuple]] = [None] * n    # fetched, unprocessed
        last: List[Optional[np.ndarray]] = [None] * n  # pad for starved slots
        in_flight: deque = deque()                     # (fresh_meta, out)
        processed = 0
        batches = 0

        def consume(fresh_meta, out) -> None:
            nonlocal processed
            host = lambda t: t.cpu().numpy()
            cable, tape, burr = host(out.cable_px), host(out.tape_px), host(out.burr_px)
            cmap = host(out.class_map) if self.return_class_map else None
            dc = dt_ = None
            if out.diameters is not None:
                dc, dt_ = host(out.diameters.dc_px), host(out.diameters.dt_px)
            for i, fid in fresh_meta:  # padded slots' outputs are dropped
                on_result(StreamResult(
                    stream_id=i, frame_id=fid,
                    cable_px=int(cable[i]), tape_px=int(tape[i]),
                    burr_px=int(burr[i]),
                    class_map=cmap[i] if cmap is not None else None,
                    dc_px=None if dc is None else float(dc[i]),
                    dt_px=None if dt_ is None else float(dt_[i])))
                processed += 1

        t0 = time.time()
        try:
            while True:
                # fetch at most one frame per stream; a starved stream gets a
                # bounded wait and is then padded, never blocking the batch
                for i in range(n):
                    if not live[i] or pending[i] is not None:
                        continue
                    try:
                        item = self._queues[i].get(
                            timeout=self.starvation_timeout)
                    except queue.Empty:
                        continue
                    if item is None:
                        live[i] = False
                    else:
                        pending[i] = item
                fresh = [i for i in range(n) if pending[i] is not None]
                if not fresh:
                    if not any(live):
                        break
                    continue  # every live stream starved this round; retry
                # fixed-size batch: slot i always belongs to stream i;
                # non-fresh slots repeat the stream's last frame (zeros
                # before its first)
                template = pending[fresh[0]][1]
                slots = [pending[i][1] if pending[i] is not None
                         else (last[i] if last[i] is not None
                               else np.zeros_like(template))
                         for i in range(n)]
                out = self.step(np.stack(slots))
                fresh_meta = []
                for i in fresh:
                    fid, frame = pending[i]
                    fresh_meta.append((i, fid))
                    last[i] = frame
                    pending[i] = None
                # results are read max_in_flight batches behind submission
                in_flight.append((fresh_meta, out))
                if len(in_flight) > self.max_in_flight:
                    consume(*in_flight.popleft())
                batches += 1
                if max_batches is not None and batches >= max_batches:
                    break
            while in_flight:
                consume(*in_flight.popleft())
        finally:
            # always unwedge and reap the readers, also when on_result
            # raised or max_batches cut the loop short mid-stream
            self._stop.set()
            for t in self._threads:
                t.join(timeout=10.0)
        dt = time.time() - t0
        return {"frames": processed, "batches": batches,
                "elapsed_sec": round(dt, 3),
                "fps": round(processed / dt, 2) if dt > 0 else 0.0}
