"""Tracing and stage timing (counterpart of unet_tpu/core/profiling.py).

The reference's only observability is wall-clock FPS counters
(infer_two_stage_burr.py:267-371). Here: a torch.profiler device trace
(`device_trace`) and a light per-stage wall-clock aggregator for host loops
(`StageTimer`); the on-frame FPS HUD is pipeline.visualize.draw_hud.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Trace a block with torch.profiler, the card's kernels included where
    there is a card, and write it to `log_dir` as a `*.pt.trace.json` file
    that TensorBoard's profiler plugin and Perfetto read:

        with device_trace("traces/run1"):
            for batch in ...:
                step(batch)

    The card's queue is drained before the trace stops, so that every kernel
    launched inside the block is in it. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()


class StageTimer:
    """Per-stage wall-clock aggregation for host-side loops.

        timer = StageTimer()
        with timer("decode"): ...
        with timer("device_step"): ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        lines = []
        for stage in sorted(self.totals, key=lambda s: -self.totals[s]):
            total = self.totals[stage]
            n = max(self.counts[stage], 1)
            lines.append(f"{stage:<20s} {total:8.3f}s total "
                         f"{total / n * 1000:8.2f} ms/call x{n}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {s: {"total_sec": self.totals[s], "calls": self.counts[s]}
                for s in self.totals}
