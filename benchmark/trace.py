"""The device trace of a run's traced sub-window, reduced to plain
records that the metric readers take.

`torch.profiler` (CPU and CUDA activity) records the calls; `records`
turns its events into `Event`s: the device's kernels, copies and sets by
name with their intervals, and the host's operations with theirs. The
reductions (`busy`, `by_name`, `idle_gaps`) work on those records alone,
so they are tested on synthetic ones.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float
    device: bool       # True: ran on the card; False: a host operation


class Trace(NamedTuple):
    events: List[Event]
    start_us: float    # the traced window
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def device_events(self) -> List[Event]:
        return [e for e in self.events if e.device]


def _merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds in which some operation ran on the device: the union of the
    device events' intervals, clipped to the window."""
    iv = [(max(e.start_us, trace.start_us), min(e.end_us, trace.end_us))
          for e in trace.device_events()]
    return sum(e - s for s, e in _merged([x for x in iv if x[1] > x[0]])) / 1e6


def by_name(trace: Trace, match: str = "") -> Dict[str, Tuple[float, int]]:
    """{kernel name: (device seconds, launches)} of the device events whose
    name contains `match`."""
    out: Dict[str, Tuple[float, int]] = {}
    for e in trace.device_events():
        if match in e.name:
            t, n = out.get(e.name, (0.0, 0))
            out[e.name] = (t + (e.end_us - e.start_us) / 1e6, n + 1)
    return out


def idle_gaps(trace: Trace, named: int = 1000) -> Dict[str, float]:
    """{what the host was doing: idle device seconds}: the gaps between the
    device's busy intervals inside the window. Each of the `named` longest
    is named by the innermost host operation open across its middle ("(no
    host operation)" where none is); the shorter ones add up under
    "(shorter gaps)"."""
    busy = _merged([(e.start_us, e.end_us) for e in trace.device_events()])
    edges = [trace.start_us] + [x for iv in busy for x in iv] + [trace.end_us]
    gaps = [(max(edges[k], trace.start_us), min(edges[k + 1], trace.end_us))
            for k in range(0, len(edges) - 1, 2)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
    host = [e for e in trace.events if not e.device]
    starts = np.array([h.start_us for h in host])
    ends = np.array([h.end_us for h in host])
    spans = ends - starts
    out: Dict[str, float] = {}
    for k, (s, e) in enumerate(gaps):
        if k >= named:
            name = "(shorter gaps)"
        else:
            mid = (s + e) / 2
            open_ = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (host[open_[np.argmin(spans[open_])]].name if open_.size
                    else "(no host operation)")
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled() -> Iterator[list]:
    """Profile the block (CPU and CUDA activity); the yielded list holds
    the block's `Trace` once the block has ended. The card's queue is
    drained inside the block's profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield box
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    box.append(records(prof))


def records(prof) -> Trace:
    """The profiler's events as `Event`s; the window runs from the first
    event's start to the last one's end."""
    events = []
    for e in prof.events():
        dev = str(getattr(e, "device_type", "")).endswith("CUDA")
        tr = e.time_range
        events.append(Event(e.name, float(tr.start), float(tr.end), dev))
    if not events:
        return Trace([], 0.0, 0.0)
    return Trace(events, min(e.start_us for e in events), max(e.end_us for e in events))
