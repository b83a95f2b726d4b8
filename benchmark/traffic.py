"""The one traffic generator: a closed loop of calls into a step, its
parameters from the cell's workload file.

  step        "chunked": `stages.build_chunked_step`, each call (chunks,
              batch, H, W, 3) frames; "per_batch": `stages.build_step`,
              each call (batch, H, W, 3)
  inputs      "device": the calls' frames stay on the card; "pinned_host":
              each call takes a pinned host tensor, so its upload is part of
              the call
  distinct    how many distinct call inputs are made from the seed; call i
              takes input i mod distinct
  in_flight   how many calls may be queued on the card: the loop issues a
              call and, once `in_flight` are queued, waits for the oldest

Each call's cable, tape and burr px counts are copied into pinned host
memory behind it; a call is complete when they have reached the host. The
window: calls are issued until `seconds` have passed, then every queued
call is completed; frames/s is all frames completed over the time from
the first issue to the last completion, and each call's latency runs from
its issue to its completion.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch


class Call(NamedTuple):
    index: int
    issued: float      # host clock, seconds
    returned: float    # the step returned (its work enqueued)
    done: float        # its px counts reached the host
    frames: int


class Window(NamedTuple):
    calls: List[Call]
    start: float
    end: float

    @property
    def frames(self) -> int:
        return sum(c.frames for c in self.calls)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def _counts_to_host(out, device):
    """The call's (3, ...) px counts copied into pinned host memory behind
    its work, and an event after the copy (None off the card)."""
    counts = torch.stack((out.cable_px, out.tape_px, out.burr_px))
    if device.type != "cuda":
        return counts, None
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def closed_loop(step: Callable, inputs: Sequence, frames_per_call: int, in_flight: int,
                device: torch.device, seconds: Optional[float] = None,
                calls: Optional[int] = None,
                on_call: Optional[Callable[[int, object], None]] = None) -> Window:
    """Runs the loop for `seconds` of issuing, or for exactly `calls`
    calls. `on_call(i, outputs)`, where given, sees each call's outputs as
    soon as the call is issued (the check keeps its sample from them)."""
    done: List[Call] = []
    queued = deque()

    def complete_oldest():
        i, t_issue, t_ret, host, ev = queued.popleft()
        if ev is not None:
            ev.synchronize()
        done.append(Call(i, t_issue, t_ret, time.perf_counter(), frames_per_call))

    start = time.perf_counter()
    deadline = None if seconds is None else start + seconds
    i = 0
    while (calls is None or i < calls) and (deadline is None or time.perf_counter() < deadline):
        t_issue = time.perf_counter()
        out = step(inputs[i % len(inputs)])
        t_ret = time.perf_counter()
        host, ev = _counts_to_host(out, device)
        queued.append((i, t_issue, t_ret, host, ev))
        if on_call is not None:
            on_call(i, out)
        del out
        i += 1
        while len(queued) >= in_flight:
            complete_oldest()
    while queued:
        complete_oldest()
    return Window(done, start, done[-1].done if done else start)
