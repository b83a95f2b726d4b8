"""Shares of the card's peaks that the metric readers share: the model's
share of the tensor-core peak (`step_mfu`), a kernel's share of its
roofline, the device's idle share."""
from __future__ import annotations

from typing import Optional

from . import bounds, nested_unet, peaks

QCONV_PER_BATCH = 18     # the int8 forward's 3x3 convs, one qconv launch each


def model_hw(config: dict):
    w, h = config["pipeline"]["preprocess"]["model_size"]
    return h, w


def step_mfu(run) -> float:
    """Percent of the card's dense tensor peak that the window's frames/s
    needs for the model alone: the 18 3x3 convs at the cell's precision's
    peak and the 1x1 head at bf16's, as the least seconds a frame, times
    frames/s."""
    convs, head = nested_unet.frame_ops(run.spec.config["model"], model_hw(run.spec.config))
    least = (convs / peaks.TENSOR_OPS_PER_S[run.spec.workload["precision"]]
             + head / peaks.TENSOR_OPS_PER_S["bf16"])
    return 100.0 * least * run.window.frames / run.window.seconds


def _kernel_seconds(run, match: str):
    from .. import trace
    found = trace.by_name(run.trace, match) if run.trace is not None else {}
    return sum(t for t, _ in found.values()), sum(n for _, n in found.values())


def qconv_roofline(run) -> Optional[float]:
    """Percent: the qconv launches' bounds (the 18 main-path convs at the
    cell's batch, as many batches as the trace holds launches) over the
    summed device time of the `qconv*` kernels. None where the trace holds
    no qconv launch or a count that is not whole batches."""
    seconds, n = _kernel_seconds(run, "qconv")
    if n == 0 or n % QCONV_PER_BATCH:
        return None
    cs = [c for c in nested_unet.convs(run.spec.config["model"], model_hw(run.spec.config))
          if c.k == 3]
    bound_ms = sum(bounds.qconv_bound_ms(c, run.spec.workload["batch"])[0] for c in cs)
    return 100.0 * (n // QCONV_PER_BATCH) * bound_ms / 1e3 / seconds


def idle_share(run) -> Optional[float]:
    """Percent of the traced window in which nothing ran on the device."""
    from .. import trace
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.trace.window_s)
