"""The least time a kernel launch could take on the card, from the work
its inputs need: the larger of its operations over the peak rate and its
bytes over the HBM rate. Copies of the port's own counts
(`chip_smoke._qconv_bound_ms`, `_nlm_weight_pairs`, `_nlm_bound_ms`),
taken from shapes, so that they serve the trace of a run."""
from __future__ import annotations

from typing import Dict, Tuple

from . import peaks
from .nested_unet import Conv


def qconv_bound_ms(conv: Conv, batch: int, mult_bytes: int = 2) -> Tuple[float, str]:
    """Least time for one qconv launch, and what bounds it: the 2 M N 9 C
    int8 operations at the dense int8 tensor rate, or the bytes (each input
    read once, the weights and the epilogue once, the int8 output written
    once) at the HBM rate. `mult_bytes`: the size of the epilogue's
    per-channel multiplier and bias (the compute type, bf16)."""
    H, W = conv.hw
    cin, N = sum(conv.cin), conv.cout
    ops = 2 * batch * H * W * N * 9 * cin
    nbytes = batch * H * W * cin + N * 9 * cin + batch * H * W * N + 2 * N * mult_bytes
    ops_ms = ops / peaks.TENSOR_OPS_PER_S["int8"] * 1e3
    bytes_ms = nbytes / peaks.MEM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def nlm_weight_pairs(shape: Tuple[int, int, int], search: int) -> Tuple[int, int]:
    """(pairs, updates) of NLM on a (B, H, W) stack: `updates` counts the
    pixel-offsets that update an output, B*H*W*(search^2 - 1), the centre
    left out (its weight is exp(0) = 1). Every other weight is symmetric:
    d2(p, o) sums the same squares as d2(p + o, -o), so one weight serves
    the unordered pair {p, p + o}. `pairs` counts those pairs: the
    (H - |dy|)(W - |dx|) pixel-offsets with both ends inside the plane come
    twice among the updates, the border ones whose other end lies in the
    reflect pad once."""
    B, H, W = shape
    r = search // 2
    updates = B * H * W * (search * search - 1)
    inside = B * ((search * H - r * (r + 1)) * (search * W - r * (r + 1)) - H * W)
    return updates - inside // 2, updates


def nlm_bound_ms(shape: Tuple[int, int, int], search: int, sms: int,
                 clock_hz: float) -> Tuple[float, str, Dict[str, float]]:
    """Least time for one NLM launch on a float32 (B, H, W) stack, and what
    bounds it (`nlm_weight_pairs` counts the work). Per weight pair: one
    exp at the SFU rate (16 per SM per clock at `clock_hz`) and 7 fp32
    operations (the difference, its square, a running box sum of one add
    and one subtract per axis, the scale); per update, 3 more (num += w * x
    as one FMA of 2 operations, den += w), all at the fp32 peak; each input
    byte read once and each output byte written once at the HBM rate.
    Returns (ms, "bytes" or "operations", the three times)."""
    pairs, updates = nlm_weight_pairs(shape, search)
    n = shape[0] * shape[1] * shape[2]
    parts = {
        "bytes": 2 * n * 4 / peaks.MEM_BYTES_PER_S * 1e3,
        "fp32": (7 * pairs + 3 * updates) / peaks.FP32_OPS_PER_S * 1e3,
        "exp": pairs / (sms * peaks.SFU_PER_SM_PER_CLOCK * clock_hz) * 1e3,
    }
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts
