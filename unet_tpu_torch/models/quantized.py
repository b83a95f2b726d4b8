"""int8 forward of the custom-encoder NestedUNet, statically calibrated
(counterpart of unet_tpu/models/quantized.py:42-322).

Scheme, as in the JAX package:
  * weights: BN-folded (float32, models/fast_forward.py), the input
    tensor's scale folded in per INPUT channel (decoder concats mix two
    scales), then per-OUTPUT-channel symmetric int8;
  * activations: per-tensor symmetric int8 with static scales from
    `calibrate` (amax / 127 at the model input and after every ReLU, over
    a float32 fast forward);
  * every conv is `ops.qconv_kernels.qconv`: the int8 conv with the
    requant fused (dequant, bias, ReLU and quantize to the next scale as
    one rounding chain in the compute type, bf16 in the pipeline); decoder
    concats travel as (skip, up) pairs that the conv splits along its
    input channels, so no concat is materialised;
  * tensors between layers are NHWC int8; the x2 upsample lerps the codes
    in the compute type and rounds back onto the same scale; the 2x2 max
    pool runs on the codes;
  * the 1x1 head runs in the compute type on the dequantized last tensor.

Division by a constant. The JAX package runs these functions inside its
jitted step, where XLA turns `x / c` for a compile-time constant c into
`x * (1 / c)`, the reciprocal taken in float32 (eager JAX divides). The
port computes that form (`recip32`) wherever the JAX package divides by a
Python float: the weights' `/ 127`, the requant's `s_w / out_scale` and
`b / out_scale`, and the input's `x / scale`. True division differs from
it in the last bit on part of the inputs (tests/test_torch_quantized.py
prints the share), which moves an int8 code where it lands on a rounding
tie.

Not carried over: the phase packing (a TPU workaround that re-lays out the
same products). The unpacked int8 conv gives the same int32 accumulators as
the packed one, so every int8 tensor equals the JAX package's, given the
same scales and weights (tests/test_torch_quantized.py).

Scales travel as a sorted tuple of (tap name, scale) pairs, hashable, so
they live in the frozen pipeline config (`SegmentCfg.int8_scales`);
`pipeline.stages.calibrate_int8` makes a ready config.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch

from unet_tpu_torch.models.blocks import fp32_convs
from unet_tpu_torch.models.fast_forward import (BLOCK_NAMES, cat_nhwc, conv_nhwc,
                                                folded_layers, maxpool2_nhwc,
                                                prepare_fast_params, run_topology, up2x_nhwc,
                                                up2x_rows_nhwc)
from unet_tpu_torch.ops import qconv_kernels
from unet_tpu_torch.ops.image import recip32, upsample2x_align_corners
from unet_tpu_torch.parallel import spatial

# quantize points: the model input + every post-ReLU tensor
TAP_NAMES = ("input",) + tuple(f"{n}.relu{i}" for n in BLOCK_NAMES for i in (1, 2))

Scales = Tuple[Tuple[str, float], ...]


class QLayer(NamedTuple):
    wq: torch.Tensor       # (Cout, 3, 3, Cin) int8, OHWI; input scale folded in
    s_w: torch.Tensor      # (Cout,) float32 per output channel
    b: torch.Tensor        # (Cout,) float32, BN folded
    mult: torch.Tensor     # (Cout,) compute type: s_w / out_scale
    bias: torch.Tensor     # (Cout,) compute type: b / out_scale


class QParams(NamedTuple):
    blocks: Dict[str, Tuple[QLayer, QLayer]]
    final_w: torch.Tensor       # (C0, num_classes), compute type
    final_b: torch.Tensor       # (num_classes,), compute type
    scales: Dict[str, float]    # tap name -> activation scale (amax / 127)
    dtype: torch.dtype          # compute type of the requant, upsample and head


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def observe_amax(state_dict: Mapping[str, torch.Tensor], x: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """One fast-forward pass over (B, H, W, 3) `x` on its device, recording
    |amax| at every quantize point (0-dim float32 tensors)."""
    fp = prepare_fast_params(state_dict, dtype, x.device)
    rec: Dict[str, torch.Tensor] = {}

    def tap(name, t):
        rec[name] = torch.amax(torch.abs(t.to(torch.float32)))
        return t

    def block(name, t):
        l1, l2 = fp.blocks[name]
        y = tap(f"{name}.relu1", torch.relu_(conv_nhwc(t, l1.w, l1.b)))
        return tap(f"{name}.relu2", torch.relu_(conv_nhwc(y, l2.w, l2.b)))

    with fp32_convs():
        run_topology(tap("input", x.to(dtype)), block, maxpool2_nhwc, up2x_nhwc, cat_nhwc)
    return rec


def calibrate(state_dict: Mapping[str, torch.Tensor], batches: Iterable[torch.Tensor],
              dtype: torch.dtype = torch.float32) -> Scales:
    """amax over calibration batches -> hashable (name, scale) tuple with
    scale = max(amax, 1e-8) / 127, sorted by name. The batches are model
    inputs, (B, H, W, 3) in [0, 1]; the fast forward runs on their device."""
    amax: Dict[str, float] = {}
    for x in batches:
        for k, v in observe_amax(state_dict, x, dtype).items():
            amax[k] = max(amax.get(k, 0.0), float(v))
    return tuple(sorted((k, max(v, 1e-8) / 127.0) for k, v in amax.items()))


# ---------------------------------------------------------------------------
# weight preparation
# ---------------------------------------------------------------------------

def _quantize_weights(w: torch.Tensor, s_in: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Cout, Cin, 3, 3) float32 + per-input-channel scale -> (int8 OIHW,
    per-output-channel s_w). s_in is folded in, so acc * s_w[c] + b
    dequantizes exactly."""
    w = w * s_in[None, :, None, None]
    s_w = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=1e-12) * recip32(127.0)
    wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), s_w


def _epilogue(s_w: torch.Tensor, b: torch.Tensor, out_scale: float,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The requant's per-channel multiplier and bias in the compute type
    (unet_tpu/models/quantized.py:216-217)."""
    r = recip32(out_scale)
    return (s_w * r).to(dtype), (b * r).to(dtype)


def qlayer(wq_ohwi: torch.Tensor, s_w: torch.Tensor, b: torch.Tensor, out_scale: float,
           dtype: torch.dtype) -> QLayer:
    mult, bias = _epilogue(s_w, b, out_scale, dtype)
    return QLayer(wq_ohwi.contiguous(), s_w, b, mult, bias)


def _in_scale(name: str, sc: Dict[str, float], widths: Dict[str, int]) -> torch.Tensor:
    """Per-input-channel scale vector feeding block `name`'s conv1 (decoder
    concats mix two source scales)."""
    enc_prev = {"conv1_0": "conv0_0", "conv2_0": "conv1_0",
                "conv3_0": "conv2_0", "conv4_0": "conv3_0"}
    dec = {"conv3_1": ("conv3_0", "conv4_0"), "conv2_2": ("conv2_0", "conv3_1"),
           "conv1_3": ("conv1_0", "conv2_2"), "conv0_4": ("conv0_0", "conv1_3")}
    full = lambda src: torch.full((widths[src],), sc[f"{src}.relu2"], dtype=torch.float32)
    if name == "conv0_0":
        return torch.full((3,), sc["input"], dtype=torch.float32)
    if name in enc_prev:
        return full(enc_prev[name])
    skip, up = dec[name]
    return torch.cat([full(skip), full(up)])


def prepare_int8_params(state_dict: Mapping[str, torch.Tensor], scales: Scales,
                        dtype: torch.dtype = torch.bfloat16, device="cpu") -> QParams:
    """int8 weights and requant epilogues from the port's NestedUNet state
    dict and calibrated `scales`, prepared on the CPU (the same weights for
    every device) and moved to `device`."""
    sc = dict(scales)
    folded = folded_layers(state_dict)
    widths = {name: pair[1][0].shape[0] for name, pair in folded.items()}
    blocks = {}
    for name, pair in folded.items():
        layers = []
        for i, (w, b) in enumerate(pair):
            s_in = (_in_scale(name, sc, widths) if i == 0 else
                    torch.full((w.shape[1],), sc[f"{name}.relu1"], dtype=torch.float32))
            wq, s_w = _quantize_weights(w, s_in)
            l = qlayer(wq.permute(0, 2, 3, 1), s_w, b, sc[f"{name}.relu{i + 1}"], dtype)
            layers.append(QLayer(*(t.to(device) for t in l)))
        blocks[name] = tuple(layers)
    fw = state_dict["final.weight"].detach().cpu()
    return QParams(blocks=blocks,
                   final_w=fw[:, :, 0, 0].T.contiguous().to(device=device, dtype=dtype),
                   final_b=state_dict["final.bias"].detach().to(device=device, dtype=dtype),
                   scales=sc, dtype=dtype)


# ---------------------------------------------------------------------------
# int8 forward
# ---------------------------------------------------------------------------

def _qconv(xq, l: QLayer) -> torch.Tensor:
    """int8 conv -> int32 accumulator (plain; the forward fuses it with
    `_requant` in `qconv_kernels.qconv`). `xq` may be a (skip, up) pair."""
    return qconv_kernels.conv_acc_plain(xq, l.wq)


def _requant(acc: torch.Tensor, l: QLayer) -> torch.Tensor:
    return qconv_kernels.requant_plain(acc, l.mult, l.bias)


def _dequant(xq: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    return xq.to(dtype) * torch.tensor(scale, dtype=dtype)


def _up_int8(xq: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x2 align-corners upsample of NHWC codes: lerp in `dtype`, round back
    to int8 on the same scale (a convex combination cannot leave the
    range)."""
    y = upsample2x_align_corners(xq.to(dtype), 1, 2)
    return torch.clamp(torch.round(y), 0, 127).to(torch.int8)


def _maxpool2_int8(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of NHWC int8 codes (reduce_window VALID)."""
    B, H, W, C = x.shape
    h, w = H // 2, W // 2
    return x[:, :2 * h, :2 * w].reshape(B, h, 2, w, 2, C).amax(dim=(2, 4))


def quantize_input(x: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] -> int8 codes, round half to even:
    x * (1 / scale) in float32, as the jitted JAX step computes x / scale."""
    # a 0-dim CPU tensor is a scalar operand: no host-to-device copy
    r = torch.tensor(recip32(scale), dtype=torch.float32)
    return torch.clamp(torch.round(x.to(torch.float32) * r), -127, 127).to(torch.int8)


def nested_unet_forward_int8(qp: QParams, x: torch.Tensor,
                             taps: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x (B, H, W, 3) float in [0, 1] -> logits (B, H, W, num_classes) in
    `qp.dtype`. `taps`, where given, receives the int8 tensor of every name
    in TAP_NAMES."""
    sc = qp.scales
    tap = (lambda n, t: taps.__setitem__(n, t)) if taps is not None else (lambda n, t: None)
    xq = quantize_input(x, sc["input"])
    tap("input", xq)

    def block(name, t):
        l1, l2 = qp.blocks[name]
        y = qconv_kernels.qconv(t, l1.wq, l1.mult, l1.bias)
        tap(f"{name}.relu1", y)
        y = qconv_kernels.qconv(y, l2.wq, l2.mult, l2.bias)
        tap(f"{name}.relu2", y)
        return y

    y = run_topology(xq, block, _maxpool2_int8, lambda t: _up_int8(t, qp.dtype),
                     lambda a, b: (a, b))
    yd = _dequant(y, sc["conv0_4.relu2"], qp.dtype)
    return torch.matmul(yd, qp.final_w) + qp.final_b


def nested_unet_forward_int8_striped(qp: QParams, x: torch.Tensor, stripes,
                                     taps: Optional[Dict[str, torch.Tensor]] = None
                                     ) -> torch.Tensor:
    """`nested_unet_forward_int8` on an H stripe (parallel.spatial): x (B,
    rows, W, 3) holds the model input's rows [stripes.start, stripes.end);
    returns the logits' same rows. Every int8 tensor equals the whole
    forward's rows bit for bit (qconv's accumulator is exact, its route
    does not depend on H); the logits too on the CPU. Each block's two
    qconvs run on its halo slab, 2 rows each side (a decoder block's skip
    and upsampled halves in one exchange); the upsample slices the global
    tap table at the stripe's rows. `taps`, where given, receives the
    stripe's rows of every int8 tensor of TAP_NAMES. A collective of the
    spatial group."""
    sc = qp.scales
    tap = (lambda n, t: taps.__setitem__(n, t)) if taps is not None else (lambda n, t: None)
    xq = quantize_input(x, sc["input"])
    tap("input", xq)

    def block(name, t):
        l1, l2 = qp.blocks[name]
        srcs = list(t) if isinstance(t, tuple) else [t]
        st = stripes.at(srcs[0].shape[1])
        lo = max(st.start - 2, 0)

        def run(*s):
            y = qconv_kernels.qconv(s if len(s) == 2 else s[0], l1.wq, l1.mult, l1.bias)
            tap(f"{name}.relu1", y.narrow(1, st.start - lo, st.rows))
            return qconv_kernels.qconv(y, l2.wq, l2.mult, l2.bias)

        y = spatial.halo(run, srcs, st, 2, axis=1)
        tap(f"{name}.relu2", y)
        return y

    def up_rows(slab, lo, n, rows):
        y = up2x_rows_nhwc(slab.to(qp.dtype), lo, n, rows)
        return torch.clamp(torch.round(y), 0, 127).to(torch.int8)

    def up(t):
        return spatial.up2x(t, stripes.at(t.shape[1]), 1, up_rows)

    y = run_topology(xq, block, _maxpool2_int8, up, lambda a, b: (a, b))
    yd = _dequant(y, sc["conv0_4.relu2"], qp.dtype)
    return torch.matmul(yd, qp.final_w) + qp.final_b


def int8_apply(state_dict: Mapping[str, torch.Tensor], x: torch.Tensor, scales: Scales,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One-call form: logits = int8_apply(model.state_dict(), frames, scales)."""
    return nested_unet_forward_int8(prepare_int8_params(state_dict, scales, dtype, x.device), x)
