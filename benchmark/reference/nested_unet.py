"""The NestedUNet (UNet++, Zhou et al., arXiv:1807.10165; the reference
repository's src/models/unetpp.py:29-46) in plain PyTorch, from its state
dict: per block conv3x3 -> BatchNorm (running statistics, eps 1e-5) ->
ReLU, twice; 2x2 max pools down the encoder; the decoder chain x3_1 ->
x2_2 -> x1_3 -> x0_4 with `[skip, up]` concatenation and a bilinear x2
upsample with aligned corners; the 1x1 `final` head (the eval forward's
output). Float32 with TF32 off (`forward` pins both flags and restores
them).

`forward(..., quant=...)` is the control: the same forward with the
BN-folded weights quantized per output channel and every conv's input
(the model input and each ReLU's output) quantized per tensor, both
symmetric to `quant.bits` bits, on scales that `calibrate` measures with
the float32 forward.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, NamedTuple, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5
DECODER = (("conv3_1", "x3_0", "x4_0"), ("conv2_2", "x2_0", "x3_1"),
           ("conv1_3", "x1_0", "x2_2"), ("conv0_4", "x0_0", "x1_3"))


class Quant(NamedTuple):
    bits: int
    amax: Dict[str, float]      # conv input name -> calibrated absolute max


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fake_quant(x: torch.Tensor, amax: float, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = max(amax, 1e-12) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def _conv_bn_relu(sd, name: str, x: torch.Tensor, quant: Optional[Quant], seen) -> torch.Tensor:
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    block, conv = name.rsplit(".", 1)
    bn = f"{block}.bn{conv[-1]}"
    g, beta = sd[f"{bn}.weight"], sd[f"{bn}.bias"]
    mean, var = sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"]
    if seen is not None:
        seen[name] = max(seen.get(name, 0.0), float(x.abs().amax()))
    if quant is None:
        y = F.batch_norm(F.conv2d(x, w, b, padding=1), mean, var, g, beta, False, 0.0, EPS)
        return F.relu(y)
    mul = g / torch.sqrt(var + EPS)
    wf = w * mul[:, None, None, None]
    bf = (b - mean) * mul + beta
    wmax = wf.abs().amax(dim=(1, 2, 3))
    qmax = 2 ** (quant.bits - 1) - 1
    ws = (torch.clamp(wmax, min=1e-12) / qmax)[:, None, None, None]
    wq = torch.clamp(torch.round(wf / ws), -qmax, qmax) * ws
    xq = _fake_quant(x, quant.amax[name], quant.bits)
    return F.relu(F.conv2d(xq, wq, bf, padding=1))


def _block(sd, name, x, quant, seen):
    x = _conv_bn_relu(sd, f"{name}.conv1", x, quant, seen)
    return _conv_bn_relu(sd, f"{name}.conv2", x, quant, seen)


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def features(sd: Dict[str, torch.Tensor], x: torch.Tensor, quant: Optional[Quant] = None,
             seen: Optional[dict] = None) -> torch.Tensor:
    """(B, 3, h, w) float32 input in [0, 1] -> x0_4, the (B, nb_filter[0],
    h, w) features that the head reads. `seen`, where given, collects each
    conv input's absolute max."""
    with full_fp32(), torch.inference_mode():
        t = {"x0_0": _block(sd, "conv0_0", x, quant, seen)}
        for i in range(1, 5):
            t[f"x{i}_0"] = _block(sd, f"conv{i}_0", F.max_pool2d(t[f"x{i - 1}_0"], 2, 2),
                                  quant, seen)
        for name, skip, low in DECODER:
            t["x" + name[4:]] = _block(sd, name, torch.cat([t[skip], _up(t[low])], 1), quant, seen)
        return t["x0_4"]


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Optional[Quant] = None) -> torch.Tensor:
    """(B, 3, h, w) float32 input in [0, 1] -> (B, classes, h, w) float32
    logits."""
    with full_fp32(), torch.inference_mode():
        return F.conv2d(features(sd, x, quant), sd["final.weight"], sd["final.bias"])


def calibrate(sd: Dict[str, torch.Tensor], inputs: Iterable[torch.Tensor], bits: int) -> Quant:
    """The control's scales: each conv input's absolute max over the float32
    forward of `inputs`, as the port's own calibration observes its taps."""
    seen: Dict[str, float] = {}
    for x in inputs:
        features(sd, x, seen=seen)
    return Quant(bits, seen)
