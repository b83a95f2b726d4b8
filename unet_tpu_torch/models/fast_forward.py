"""BN-folded fast forward of the custom-encoder NestedUNet (counterpart of
unet_tpu/models/fast_forward.py:47-74, 144-235).

What it computes: BatchNorm (inference) folded into the preceding conv in
float32, then the eval-mode forward in the compute dtype (bf16 in the
pipeline, float32 for calibration), with the plain 1x1 head. NHWC at the
public functions, as in the JAX package: `fast_apply(state_dict, x)` takes
(B, H, W, 3) and returns (B, H, W, num_classes) logits in the compute dtype.

Not carried over: the phase packing of the lane-starved layers (`_pack3x3`,
`unpack_phases`, `phase_max`, `PACK_MAX_COUT`), a TPU workaround that only
re-lays out the same products; the layers run as plain 3x3 convs.

Where the two frameworks round differently, and what the port does:
  * bias: JAX rounds the conv to the compute dtype, then adds the bias and
    rounds again (`_conv`); the port passes the bias to F.conv2d, which
    adds it before the one rounding of the conv's output.
  * decoder concat: JAX adds two float32 partial convs and rounds once
    (`_conv_cat_free`); the port runs one conv over the concatenated input,
    which also rounds once. Two bf16 convs added together would round
    twice.
  * upsample: `ops.image.upsample2x_align_corners`, bit-identical to the
    JAX package's in bf16.
In float32 the forward stays within the JAX package's own gate of its fast
forward against the flax model (rtol/atol 2e-4); in bf16 the class maps
agree on > 0.995 of the pixels (tests/test_torch_fast_forward.py). On the
card a float32 forward runs inside `models.blocks.fp32_convs` (the caller's
`stages.forward_logits`, or `quantized.observe_amax`), or cuDNN's TF32 moves it
outside the gate.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from unet_tpu_torch.ops.image import upsample2x_align_corners, upsample2x_align_corners_rows
from unet_tpu_torch.parallel import spatial

BLOCK_NAMES = ("conv0_0", "conv1_0", "conv2_0", "conv3_0", "conv4_0",
               "conv3_1", "conv2_2", "conv1_3", "conv0_4")


class FastLayer(NamedTuple):
    w: torch.Tensor      # (Cout, Cin, 3, 3), BN folded, compute dtype, channels_last
    b: torch.Tensor      # (Cout,), compute dtype


class FastParams(NamedTuple):
    """BN-folded inference weights in the compute dtype."""
    blocks: Dict[str, Tuple[FastLayer, FastLayer]]
    final_w: torch.Tensor     # (num_classes, C0, 1, 1)
    final_b: torch.Tensor
    dtype: torch.dtype


def _fold_bn(w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into the preceding (Cout, Cin, kh, kw) conv,
    in float32: y = gamma * (conv(x) + b - mean) / sqrt(var + eps) + beta."""
    f = lambda t: t.to(torch.float32)
    scale = f(gamma) * torch.rsqrt(f(var) + eps)
    return f(w) * scale[:, None, None, None], (f(b) - f(mean)) * scale + f(beta)


def folded_layers(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Tuple[Tuple[torch.Tensor, torch.Tensor], ...]]:
    """{block: ((w1, b1), (w2, b2))}: each conv of each block with its BN
    folded in, float32, (Cout, Cin, 3, 3), on the CPU (so that every device
    gets the same weights), from the port's NestedUNet state dict."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    out = {}
    for name in BLOCK_NAMES:
        pair = []
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            w = sd[f"{name}.{conv}.weight"]
            b = sd.get(f"{name}.{conv}.bias", torch.zeros(w.shape[0]))
            pair.append(_fold_bn(w, b, sd[f"{name}.{bn}.weight"], sd[f"{name}.{bn}.bias"],
                                 sd[f"{name}.{bn}.running_mean"],
                                 sd[f"{name}.{bn}.running_var"]))
        out[name] = tuple(pair)
    return out


def prepare_fast_params(state_dict: Mapping[str, torch.Tensor],
                        dtype: torch.dtype = torch.bfloat16,
                        device="cpu") -> FastParams:
    """Fold BN (float32, on the CPU), cast to `dtype` and move to `device`."""
    to = lambda t: t.to(device=device, dtype=dtype)
    blocks = {name: tuple(FastLayer(to(w).contiguous(memory_format=torch.channels_last),
                                    to(b)) for w, b in pair)
              for name, pair in folded_layers(state_dict).items()}
    return FastParams(blocks=blocks, final_w=to(state_dict["final.weight"].detach()),
                      final_b=to(state_dict["final.bias"].detach()), dtype=dtype)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Same-padded conv of an NHWC tensor with (Cout, Cin, k, k) weights:
    the NCHW view of a contiguous NHWC tensor is channels_last, which cuDNN
    takes as it is and returns, so both permutes are views."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def maxpool2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of an NHWC tensor (reduce_window VALID)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def up2x_nhwc(x: torch.Tensor) -> torch.Tensor:
    return upsample2x_align_corners(x, 1, 2)


def run_topology(x, block: Callable, pool: Callable, up: Callable, cat: Callable):
    """The UNet++ wiring of the JAX package's forwards (reference
    src/models/unetpp.py:93-135; unet_tpu/models/quantized.py:234-274
    without packing): the encoder chain and the plain-chain decoder.
    `block(name, t)` runs a block's two convs; `cat(skip, up)` makes the
    input of a decoder block (a concat, or a pair the conv splits)."""
    x0_0 = block("conv0_0", x)
    x1_0 = block("conv1_0", pool(x0_0))
    x2_0 = block("conv2_0", pool(x1_0))
    x3_0 = block("conv3_0", pool(x2_0))
    x4_0 = block("conv4_0", pool(x3_0))
    x3_1 = block("conv3_1", cat(x3_0, up(x4_0)))
    x2_2 = block("conv2_2", cat(x2_0, up(x3_1)))
    x1_3 = block("conv1_3", cat(x1_0, up(x2_2)))
    return block("conv0_4", cat(x0_0, up(x1_3)))


def cat_nhwc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A decoder concat [skip, up] along the channels of NHWC tensors."""
    return torch.cat([a, b], dim=-1)


def nested_unet_forward_fast(fp: FastParams, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward, (B, H, W, 3) -> (B, H, W, num_classes) logits in
    `fp.dtype`."""
    def block(name, t):
        l1, l2 = fp.blocks[name]
        y = torch.relu_(conv_nhwc(t, l1.w, l1.b))
        return torch.relu_(conv_nhwc(y, l2.w, l2.b))

    y = run_topology(x.to(fp.dtype), block, maxpool2_nhwc, up2x_nhwc, cat_nhwc)
    return conv_nhwc(y, fp.final_w, fp.final_b)


def nested_unet_forward_fast_striped(fp: FastParams, x: torch.Tensor,
                                     stripes) -> torch.Tensor:
    """`nested_unet_forward_fast` on an H stripe (parallel.spatial): x (B,
    rows, W, 3) holds the model input's rows [stripes.start, stripes.end);
    returns the logits' same rows, equal to the whole forward's on one
    device bit for bit (on the CPU; cuDNN may pick another algorithm for a
    stripe's shape). Each block's two convs run on its halo slab, 2 rows
    each side; the upsample slices the global tap table at the stripe's
    rows (`ops.image.upsample2x_align_corners_rows`). A collective of the
    spatial group."""
    def block(name, t):
        l1, l2 = fp.blocks[name]

        def run(s):
            return torch.relu_(conv_nhwc(torch.relu_(conv_nhwc(s, l1.w, l1.b)), l2.w, l2.b))

        return spatial.halo(run, [t], stripes.at(t.shape[1]), 2, axis=1)

    def up(t):
        return spatial.up2x(t, stripes.at(t.shape[1]), 1, up2x_rows_nhwc)

    y = run_topology(x.to(fp.dtype), block, maxpool2_nhwc, up, cat_nhwc)
    return conv_nhwc(y, fp.final_w, fp.final_b)


def up2x_rows_nhwc(slab: torch.Tensor, lo: int, n: int, rows) -> torch.Tensor:
    """Rows `rows` of `up2x_nhwc` of an n-row plane from its rows [lo, ...)."""
    return upsample2x_align_corners_rows(slab, lo, n, rows, 1, 2)


def fast_apply(state_dict: Mapping[str, torch.Tensor], x: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One-call form: logits = fast_apply(model.state_dict(), frames)."""
    return nested_unet_forward_fast(prepare_fast_params(state_dict, dtype, x.device), x)
