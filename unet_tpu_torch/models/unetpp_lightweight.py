"""Lightweight UNet++ with pluggable encoders (counterpart of
unet_tpu/models/unetpp_lightweight.py; reference
src/models/unetpp_lightweight.py:33-284).

Encoders: custom (NestedUNet's ConvBlocks with pooling between stages),
resnet18, resnet34 (models.resnet), mobilenet_v3_small, mobilenet_v3_large
(models.mobilenet), shufflenet_v2_x1_0 (models.shufflenet), under the key
prefix `encoder.`; the decoder's widths are chosen per encoder, its
concatenation is `[skip, up]`, and the deep-supervision heads run only in
train mode. The logits come out at the resolution of the encoder's first
stage: the input's for `custom`, a quarter of it for the resnets,
mobilenet_v3_small and shufflenet, half for mobilenet_v3_large.

On H stripes of the mesh's spatial axis (`striped_compute`; the stripes'
bounds on multiples of `stripe_unit`, the encoder's total stride): the
encoder's own `striped`, the decoder's ConvBlocks on their halo slabs, the
upsample from the global source rows of its taps, deciding on the global
heights as `_up_to` does on shapes. Eval mode for every encoder; train mode
(the deep-supervision heads resized to the input on their stripes) for
`custom`, the one whose logits keep the input's size.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn

from unet_tpu_torch.models.blocks import ComputeDtype, ConvBlock, max_pool2, on_stripes
from unet_tpu_torch.ops.image import (resize_bilinear_align_corners,
                                      resize_bilinear_align_corners_rows,
                                      upsample2x_align_corners, upsample2x_align_corners_rows)
from unet_tpu_torch.parallel import spatial

# the reference's channel table (unet_tpu/models/unetpp_lightweight.py:22-29);
# mobilenet_v3_large's fourth and shufflenet's fifth entries are not what those
# encoders return (80 and 464), so the decoder is built from each encoder's
# own `out_channels`
ENCODER_CHANNELS = {
    "mobilenet_v3_small": (16, 24, 40, 48, 576),
    "mobilenet_v3_large": (16, 24, 40, 112, 960),
    "shufflenet_v2_x1_0": (24, 116, 232, 464, 1024),
    "resnet18": (64, 64, 128, 256, 512),
    "resnet34": (64, 64, 128, 256, 512),
    "custom": (32, 64, 128, 256, 512),
}

# (total stride: the stripes' unit, the input's side over the logits') per encoder
ENCODER_STRIDES = {
    "custom": (16, 1), "resnet18": (32, 4), "resnet34": (32, 4),
    "mobilenet_v3_small": (32, 4), "mobilenet_v3_large": (32, 2),
    "shufflenet_v2_x1_0": (64, 4),
}

DEFAULT_DECODER_CHANNELS = {
    "mobilenet_v3_small": (16, 24, 40, 80),
    "mobilenet_v3_large": (24, 40, 80, 160),
    "shufflenet_v2_x1_0": (32, 64, 128, 256),
}


def default_decoder_channels(encoder: str) -> Sequence[int]:
    """Auto decoder widths (reference unetpp_lightweight.py:96-106)."""
    return DEFAULT_DECODER_CHANNELS.get(encoder, (64, 128, 256, 512))


class _CustomEncoder(nn.Module):
    """Five ConvBlocks with a 2x2 max pool between stages
    (unet_tpu/models/unetpp_lightweight.py:42-62: the reference chains them
    without pooling; the JAX package pools to make `custom` usable)."""
    out_channels = ENCODER_CHANNELS["custom"]

    def __init__(self):
        super().__init__()
        ch = self.out_channels
        for i in range(5):
            setattr(self, f"enc{i}", ConvBlock(3 if i == 0 else ch[i - 1], ch[i]))

    def forward(self, x: torch.Tensor, st=None):
        run = (lambda m, t: m(t)) if st is None else (lambda m, t: m.striped(t, st))
        feats = [run(self.enc0, x)]
        for i in range(1, 5):
            feats.append(run(getattr(self, f"enc{i}"), max_pool2(feats[-1])))
        return tuple(feats)

    def striped(self, x: torch.Tensor, st):
        return self(x, st)


def _make_encoder(encoder: str) -> nn.Module:
    if encoder == "custom":
        return _CustomEncoder()
    if encoder in ("resnet18", "resnet34"):
        from unet_tpu_torch.models.resnet import ResNetBasicEncoder
        return ResNetBasicEncoder((2, 2, 2, 2) if encoder == "resnet18" else (3, 4, 6, 3))
    if encoder.startswith("mobilenet_v3"):
        from unet_tpu_torch.models.mobilenet import MobileNetV3Encoder
        return MobileNetV3Encoder(encoder.replace("mobilenet_v3_", ""))
    from unet_tpu_torch.models.shufflenet import ShuffleNetV2Encoder
    return ShuffleNetV2Encoder()


def _up_to(t: torch.Tensor, hw) -> torch.Tensor:
    """t (B, C, h, w) at the skip's size `hw` (unetpp_lightweight.py:89-101):
    unchanged where the sizes match (mobilenet_v3_small's stages 3 and 4
    share stride 16), the exact x2 align-corners upsample where the skip is
    twice the size, else the align-corners resize."""
    h, w = t.shape[2:]
    if (h, w) == tuple(hw):
        return t
    if tuple(hw) == (2 * h, 2 * w):
        return upsample2x_align_corners(t, 2, 3)
    return resize_bilinear_align_corners(t, hw, 2, 3)


def _up_to_striped(t: torch.Tensor, skip: torch.Tensor, st: spatial.Stripes) -> torch.Tensor:
    """`_up_to(t, skip.shape[2:])` on H stripes: the choice made on the
    global heights of the source and the skip, the rows of this rank's
    stripe from the global source rows of their taps."""
    src = st.at(t.shape[2])
    h, H, W = src.height, st.at(skip.shape[2]).height, skip.shape[3]
    if (h, t.shape[3]) == (H, W):
        return t
    if (H, W) == (2 * h, 2 * t.shape[3]):
        return spatial.up2x(t, src, 2, lambda slab, lo, n, rows:
                            upsample2x_align_corners_rows(slab, lo, n, rows, 2, 3))
    return _resize_rows(t, src, H // h, W)


def _resize_rows(t: torch.Tensor, src: spatial.Stripes, scale: int, W: int) -> torch.Tensor:
    """This rank's rows of `resize_bilinear_align_corners` of the striped `t`
    to (scale x its global height, W)."""
    return spatial.resize_rows(t, src, scale, 2, lambda slab, lo, n, out, rows:
                               resize_bilinear_align_corners_rows(slab, lo, n, out, rows, W,
                                                                  2, 3))


class LightweightNestedUNet(ComputeDtype):
    """`dtype` is the compute type (models.blocks.ComputeDtype). In eval mode
    the forward returns the logits; in train mode with deep supervision
    [out, ds1_3, ds2_2, ds3_1], the heads resized to the input's size."""

    def __init__(self, num_classes: int, encoder: str = "mobilenet_v3_small",
                 deep_supervision: bool = False,
                 decoder_channels: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder not in ENCODER_CHANNELS:
            raise ValueError(f"unsupported encoder {encoder!r}")
        self.encoder_name = encoder
        self.deep_supervision = deep_supervision
        self.encoder = _make_encoder(encoder)
        e = self.encoder.out_channels
        dec = tuple(decoder_channels or default_decoder_channels(encoder))
        self.conv3_1 = ConvBlock(e[3] + e[4], dec[3])
        self.conv2_2 = ConvBlock(e[2] + dec[3], dec[2])
        self.conv1_3 = ConvBlock(e[1] + dec[2], dec[1])
        self.conv0_4 = ConvBlock(e[0] + dec[1], dec[0])
        self.final = nn.Conv2d(dec[0], num_classes, 1)
        if deep_supervision:
            self.ds3_1 = nn.Conv2d(dec[3], num_classes, 1)
            self.ds2_2 = nn.Conv2d(dec[2], num_classes, 1)
            self.ds1_3 = nn.Conv2d(dec[1], num_classes, 1)
        self.dtype = dtype

    @property
    def stripe_unit(self) -> int:
        return ENCODER_STRIDES[self.encoder_name][0]

    @property
    def logits_stride(self) -> int:
        return ENCODER_STRIDES[self.encoder_name][1]

    def compute(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        x0_0, x1_0, x2_0, x3_0, x4_0 = self.encoder(x)
        cat = lambda skip, t: torch.cat([skip, _up_to(t, skip.shape[2:])], 1)
        x3_1 = self.conv3_1(cat(x3_0, x4_0))
        x2_2 = self.conv2_2(cat(x2_0, x3_1))
        x1_3 = self.conv1_3(cat(x1_0, x2_2))
        x0_4 = self.conv0_4(cat(x0_0, x1_3))
        out = self.final(x0_4)
        if self.deep_supervision and self.training:
            rs = lambda t: resize_bilinear_align_corners(t, x.shape[2:], 2, 3)
            return [out, rs(self.ds1_3(x1_3)), rs(self.ds2_2(x2_2)), rs(self.ds3_1(x3_1))]
        return out

    def striped_compute(self, x: torch.Tensor, st: spatial.Stripes
                        ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """`compute` on an H stripe (`blocks.ComputeDtype.forward`), op for op."""
        if self.training and self.logits_stride != 1:
            raise RuntimeError(f"LightweightNestedUNet({self.encoder_name!r}) trains on whole "
                               f"planes only: its logits come out at 1/{self.logits_stride} of "
                               f"the input's side")
        x0_0, x1_0, x2_0, x3_0, x4_0 = on_stripes(self.encoder, x, st)
        cat = lambda skip, t: torch.cat([skip, _up_to_striped(t, skip, st)], 1)
        x3_1 = self.conv3_1.striped(cat(x3_0, x4_0), st)
        x2_2 = self.conv2_2.striped(cat(x2_0, x3_1), st)
        x1_3 = self.conv1_3.striped(cat(x1_0, x2_2), st)
        x0_4 = self.conv0_4.striped(cat(x0_0, x1_3), st)
        out = self.final(x0_4)
        if self.deep_supervision and self.training:
            def rs(t):
                level = st.at(t.shape[2])
                return _resize_rows(t, level, st.rows // level.rows, x.shape[3])

            return [out, rs(self.ds1_3(x1_3)), rs(self.ds2_2(x2_2)), rs(self.ds3_1(x3_1))]
        return out


def create_lightweight_unet(num_classes: int = 7, encoder: str = "mobilenet_v3_small",
                            deep_supervision: bool = False,
                            dtype: torch.dtype = torch.float32) -> LightweightNestedUNet:
    """Factory mirroring the reference's create_lightweight_unet
    (unetpp_lightweight.py:256-284)."""
    return LightweightNestedUNet(num_classes=num_classes, encoder=encoder,
                                 deep_supervision=deep_supervision, dtype=dtype)
