"""UNet++ ("NestedUNet") with the custom or the ResNet50 encoder
(counterpart of unet_tpu/models/unetpp.py; reference
src/models/unetpp.py:29-135).

As in the reference, the decoder is a plain U-Net chain
(x3_1 -> x2_2 -> x1_3 -> x0_4) with `[skip, up]` concatenation and a
bilinear x2 align-corners upsample. State-dict keys are the reference's
(`conv0_0.conv1.weight`, ..., `final.weight`; with the ResNet50 encoder
`conv0_0` = Sequential(conv, bn, relu, maxpool) and `conv1_0` ...
`conv4_0` = torchvision's layer1 ... layer4), so a reference `.pth` loads
with `load_state_dict`, and `models.convert.state_dict_from_flax` carries
the JAX package's weights across.

The ResNet50 stem folds the max pool, so its stages 0 and 1 share stride 4:
the decoder's last step leaves x1_3 as it is where it already has the
skip's size (the JAX package's repair, unet_tpu/models/unetpp.py:75-83;
the reference's blind x2 cannot concatenate there), and the logits come out
at a quarter of the input's side.
"""
from __future__ import annotations

from typing import List, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.models.blocks import ComputeDtype, ConvBlock, max_pool2, on_stripes, remat
from unet_tpu_torch.models.fast_forward import run_topology
from unet_tpu_torch.models.resnet import resnet50_stages
from unet_tpu_torch.parallel import spatial

NB_FILTER = (32, 64, 128, 256, 512)
RESNET50_CHANNELS = (64, 256, 512, 1024, 2048)


class NestedUNet(ComputeDtype):
    """Args mirror the reference constructor (src/models/unetpp.py:40-46);
    `pretrained_encoder` selects the ResNet50 encoder's topology (its
    weights come from a checkpoint: none is downloaded). In eval mode the
    forward returns the (B, num_classes, h, w) logits; in train mode with
    deep supervision, [out, ds1_3, ds2_2, ds3_1], the heads resized to the
    input's size.

    `dtype` is the compute type, as flax's `dtype` is
    (unet_tpu/models/unetpp.py:44; models.blocks.ComputeDtype). The
    BN-folded and int8 forwards (models/fast_forward.py,
    models/quantized.py) read the float32 parameters of the custom-encoder
    model and compute in `dtype`.

    `remat` recomputes every ConvBlock's activations in the backward pass of
    a train-mode forward (unet_tpu/models/unetpp.py:45-56; models.blocks.remat),
    trading recompute for activation memory; the state dict and the results
    are those of remat off."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = True, pretrained_encoder: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.deep_supervision = deep_supervision
        self.remat = remat
        self.pretrained_encoder = pretrained_encoder
        if pretrained_encoder:
            f = RESNET50_CHANNELS
            (self.conv0_0, self.conv1_0, self.conv2_0, self.conv3_0,
             self.conv4_0) = resnet50_stages()
        else:
            f = NB_FILTER
            self.conv0_0 = ConvBlock(input_channels, f[0])
            self.conv1_0 = ConvBlock(f[0], f[1])
            self.conv2_0 = ConvBlock(f[1], f[2])
            self.conv3_0 = ConvBlock(f[2], f[3])
            self.conv4_0 = ConvBlock(f[3], f[4])
        self.conv3_1 = ConvBlock(f[3] + f[4], f[3])
        self.conv2_2 = ConvBlock(f[2] + f[3], f[2])
        self.conv1_3 = ConvBlock(f[1] + f[2], f[1])
        self.conv0_4 = ConvBlock(f[0] + f[1], f[0])
        self.final = nn.Conv2d(f[0], num_classes, 1)
        if deep_supervision:
            self.ds3_1 = nn.Conv2d(f[3], num_classes, 1)
            self.ds2_2 = nn.Conv2d(f[2], num_classes, 1)
            self.ds1_3 = nn.Conv2d(f[1], num_classes, 1)
        self.dtype = dtype

    def compute(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        recompute = self.remat and self.training and torch.is_grad_enabled()

        def block(m, t):
            return remat(m, t) if recompute else m(t)

        def up_to(t, skip):
            if t.shape[2:] == skip.shape[2:]:
                return t
            return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)

        if self.pretrained_encoder:
            x0_0 = self.conv0_0(x)
            x1_0 = self.conv1_0(x0_0)
            x2_0 = self.conv2_0(x1_0)
            x3_0 = self.conv3_0(x2_0)
            x4_0 = self.conv4_0(x3_0)
        else:
            x0_0 = block(self.conv0_0, x)
            x1_0 = block(self.conv1_0, max_pool2(x0_0))
            x2_0 = block(self.conv2_0, max_pool2(x1_0))
            x3_0 = block(self.conv3_0, max_pool2(x2_0))
            x4_0 = block(self.conv4_0, max_pool2(x3_0))
        x3_1 = block(self.conv3_1, torch.cat([x3_0, up_to(x4_0, x3_0)], 1))
        x2_2 = block(self.conv2_2, torch.cat([x2_0, up_to(x3_1, x2_0)], 1))
        x1_3 = block(self.conv1_3, torch.cat([x1_0, up_to(x2_2, x1_0)], 1))
        x0_4 = block(self.conv0_4, torch.cat([x0_0, up_to(x1_3, x0_0)], 1))
        out = self.final(x0_4)
        if self.deep_supervision and self.training:
            rs = lambda t: F.interpolate(t, size=x.shape[2:], mode="bilinear",
                                         align_corners=True)
            return [out, rs(self.ds1_3(x1_3)), rs(self.ds2_2(x2_2)),
                    rs(self.ds3_1(x3_1))]
        return out

    @property
    def stripe_unit(self) -> int:
        return 32 if self.pretrained_encoder else 16

    @property
    def logits_stride(self) -> int:
        return 4 if self.pretrained_encoder else 1

    def striped_compute(self, x: torch.Tensor, st: spatial.Stripes):
        """`compute` on an H stripe (`blocks.ComputeDtype.forward`). Each
        ConvBlock runs on its halo slab (`ConvBlock.striped`), the 2x2 pools
        on stripes whose bounds are even at every level, the ResNet50
        stages in eval mode as `blocks.on_stripes` runs them, and the 1x1
        heads are row-local.

        Eval mode: the decoder's upsample reads the global source rows of
        its taps (`interpolate_rows`); `up_to` decides on the global
        heights, so the ResNet50 encoder's stride-4 pair stays as it is.

        Train mode (custom encoder; `train.trainer.make_train_step` under a
        spatial mesh): the outputs of the whole train-mode forward (with
        deep supervision [out, ds1_3, ds2_2, ds3_1], the heads resized to
        the input on their stripes, `spatial.resize_rows`), with autograd
        through the transport; the upsamples take their rows from the slab
        alone (`interpolate_slab`). With `remat`, each block is recomputed
        in the backward and its exchange is not."""
        train = self.training
        if train and self.pretrained_encoder:
            raise RuntimeError("the ResNet50-encoder NestedUNet trains on whole planes only: "
                               "its logits come out at a quarter of the input's side")
        recompute = self.remat and train and torch.is_grad_enabled()
        outs = {}

        def block(name, t):
            outs[name] = getattr(self, name).striped(t, st, recompute)
            return outs[name]

        def up(t):
            if train:
                return spatial.resize_rows(t, st.at(t.shape[2]), 2, 2, interpolate_slab)
            return spatial.up2x(t, st.at(t.shape[2]), 2, interpolate_rows)

        def cat_up(skip, t):
            if st.at(t.shape[2]).height == st.at(skip.shape[2]).height:
                return torch.cat([skip, t], 1)
            return torch.cat([skip, up(t)], 1)

        if self.pretrained_encoder:
            x0_0 = on_stripes(self.conv0_0, x, st)
            x1_0 = on_stripes(self.conv1_0, x0_0, st)
            x2_0 = on_stripes(self.conv2_0, x1_0, st)
            x3_0 = on_stripes(self.conv3_0, x2_0, st)
            x4_0 = on_stripes(self.conv4_0, x3_0, st)
            x3_1 = block("conv3_1", cat_up(x3_0, x4_0))
            x2_2 = block("conv2_2", cat_up(x2_0, x3_1))
            x1_3 = block("conv1_3", cat_up(x1_0, x2_2))
            y = block("conv0_4", cat_up(x0_0, x1_3))
        else:
            y = run_topology(x, block, max_pool2, up, lambda a, b: torch.cat([a, b], 1))
        out = self.final(y)
        if not (train and self.deep_supervision):
            return out

        def to_input(head, t):
            level = st.at(t.shape[2])
            return spatial.resize_rows(head(t), level, st.rows // level.rows, 2, interpolate_slab)

        return [out, to_input(self.ds1_3, outs["conv1_3"]), to_input(self.ds2_2, outs["conv2_2"]),
                to_input(self.ds3_1, outs["conv3_1"])]


# ---------------------------------------------------------------------------
# the decoder's upsample on H stripes (parallel.spatial)
# ---------------------------------------------------------------------------

def interpolate_rows(slab: torch.Tensor, lo: int, n: int, rows) -> torch.Tensor:
    """Rows [s, e) = `rows` of `F.interpolate(t, scale_factor=2,
    mode="bilinear", align_corners=True)` of an n-row NCHW plane t, from
    `slab`, its rows [lo, lo + slab rows), bit for bit with the whole call on
    one device: the slab is placed in a zero plane of the full height, so
    that the call sees the unsharded shape and takes its taps and its
    arithmetic; only the rows that the output rows read are real. Its cost:
    the whole upsampled plane, transiently, on every rank."""
    full = slab.new_zeros(slab.shape[:2] + (n,) + slab.shape[3:])
    full[:, :, lo:lo + slab.shape[2]] = slab
    y = F.interpolate(full, scale_factor=2, mode="bilinear", align_corners=True)
    return y[:, :, rows[0]:rows[1]].contiguous()


def interpolate_slab(slab: torch.Tensor, lo: int, n: int, out: int, rows) -> torch.Tensor:
    """Rows [s, e) = `rows` of the align-corners bilinear resize of an n-row
    NCHW plane t to `out` rows and out // n times its width
    (`F.interpolate(t, size=..., mode="bilinear", align_corners=True)`),
    from `slab`, t's rows [lo, lo + slab rows), which hold every row the
    output rows read. The rows are taken from the slab alone (no plane of
    the full height): an H lerp of the two source rows of each output row,
    then the W resize; in float32 at least and cast back once. The train path's
    upsample: its autograd reads the slab only; it equals the whole call
    within float32 rounding, not bit for bit."""
    s, e = rows
    scale = (n - 1) / (out - 1) if out > 1 else 0.0
    src = torch.arange(s, e, dtype=torch.float64) * scale
    i0 = src.floor().clamp(max=n - 1)
    t = slab.to(torch.promote_types(slab.dtype, torch.float32))
    frac = (src - i0).to(t.dtype)
    i0 = i0.long()
    i1 = (i0 + 1).clamp(max=n - 1)
    dev = slab.device
    top = t.index_select(2, (i0 - lo).to(dev))
    bot = t.index_select(2, (i1 - lo).to(dev))
    y = top + (bot - top) * frac.to(dev)[:, None]
    y = F.interpolate(y, size=(e - s, slab.shape[3] * (out // n)), mode="bilinear",
                      align_corners=True)
    return y.to(slab.dtype)
