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

from torch.func import functional_call

from unet_tpu_torch.models.blocks import ComputeDtype, ConvBlock, max_pool2, remat
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


# ---------------------------------------------------------------------------
# on H stripes (parallel.spatial, ROADMAP A15c)
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


class _Striped(nn.Module):
    """`striped_forward` as a module, so that `functional_call` can run it
    on the cast copies of a model whose compute type is not float32."""

    def __init__(self, model: NestedUNet, stripes: spatial.Stripes):
        super().__init__()
        self.model = model
        self.stripes = stripes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, st = self.model, self.stripes

        def block(name, t):
            return spatial.halo(getattr(m, name), [t], st.at(t.shape[2]), 2, axis=2)

        def up(t):
            return spatial.up2x(t, st.at(t.shape[2]), 2, interpolate_rows)

        y = run_topology(x, block, max_pool2, up, lambda a, b: torch.cat([a, b], 1))
        return m.final(y)


def striped_forward(model: NestedUNet, x: torch.Tensor, stripes: spatial.Stripes) -> torch.Tensor:
    """The eval-mode logits of a custom-encoder NestedUNet on an H stripe:
    `x` (B, Cin, rows, W) holds the model input's rows [stripes.start,
    stripes.end); returns the logits' same rows, equal to the whole
    forward's on one device bit for bit (on the CPU; cuDNN may pick another
    algorithm for a stripe's shape). Each ConvBlock runs on its halo slab,
    2 rows each side (`spatial.halo`), the pools on stripes whose bounds are
    even at every level, BatchNorm and the 1x1 head are row-local, and the
    decoder's upsample reads the global source rows of its taps
    (`interpolate_rows`). A collective of the spatial group."""
    if model.pretrained_encoder:
        raise NotImplementedError("the ResNet50-encoder NestedUNet on H stripes: ROADMAP A15e")
    if model.training:
        raise NotImplementedError("the train-mode forward on H stripes: ROADMAP A15d")
    net = _Striped(model, stripes)
    if next(model.parameters()).dtype != model.dtype:
        state = {f"model.{k}": v for k, v in model._cast_state().items()}
        return functional_call(net, state, (x.to(model.dtype),))
    return net(x)
