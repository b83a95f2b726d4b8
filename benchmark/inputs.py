"""What a run is given, made from `--seed` on the run's device: the
NestedUNet's weights and the cable scenes.

Both are drawn from one `torch.Generator` on the device in a few large
calls, so the same seed gives the same weights and frames on the same
kind of device, and set-up stays short. The harness hands the same state
dict and frames to the port and to the reference.

Random weights alone give a class map that one class fills, whatever the
frame holds, and leave the burr stage nothing to do. So `fit_head` fits
the 1x1 head, by ridge regression on the seeded network's own features,
to the scene's classes as the frames' colours give them: the logits then
follow the cable and the tape, with near-ties along their edges.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BLOCKS = (  # (name, level, source widths by index into nb_filter) of UNet++
    ("conv0_0", 0, ("in",)), ("conv1_0", 1, (0,)), ("conv2_0", 2, (1,)),
    ("conv3_0", 3, (2,)), ("conv4_0", 4, (3,)),
    ("conv3_1", 3, (3, 4)), ("conv2_2", 2, (2, 3)), ("conv1_3", 1, (1, 2)),
    ("conv0_4", 0, (0, 1)),
)
HEADS = (("final", 0), ("ds3_1", 3), ("ds2_2", 2), ("ds1_3", 1))
FIT_FRAMES = 4     # the frames whose features the head is fitted on
FIT_PIXELS = 65536  # the pixels drawn from them for the fit
FIT_RIDGE = 1e-2    # the fit's ridge, per pixel
SCENE_BLOCK = 32    # frames drawn in one block


def nested_unet_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor of the NestedUNet's state dict, in the
    reference's order and names (src/models/unetpp.py: `convX_Y.conv1`,
    `bn1`, ..., `final`, then the deep-supervision heads)."""
    f, cin, n = model["nb_filter"], model["input_channels"], model["num_classes"]
    out = []
    for name, level, srcs in BLOCKS:
        c_in = sum(cin if s == "in" else f[s] for s in srcs)
        cout = f[level]
        for i, ci in ((1, c_in), (2, cout)):
            out += [(f"{name}.conv{i}.weight", (cout, ci, 3, 3)), (f"{name}.conv{i}.bias", (cout,))]
            out += [(f"{name}.bn{i}.{k}", (cout,))
                    for k in ("weight", "bias", "running_mean", "running_var")]
            out.append((f"{name}.bn{i}.num_batches_tracked", ()))
    heads = HEADS if model["deep_supervision"] else HEADS[:1]
    for name, level in heads:
        out += [(f"{name}.weight", (n, f[level], 1, 1)), (f"{name}.bias", (n,))]
    return out


def nested_unet_state(model: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights: convs He-normal (fan-in from dims 1-3), BN
    running variances uniform in [0.5, 1.5], running means and biases
    normal (0.1), BN weights uniform in [0.8, 1.2]; one normal and one
    uniform draw for the whole model. Activations keep their scale through
    the 18 convs, so the logits are of order one."""
    shapes = nested_unet_shapes(model)
    normal = [(k, s) for k, s in shapes if len(s) == 4 or k.endswith(("running_mean", "bias"))]
    uniform = [(k, s) for k, s in shapes if k.endswith(("running_var", ".weight")) and len(s) == 1]
    z = torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s) for _, s in uniform), generator=gen, device=device)
    sd, at = {}, 0
    for k, s in normal:
        n = math.prod(s)
        std = math.sqrt(2.0 / (s[1] * s[2] * s[3])) if len(s) == 4 else 0.1
        sd[k] = (z[at:at + n] * std).reshape(s)
        at += n
    at = 0
    for k, s in uniform:
        n = math.prod(s)
        lo = 0.5 if k.endswith("running_var") else 0.8
        hi = 1.5 if k.endswith("running_var") else 1.2
        sd[k] = (lo + (hi - lo) * u[at:at + n]).reshape(s)
        at += n
    for k, s in shapes:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64, device=device)
    return {k: sd[k] for k, _ in shapes}


def cable_scenes(n: int, hw: Tuple[int, int], scene: dict, gen: torch.Generator,
                 device) -> torch.Tensor:
    """(n, H, W, 3) uint8 BGR frames of the reference video's content
    class: a cable strip and a tape band over a noisy background, as the
    port's bench draws them (`bench._synthetic_frames`: background uniform
    in [40, 70], cable (175, 180, 180), tape (60, 90, 200), Gaussian noise
    of 4), with each frame's cable position and width, tape span and
    colours drawn from the generator, so that no two frames are alike.
    `scene["cable_axis"]`: "vertical" (the strip runs down the frame) or
    "horizontal" (a frame the preset rotates first). `scene["cable_span"]`:
    the fraction of the frame's width (height) the strip's left (top) edge
    is drawn in. Made in blocks of `SCENE_BLOCK` frames."""
    H, W = hw
    vertical = scene["cable_axis"] == "vertical"
    across = W if vertical else H            # the axis the strip's width lies on
    along = H if vertical else W
    lo, hi = scene["cable_span"]
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    pos_a = torch.arange(across, device=device, dtype=torch.float32)
    pos_l = torch.arange(along, device=device, dtype=torch.float32)
    for s in range(0, n, SCENE_BLOCK):
        b = min(SCENE_BLOCK, n - s)
        r = torch.rand((b, 8), generator=gen, device=device)
        x0 = torch.floor((lo + (hi - lo) * r[:, 0]) * across)
        width = torch.floor(40 + 30 * r[:, 1])
        y0 = torch.floor((0.2 + 0.3 * r[:, 2]) * along)
        y1 = y0 + torch.floor((1 / 6 + 1 / 6 * r[:, 3]) * along)
        cable_bgr = torch.stack([165 + 20 * r[:, 4], 170 + 20 * r[:, 4], 170 + 20 * r[:, 5]], -1)
        tape_bgr = torch.stack([50 + 20 * r[:, 6], 80 + 20 * r[:, 6], 190 + 20 * r[:, 7]], -1)
        a = pos_a[None, :]
        in_cable = (a >= x0[:, None]) & (a < (x0 + width)[:, None])                 # (b, across)
        in_tape_a = (a >= (x0 - 8)[:, None]) & (a < (x0 + width + 8)[:, None])
        in_tape_l = (pos_l[None, :] >= y0[:, None]) & (pos_l[None, :] < y1[:, None])  # (b, along)
        cable = in_cable[:, None, :].expand(b, along, across)
        tape = in_tape_l[:, :, None] & in_tape_a[:, None, :]
        if not vertical:
            cable, tape = cable.transpose(1, 2), tape.transpose(1, 2)
        img = 40 + 30 * torch.rand((b, H, W, 3), generator=gen, device=device)
        img = torch.where(cable[..., None], cable_bgr[:, None, None, :], img)
        img = torch.where(tape[..., None], tape_bgr[:, None, None, :], img)
        img = img + 4 * torch.randn((b, H, W, 3), generator=gen, device=device)
        out[s:s + b] = img.clamp_(0, 255).to(torch.uint8)
    return out


def colour_classes(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, h, w) RGB model input in [0, 1] -> (B, h, w) int64 classes of
    `cable_scenes`' colours: 2 tape (red over blue by more than 0.25), 1
    cable (every channel above 0.5), else 0."""
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    tape = r - b > 0.25
    cable = (torch.minimum(torch.minimum(r, g), b) > 0.5) & ~tape
    return torch.where(tape, 2, torch.where(cable, 1, 0))


def fit_head(sd: Dict[str, torch.Tensor], x: torch.Tensor,
             gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """`sd` with `final.weight` and `final.bias` fitted by ridge regression
    on the features of model input `x` (B, 3, h, w) at `FIT_PIXELS` pixels
    drawn from the generator, to targets +2 for the pixel's colour class and
    -1 for the others (`colour_classes`)."""
    from .reference import nested_unet

    feats = nested_unet.features(sd, x)                      # (B, C, h, w)
    C = feats.shape[1]
    f = feats.permute(0, 2, 3, 1).reshape(-1, C)
    y = colour_classes(x).reshape(-1)
    n = FIT_PIXELS
    pick = torch.randint(0, f.shape[0], (n,), generator=gen, device=f.device)
    a = torch.cat([f[pick], torch.ones((n, 1), device=f.device)], 1).double()
    n_cls = sd["final.bias"].shape[0]
    target = torch.full((n, n_cls), -1.0, dtype=torch.float64, device=f.device)
    target[torch.arange(n, device=f.device), y[pick]] = 2.0
    gram = a.T @ a + FIT_RIDGE * n * torch.eye(C + 1, dtype=torch.float64, device=f.device)
    coef = torch.linalg.solve(gram, a.T @ target).float()      # (C + 1, classes)
    out = dict(sd)
    out["final.weight"] = coef[:C].T.reshape(n_cls, C, 1, 1).contiguous()
    out["final.bias"] = coef[C].contiguous()
    return out
