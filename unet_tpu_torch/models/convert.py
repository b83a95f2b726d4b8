"""Weights into the port's models: flax variables -> PyTorch state dict
(the inverse of unet_tpu/models/convert.py:98-147 `convert_state_dict`,
for every model family of the JAX package); the JAX package's int8
parameters -> the port's (`qparams_from_jax`); torchvision MobileNetV3
weights -> the port's encoder
(`mobilenet_encoder_state_dict`); and reference `.pth` files read with
their model family and class count (`load_pth`, `detect_model_kind`,
`infer_num_classes`).

Input is the JAX package's `{"params": ..., "batch_stats": ...}` tree with
numpy (or array-like) leaves; no JAX import is needed. Conv kernels go
HWIO -> OIHW. A flax ConvTranspose with `transpose_kernel=True` stores the
torch ConvTranspose2d weight (I, O, kh, kw) as (kh, kw, O, I) and flips it
itself, so the same axis permutation carries it across, with no flip.
BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var.

The families are named as `cli --arch` names them: `nested_unet`,
`nested_unet_resnet50`, `simple_unet` and `lightweight:<encoder>`.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_BLOCKS = ("conv0_0", "conv1_0", "conv2_0", "conv3_0", "conv4_0",
           "conv3_1", "conv2_2", "conv1_3", "conv0_4")
_DECODER = ("conv3_1", "conv2_2", "conv1_3", "conv0_4")
_HEADS = ("final", "ds3_1", "ds2_2", "ds1_3")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(sd: Dict[str, torch.Tensor], key: str, node: Dict[str, Any]) -> None:
    sd[key + ".weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[key + ".bias"] = _t(node["bias"])


def _bn(sd, key, params, stats) -> None:
    sd[key + ".weight"] = _t(params["scale"])
    sd[key + ".bias"] = _t(params["bias"])
    sd[key + ".running_mean"] = _t(stats["mean"])
    sd[key + ".running_var"] = _t(stats["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


# ---------------------------------------------------------------------------
# the correspondence of port keys and flax paths, one family at a time:
# (port module key, flax module path, "conv" or "bn")
# ---------------------------------------------------------------------------

def _convblock(port: str, flax: Tuple[str, ...]):
    for i in (1, 2):
        yield f"{port}.conv{i}", flax + (f"conv{i}",), "conv"
        yield f"{port}.bn{i}", flax + (f"bn{i}",), "bn"


def _decoder_and_heads(prefix: Tuple[str, ...] = ()):
    for name in _DECODER:
        yield from _convblock(name, prefix + (name,))
    for name in _HEADS:
        yield name, prefix + (name,), "conv"


def _resnet_block(port: str, flax: Tuple[str, ...], n_convs: int):
    for i in range(1, n_convs + 1):
        yield f"{port}.conv{i}", flax + (f"conv{i}",), "conv"
        yield f"{port}.bn{i}", flax + (f"bn{i}",), "bn"
    yield f"{port}.downsample.0", flax + ("downsample_conv",), "conv"
    yield f"{port}.downsample.1", flax + ("downsample_bn",), "bn"


def _resnet_layers(port: str, flax: Tuple[str, ...], layers, n_convs: int):
    for k, n in enumerate(layers, start=1):
        for i in range(n):
            yield from _resnet_block(port.format(k=k, i=i), flax + (f"layer{k}_{i}",), n_convs)


def _mobilenet(variant: str):
    from unet_tpu_torch.models.mobilenet import LARGE_SPEC, SMALL_SPEC

    enc = ("encoder",)
    yield "encoder.features.0.0", enc + ("features_0", "conv"), "conv"
    yield "encoder.features.0.1", enc + ("features_0", "bn"), "bn"
    spec = SMALL_SPEC if variant == "small" else LARGE_SPEC
    cin = 16
    for idx, (_, exp, out, use_se, _, _) in enumerate(spec, start=1):
        base, path = f"encoder.features.{idx}.block", enc + (f"features_{idx}",)
        parts = (["expand"] if exp != cin else []) + ["depthwise"] + (["se"] if use_se else [])
        for j, part in enumerate(parts):
            if part == "se":
                yield f"{base}.{j}.fc1", path + ("se", "fc1"), "conv"
                yield f"{base}.{j}.fc2", path + ("se", "fc2"), "conv"
            else:
                yield f"{base}.{j}.0", path + (part, "conv"), "conv"
                yield f"{base}.{j}.1", path + (part, "bn"), "bn"
        yield f"{base}.{len(parts)}.0", path + ("project_conv",), "conv"
        yield f"{base}.{len(parts)}.1", path + ("project_bn",), "bn"
        cin = out
    last = len(spec) + 1
    yield f"encoder.features.{last}.0", enc + (f"features_{last}", "conv"), "conv"
    yield f"encoder.features.{last}.1", enc + (f"features_{last}", "bn"), "bn"


def _shufflenet():
    from unet_tpu_torch.models.shufflenet import STAGE_REPEATS

    enc = ("encoder",)
    yield "encoder.conv1.0", enc + ("conv1",), "conv"
    yield "encoder.conv1.1", enc + ("conv1_bn",), "bn"
    for s, reps in enumerate(STAGE_REPEATS, start=2):
        for i in range(reps):
            port, path = f"encoder.stage{s}.{i}", enc + (f"stage{s}_{i}",)
            for j, (name, kind) in enumerate((("branch1_dwconv", "conv"), ("branch1_bn1", "bn"),
                                              ("branch1_conv", "conv"), ("branch1_bn2", "bn"))):
                yield f"{port}.branch1.{j}", path + (name,), kind
            for j, (name, kind) in ((0, ("branch2_conv1", "conv")), (1, ("branch2_bn1", "bn")),
                                    (3, ("branch2_dwconv", "conv")), (4, ("branch2_bn2", "bn")),
                                    (5, ("branch2_conv2", "conv")), (6, ("branch2_bn3", "bn"))):
                yield f"{port}.branch2.{j}", path + (name,), kind


def _pairs(arch: str) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """Every (port key, flax path, kind) an `arch` model may have; the
    optional ones (deep-supervision heads, shortcut projections) are
    carried where the source has them."""
    if arch == "nested_unet":
        for name in _BLOCKS:
            yield from _convblock(name, (name,))
        for name in _HEADS:
            yield name, (name,), "conv"
    elif arch == "nested_unet_resnet50":
        yield "conv0_0.0", ("encoder", "stem", "conv1"), "conv"
        yield "conv0_0.1", ("encoder", "stem", "bn1"), "bn"
        yield from _resnet_layers("conv{k}_0.{i}", ("encoder",), (3, 4, 6, 3), 3)
        yield from _decoder_and_heads()
    elif arch == "simple_unet":
        for name in ("enc1", "enc2", "enc3", "enc4", "dec3", "dec2", "dec1"):
            yield f"{name}.0", (name, "conv1"), "conv"
            yield f"{name}.2", (name, "conv2"), "conv"
        for name in ("up3", "up2", "up1", "final"):
            yield name, (name,), "conv"
    elif arch.startswith("lightweight"):
        enc = arch.split(":", 1)[1] if ":" in arch else "mobilenet_v3_small"
        if enc == "custom":
            for i in range(5):
                yield from _convblock(f"encoder.enc{i}", ("encoder", f"enc{i}"))
        elif enc in ("resnet18", "resnet34"):
            yield "encoder.conv1", ("encoder", "stem", "conv1"), "conv"
            yield "encoder.bn1", ("encoder", "stem", "bn1"), "bn"
            layers = (2, 2, 2, 2) if enc == "resnet18" else (3, 4, 6, 3)
            yield from _resnet_layers("encoder.layer{k}.{i}", ("encoder",), layers, 2)
        elif enc.startswith("mobilenet_v3_"):
            yield from _mobilenet(enc.replace("mobilenet_v3_", ""))
        elif enc == "shufflenet_v2_x1_0":
            yield from _shufflenet()
        else:
            raise ValueError(f"unsupported encoder {enc!r}")
        yield from _decoder_and_heads()
    else:
        raise ValueError(f"unknown model family {arch!r}")


def _get(tree: Dict[str, Any], path: Tuple[str, ...]):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def state_dict_from_flax(variables: Dict[str, Any], arch: str = "nested_unet"
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's variables of an `arch` model -> a state dict with the
    port's keys (the reference's where it has them), which the port's model
    of that family loads strictly. Deep-supervision heads and shortcut
    projections are carried where the flax tree has them."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for key, path, kind in _pairs(arch):
        node = _get(params, path)
        if node is None:
            continue
        if kind == "conv":
            _conv(sd, key, node)
        else:
            _bn(sd, key, node, _get(stats, path))
    return sd


def mobilenet_encoder_state_dict(sd: Dict[str, Any], variant: str = "small",
                                 torch_prefix: str = "") -> Dict[str, torch.Tensor]:
    """torchvision mobilenet_v3_{small,large} `features.*` weights -> the
    state dict of the port's MobileNetV3Encoder (the counterpart of
    unet_tpu/models/convert.py:150-195 `convert_mobilenet_encoder`). The
    port keeps torchvision's layout, so each key loses `torch_prefix` and
    keeps the rest; every key the encoder has must be there, as torch
    tensors or numpy arrays. Load it into `LightweightNestedUNet.encoder`."""
    from unet_tpu_torch.models.mobilenet import MobileNetV3Encoder

    want = MobileNetV3Encoder(variant).state_dict()
    out = {}
    for k, v in want.items():
        src = sd.get(torch_prefix + k)
        if src is None and k.endswith("num_batches_tracked"):
            src = v
        if src is None:
            raise KeyError(f"{torch_prefix + k} missing from the mobilenet_v3_{variant} weights")
        out[k] = torch.as_tensor(np.asarray(src) if not isinstance(src, torch.Tensor) else src)
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(out[k].shape)}, the encoder's {tuple(v.shape)}")
    return out


def qparams_from_jax(qp: Any, dtype: torch.dtype = torch.bfloat16, device="cpu"):
    """The JAX package's `QParams` (unet_tpu/models/quantized.py:53-58,
    prepared with `pack_max_cout=0`; numpy or array-like leaves) -> the
    port's `models.quantized.QParams` with compute type `dtype`: int8
    weights HWIO -> OHWI, s_w and b as they are, the requant epilogue
    computed from them and the scales as the port computes it. Raises
    ValueError on a phase-packed layer."""
    from unet_tpu_torch.models.quantized import QParams, qlayer

    blocks = {}
    for name, pair in qp.blocks.items():
        layers = []
        for i, l in enumerate(pair):
            if l.packed:
                raise ValueError(f"{name} conv{i + 1} is phase-packed: prepare the JAX "
                                 f"parameters with pack_max_cout=0")
            wq = _t(np.transpose(np.asarray(l.wq), (3, 0, 1, 2)))
            q = qlayer(wq, _t(np.asarray(l.s_w, np.float32)), _t(np.asarray(l.b, np.float32)),
                       float(qp.scales[f"{name}.relu{i + 1}"]), dtype)
            layers.append(type(q)(*(t.to(device) for t in q)))
        blocks[name] = tuple(layers)
    fw = np.asarray(qp.final_w, np.float32)[0, 0]            # (C0, num_classes)
    return QParams(blocks=blocks, final_w=_t(fw).to(device=device, dtype=dtype),
                   final_b=_t(np.asarray(qp.final_b, np.float32)).to(device=device, dtype=dtype),
                   scales={k: float(v) for k, v in qp.scales.items()}, dtype=dtype)


# ---------------------------------------------------------------------------
# reference .pth checkpoints (counterpart of unet_tpu/models/convert.py:26-37, 79-92)
# ---------------------------------------------------------------------------

def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pth as a state dict on the CPU, unwrapped from the
    containers the reference writes: {epoch, model, optimizer, ...},
    {model_state_dict: ...}, {state_dict: ...} or a bare state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "model_state_dict", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def detect_model_kind(sd: Dict[str, Any]) -> str:
    """The reference model family of a state dict, by its key layout."""
    if "conv0_0.conv1.weight" in sd:
        return "nested_unet"
    if "conv0_0.0.weight" in sd:
        return "nested_unet_resnet50"
    if "enc1.0.weight" in sd:
        return "simple_unet"
    raise ValueError("unrecognized checkpoint key layout")


def infer_num_classes(sd: Dict[str, Any]) -> int:
    """Output classes from the final 1x1 conv (the reference's
    auto-num-classes, infer_video_refactored.py:59)."""
    return int(sd["final.weight"].shape[0])
