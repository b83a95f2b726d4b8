"""Flax variables -> PyTorch state dict (the inverse of
unet_tpu/models/convert.py:40-147 `convert_state_dict` for `nested_unet`),
the JAX package's int8 parameters -> the port's (`qparams_from_jax`), and
reference `.pth` files read with their model family and class count
(`load_pth`, `detect_model_kind`, `infer_num_classes`).

Input is the JAX package's `{"params": ..., "batch_stats": ...}` tree with
numpy (or array-like) leaves; no JAX import is needed. Conv kernels go
HWIO -> OIHW; BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_BLOCKS = ("conv0_0", "conv1_0", "conv2_0", "conv3_0", "conv4_0",
           "conv3_1", "conv2_2", "conv1_3", "conv0_4")


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


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """NestedUNet (custom encoder) flax variables -> state dict with the
    reference's keys. Deep-supervision heads are carried when present."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for name in _BLOCKS:
        p, s = params[name], stats[name]
        _conv(sd, f"{name}.conv1", p["conv1"])
        _bn(sd, f"{name}.bn1", p["bn1"], s["bn1"])
        _conv(sd, f"{name}.conv2", p["conv2"])
        _bn(sd, f"{name}.bn2", p["bn2"], s["bn2"])
    _conv(sd, "final", params["final"])
    for ds in ("ds3_1", "ds2_2", "ds1_3"):
        if ds in params:
            _conv(sd, ds, params[ds])
    return sd


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
