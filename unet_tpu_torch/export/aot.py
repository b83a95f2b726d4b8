"""Ahead-of-time export: `torch.export` programs in one `.pt2` file
(counterpart of unet_tpu/export/aot.py, whose artifacts are StableHLO).

The reference's deploy chain exports the bare model forward with a dynamic
batch (tools/export_onnx.py:18-137, run by src/infer/onnx_runtime.py:7-23).
`export_model` does that; `export_pipeline` exports the whole fused step,
preprocess + forward + burr + stats/geometry (`stages.run_pipeline`), so the
artifact takes uint8 frames and gives the verdict's tensors. The weights
are in the file, as the JAX artifact bakes them in. `batch=None` exports a
symbolic batch dimension (`torch.export.Dim("b")`, 1 to 65535). A program
of the BN-folded or int8 forward takes batches of 2 and more: torch's
tracer picks its channels-last convs' memory format by whether the batch
is 1, and the program checks that guard when it runs.

The hand-written kernels are custom ops (`torch.ops.unet_tpu_torch.
cc_propagate`, `nlm`, `qconv`), which the program records as calls: on the
card it launches the same kernels, routed at run time, as the live step.
Tracing runs each op's fake implementation, not the kernel, so a program
traced on the CPU runs on the card after `AotRunner` moves it there.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn

Device = Union[str, torch.device]


def _dims(batch: Optional[int]):
    # 65535: the most that one CUDA launch's grid takes along the batch in
    # the traced ops; a program traced on the card carries that guard
    return {0: torch.export.Dim("b", min=1, max=65535)} if batch is None else None


@contextlib.contextmanager
def _legacy_cudnn_flags():
    """torch.export reads cuDNN's legacy TF32 flag, which raises once the
    flags have been set through both the legacy and the per-operator API.
    The trace runs no cuDNN op, so for its duration the legacy flag is set
    to what the conv precision says, and the per-operator precisions are
    restored afterwards."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)
    cudnn.allow_tf32 = saved[0] == "tf32"
    try:
        yield
    finally:
        cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = saved


def _export(module: nn.Module, example: torch.Tensor, batch: Optional[int]):
    """torch.export (non-strict) of `module` on `example` under no_grad.
    Sizes are traced size-obliviously (`backed_size_oblivious`): otherwise
    the tracer takes a dynamic size for at least 2 and a batch of 1 would
    not run. The resize tables that `ops.image._table` builds while tracing
    are fake tensors; they leave its cache with the trace."""
    from torch.fx.experimental import _config as shapes_config

    from unet_tpu_torch.ops import image as _image

    try:
        with torch.no_grad(), shapes_config.patch(backed_size_oblivious=True), \
                _legacy_cudnn_flags():
            return torch.export.export(module, (example,), dynamic_shapes=(_dims(batch),),
                                       strict=False)
    finally:
        _image._table.cache_clear()


def _save(ep, output: str) -> Path:
    out_path = Path(output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, str(out_path))
    return out_path


class _Logits(nn.Module):
    """(B, h, w, 3) normalized NHWC float32 -> (B, h, w, C) logits (the
    first head), the JAX artifact's layouts."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model(x.permute(0, 3, 1, 2))
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out.permute(0, 2, 3, 1)


def export_model(model_path: Optional[str], output: str, arch: str = "nested_unet",
                 input_size: int = 512, batch: Optional[int] = None,
                 num_classes: Optional[int] = None, device: Device = "cuda",
                 model: Optional[nn.Module] = None) -> str:
    """Export the eval forward of the model in `model_path` (a reference
    .pth or a checkpoint of `train`; `model` may be passed instead) at
    `input_size`, traced on `device`, to `output`. batch=None exports a
    symbolic batch dimension."""
    from unet_tpu_torch.cli.main import load_model

    if model is None:
        model, num_classes, arch = load_model(model_path, arch, "float32", num_classes or 3)
    model = model.to(device).eval()
    n = 2 if batch is None else batch
    x = torch.zeros((n, input_size, input_size, 3), dtype=torch.float32, device=device)
    ep = _export(_Logits(model), x, batch)
    out_path = _save(ep, output)
    print(f"exported {arch} (input {input_size}, "
          f"batch={'dynamic' if batch is None else batch}) -> {out_path} "
          f"({out_path.stat().st_size} bytes)")
    return str(out_path)


def _outputs_to_tree(out) -> dict:
    """FrameOutputs -> a plain nested dict of tensors, the None fields
    dropped (unet_tpu/export/aot.py:58-67), so the program's outputs need
    no class of the port at load time."""
    tree = {}
    for k, v in out._asdict().items():
        if v is None:
            continue
        tree[k] = v._asdict() if hasattr(v, "_asdict") else v
    return tree


class _Pipeline(nn.Module):
    """The fused step as a module: (B, H, W, 3) uint8 BGR -> the dict of
    `_outputs_to_tree`. The plain forward's model is registered, so that its
    weights are the program's; the fast and int8 forwards' prepared weights
    are constants of the program, and the model's own stay out of it."""

    def __init__(self, model: nn.Module, cfg, device: Device):
        super().__init__()
        from unet_tpu_torch.pipeline import stages

        if not (cfg.segment.fast_forward or cfg.segment.int8_scales):
            self.model = model
        self.cfg = cfg
        self._forward = stages.segment_forward(model, cfg, device)

    def forward(self, frames: torch.Tensor) -> dict:
        from unet_tpu_torch.pipeline import stages

        return _outputs_to_tree(stages.run_pipeline(self._forward, frames, self.cfg))


def export_pipeline(model_path: Optional[str], output: str, preset: str = "two_stage",
                    batch: Optional[int] = None, frame_hw=(448, 800),
                    arch: str = "nested_unet", num_classes: Optional[int] = None,
                    fast: bool = True, cfg=None, model: Optional[nn.Module] = None,
                    device: Device = "cuda") -> str:
    """Export the whole fused step, `stages.run_pipeline` over the forward
    `stages.build_step` uses, traced on `device`, with an optional symbolic
    batch dimension. `cfg` is honoured as given (`segment.int8_scales`
    included, so an int8 step exports too); `cfg` and `model` may be passed
    directly, else they come from `model_path` and `preset`, with `fast`
    setting `segment.fast_forward` for a custom-encoder NestedUNet. The
    quality statistics' previous frame is not an input: frame 0 diffs
    against itself, as in the JAX artifact."""
    from unet_tpu_torch.pipeline import get_preset

    if cfg is None:
        from unet_tpu_torch.cli.main import load_model

        model, n_cls, arch = load_model(model_path, arch, "float32", num_classes or 3)
        cfg = get_preset(preset)
        if n_cls != cfg.segment.num_classes:
            cfg = cfg.replace_in("segment", num_classes=n_cls)
        if fast and arch == "nested_unet":
            cfg = cfg.replace_in("segment", fast_forward=True)
    h, w = frame_hw
    n = 2 if batch is None else batch
    frames = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=device)
    step = _Pipeline(model, cfg, device)
    ep = _export(step, frames, batch)
    out_path = _save(ep, output)
    print(f"exported pipeline {cfg.name} (frames {h}x{w}, "
          f"batch={'dynamic' if batch is None else batch}) -> {out_path} "
          f"({out_path.stat().st_size} bytes)")
    return str(out_path)


class AotRunner:
    """Runner over a `.pt2` artifact (the ONNXSegRunner equivalent,
    reference src/infer/onnx_runtime.py:7-23), on `device`: the program is
    moved there if it was traced elsewhere. `run` feeds normalized NHWC
    float32 and gives logits; `run_tree` feeds a pipeline artifact uint8
    frames and gives its nested dict of numpy outputs. The programs run
    with full-fp32 cuDNN convs (`models.blocks.fp32_convs`): the step pins
    them by a Python side effect that the trace does not record."""

    def __init__(self, path: str, device: Device = "cuda"):
        # the modules whose import registers the custom ops the program calls
        from unet_tpu_torch.ops import cc_kernels, nlm_kernels, qconv_kernels  # noqa: F401

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AotRunner(device='cuda') needs a CUDA device")
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(torch.export.load(str(path)), self.device)
        self.program = ep
        self.module = ep.module()

    def _call(self, x):
        from unet_tpu_torch.models.blocks import fp32_convs

        with torch.no_grad(), fp32_convs():
            return self.module(torch.as_tensor(x).to(self.device))

    def run(self, x) -> np.ndarray:
        return self._call(x).cpu().numpy()

    def run_tree(self, frames_u8) -> dict:
        """For pipeline artifacts (export_pipeline): {class_map, cable_px,
        ..., diameters: {...}} as numpy arrays."""
        host = lambda t: t.cpu().numpy()
        return {k: ({f: host(t) for f, t in v.items()} if isinstance(v, dict) else host(v))
                for k, v in self._call(frames_u8).items()}

