"""unet_tpu_torch — the PyTorch/CUDA port of unet_tpu for NVIDIA Hopper.

A second package beside `unet_tpu` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; the TPU's Pallas kernels become
kernels written by hand for `sm_90a` under `csrc/`, built with `nvcc` at
first use (`unet_tpu_torch._build`) and bound with `ctypes`.

It runs the `two_stage` and `enhanced` presets end to end:
`pipeline.stages.build_step(model, presets.two_stage(), device="cuda")`;
`two_stage` also with the bf16 fast forward (`segment.fast_forward` and
`NestedUNet(dtype=torch.bfloat16)`) and the int8 forward
(`stages.calibrate_int8`). The geometry presets (`wrap_uniformity`,
`wrap_7class`, `production`, `three_class_full`, `three_class_best`) add
per-frame diameters and defect analysis; `serve.MultiStreamServer` serves
several streams through one step, and `inspect` holds the host decisions.
`high_res_roi` and `debug` run as well. Users run it from the command
line, `python -m unet_tpu_torch.cli infer|serve|inspect`, through
`pipeline.InferenceEngine` (video or image-dir sources, event files,
overlays). `cli train` runs the training recipes (`train/`: the losses of
`models.losses`, the host `data/` loaders, the optax trainer as
`torch.optim`, the epoch loop with `core.checkpoint`) and `cli evaluate`
scores a labelled split (`tools.evaluate`, `ops.seg_metrics`).

Layout conventions are the JAX package's at every public function, so the
parity tests compare like with like:
* frames: ``(B, H, W, 3)`` uint8 BGR; float images ``(..., H, W[, C])``
* masks:  ``(..., H, W)`` bool
* the model itself is an ``nn.Module`` in NCHW with the reference's
  state-dict keys.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On a
CPU tensor each kernel wrapper uses its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Importing builds nothing.
"""

__version__ = "0.1.0"
