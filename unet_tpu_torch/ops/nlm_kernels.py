"""Non-local-means denoising: the CUDA kernel and its plain version.

Counterpart of unet_tpu/ops/nlm_pallas.py `nlm_padded` (:85-109), the TPU
kernel behind the `enhanced` preset's denoiser (frames.nlm_denoise_colored:
one launch each for L, a and b). The kernel is `csrc/nlm.cu` (its header
says how it is built and bounded); `nlm_plain` is the same function in plain
PyTorch, the XLA scan form of unet_tpu/ops/frames.py:100-127.

Both take the UNPADDED (B, H, W) float32 stack and return its denoised
(B, H, W) interior; the reflect-101 border of width search//2 + template//2
is applied inside. They agree up to float summation order, within the JAX
package's own gate for its kernel (rtol 2e-5, atol 2e-3,
tests/test_nlm_pallas.py).

`nlm` calls the custom op `torch.ops.unet_tpu_torch.nlm`, which dispatches
on the device of its input: a CPU tensor goes to `nlm_plain`, a CUDA tensor
launches the kernel or raises; its fake implementation lets `torch.export`
trace through it. `launches` counts kernel launches. On the card the
weight comes from the MUFU exp2 alone, inside the gate.
"""
from __future__ import annotations

import ctypes

import torch

from unet_tpu_torch import _build
from unet_tpu_torch.ops.image import _pad_hw_reflect101

launches = 0

_MAX_TEMPLATE = 11   # csrc/nlm.cu is built for template radii 0 .. 5


def _check(x: torch.Tensor, h: float, template: int, search: int) -> None:
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"x must be (B, H, W) float32, got {tuple(x.shape)} {x.dtype}")
    if template % 2 != 1 or not 1 <= template <= _MAX_TEMPLATE:
        raise ValueError(f"template must be odd in 1..{_MAX_TEMPLATE}, got {template}")
    if search % 2 != 1 or search < 1:
        raise ValueError(f"search must be odd and >= 1, got {search}")
    if not h > 0:
        raise ValueError(f"h must be > 0, got {h}")
    pad = search // 2 + template // 2
    H, W = x.shape[-2:]
    if pad > H - 1 or pad > W - 1:
        raise ValueError(f"a {H}x{W} plane is too small for a reflect-101 border of {pad}")


def nlm(x: torch.Tensor, h: float, template: int = 7, search: int = 21) -> torch.Tensor:
    """Non-local means of each (H, W) plane of the (B, H, W) float32 stack
    `x`, with filter strength `h`, a `template` x `template` patch and a
    `search` x `search` window. Returns (B, H, W) float32."""
    _check(x, h, template, search)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nlm runs on cpu or cuda, not {x.device}")
    return torch.ops.unet_tpu_torch.nlm(x, float(h), template, search)


@torch.library.custom_op("unet_tpu_torch::nlm", mutates_args=(), device_types="cpu")
def _nlm_op(x: torch.Tensor, h: float, template: int, search: int) -> torch.Tensor:
    return nlm_plain(x, h, template, search)


@_nlm_op.register_kernel("cuda")
def _(x, h, template, search):
    global launches
    if not x.is_contiguous():
        raise ValueError("nlm needs a contiguous x")
    B, H, W = x.shape
    lib = _build.load("nlm")
    fn = lib.nlm_denoise
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_double,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), B, H, W, search, template, float(h), stream)
    if err != 0:
        raise RuntimeError(f"nlm launch failed: CUDA error {err}")
    launches += 1
    return out


@_nlm_op.register_fake
def _(x, h, template, search):
    return x.new_empty(x.shape)


def nlm_plain(x: torch.Tensor, h: float, template: int = 7, search: int = 21) -> torch.Tensor:
    """`nlm` in plain PyTorch, on any device: for each non-centre offset,
    the squared difference with the shifted plane, a box sum over H then
    over W (terms in order, as the JAX scan sums them), the weight
    exp(-d2 / template^2 / h^2) and the two accumulators; the centre pixel
    then enters with weight 1."""
    _check(x, h, template, search)
    r, t = search // 2, template // 2
    pad = r + t
    H, W = x.shape[1:]
    xp = _pad_hw_reflect101(x, 1, pad, pad, pad, pad)
    rh, rw = H + 2 * t, W + 2 * t          # the box sums' input region
    a = xp[:, r:r + rh, r:r + rw]
    area = float(template * template)
    inv_h2 = 1.0 / (h * h)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            s = xp[:, r + dy:r + dy + rh, r + dx:r + dx + rw]
            d2 = (a - s) ** 2
            rows = d2[:, 0:H]
            for k in range(1, template):
                rows = rows + d2[:, k:k + H]
            box = rows[:, :, 0:W]
            for k in range(1, template):
                box = box + rows[:, :, k:k + W]
            w = torch.exp(-(box / area) * inv_h2)
            num = num + w * s[:, t:t + H, t:t + W]
            den = den + w
    num = num + xp[:, pad:pad + H, pad:pad + W]
    den = den + 1.0
    return num / den
