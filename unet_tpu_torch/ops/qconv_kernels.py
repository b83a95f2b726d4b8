"""int8 3x3 convolution with its requantization fused: the CUDA kernel and
its plain version.

Replaces, on the int8 forward (models/quantized.py), the JAX package's
`_qconv` + `_requant` (unet_tpu/models/quantized.py:183-219), which XLA
runs as lax.conv_general_dilated s8 x s8 -> s32 and an elementwise chain.
Not a TPU kernel: PyTorch has no eager CUDA int8 convolution. The kernels
are in `csrc/qconv.cu` (its header says how they are built and bounded).

Layouts, as in the JAX package but with the weights OHWI:
  x     (B, H, W, C) int8 NHWC, or a pair (a, b) of such tensors that share
        (B, H, W): the decoder's concat [a, b] along channels, never
        materialised
  wq    (N, 3, 3, C) int8, C = Ca + Cb for a pair
  mult, bias  (N,) in the compute type (bf16, or float32)
  out   (B, H, W, N) int8 = clip(round(acc.to(type) * mult + bias), 0, 127),
        acc the int32 stride-1, zero-padded conv; each op rounds to the type
        (PyTorch's and XLA's arithmetic), round half to even.

Both kernels and `qconv_plain` agree bit for bit: the accumulator is exact in
all three (the plain version sums in float64, exact for every |acc| <=
127 * 127 * 9 * 768 < 2**53), and the epilogue rounds at the same places.

`qconv` calls the custom op `torch.ops.unet_tpu_torch.qconv` (its one or
two sources a `Tensor[]`), which dispatches on the device of its input: a
CPU tensor goes to `qconv_plain`, a CUDA tensor launches a kernel or raises;
its fake implementation lets `torch.export` trace through it. Which kernel
is a pure function of the shapes, the plane width and the alignment (`route`):
the wgmma kernel for every source width a multiple of 32 (17 of the int8
forward's 18 convs), the c3 kernel for one source of 3 channels
(conv0_0.conv1), the mma.sync kernel otherwise (ragged or misaligned
shapes). There is no fallback from one to another. `launches_wgmma`,
`launches_c3` and `launches_sync` count each kernel's launches, `launches`
their sum.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple, Union

import torch
import torch.nn.functional as F

from unet_tpu_torch import _build

launches = 0         # every kernel launch: launches_wgmma + launches_c3 + launches_sync
launches_wgmma = 0
launches_c3 = 0
launches_sync = 0

Source = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
_TYPES = (torch.bfloat16, torch.float32)


def _check(x: Source, wq: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor):
    """The sources as a tuple, after checking shapes, types and devices."""
    srcs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if len(srcs) not in (1, 2):
        raise ValueError(f"x must be a tensor or a pair of tensors, got {len(srcs)}")
    for s in srcs:
        if s.dtype != torch.int8 or s.ndim != 4:
            raise ValueError(f"x must be (B, H, W, C) int8, got {tuple(s.shape)} {s.dtype}")
        if s.shape[:3] != srcs[0].shape[:3] or s.device != srcs[0].device:
            raise ValueError("the two sources of a pair must share (B, H, W) and the device")
    c = sum(s.shape[3] for s in srcs)
    if wq.dtype != torch.int8 or wq.ndim != 4 or tuple(wq.shape[1:]) != (3, 3, c):
        raise ValueError(f"wq must be (N, 3, 3, {c}) int8, got {tuple(wq.shape)} {wq.dtype}")
    n = wq.shape[0]
    for name, v in (("mult", mult), ("bias", bias)):
        if v.dtype not in _TYPES or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be ({n},) bf16 or float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if mult.dtype != bias.dtype:
        raise ValueError("mult and bias must share their type")
    for v in (wq, mult, bias):
        if v.device != srcs[0].device:
            raise ValueError(f"every argument must be on the device of x, {srcs[0].device}; "
                             f"got {v.device}")
    return srcs


def route(ca: int, cb: int, n: int, aligned: bool, width: int) -> Tuple[str, int]:
    """Which kernel and tile width a CUDA launch takes, from the shapes, the
    plane width and the alignment alone: ("wgmma", BN) when both sources'
    channel counts are multiples of 32, N is a multiple of 32 and the
    buffers are 16-byte aligned (17 of the 18 convs of the int8 forward);
    ("c3", 32) for one source of 3 channels with N a multiple of 32, aligned
    buffers and rows of a whole number of 16-byte chunks (3 * width % 16 ==
    0: conv0_0.conv1); else ("sync", BN), the mma.sync kernel with its byte
    path (ragged or misaligned shapes). BN is the largest of 128, 64 and 32
    that divides N (32 for the sync kernel's ragged N); the c3 kernel takes
    N in blocks of 32."""
    bn = next((t for t in (128, 64, 32) if n % t == 0), 32)
    if ca % 32 == 0 and cb % 32 == 0 and n % 32 == 0 and aligned:
        return "wgmma", bn
    if ca == 3 and cb == 0 and n % 32 == 0 and aligned and 3 * width % 16 == 0:
        return "c3", 32
    return "sync", bn


def _launch(srcs, wq: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
            force_sync: bool) -> torch.Tensor:
    """Checks what the kernels need and launches the routed kernel (or the
    sync kernel when `force_sync`); raises on a refused launch."""
    global launches, launches_wgmma, launches_c3, launches_sync
    dev = srcs[0].device
    if dev.type != "cuda":
        raise ValueError(f"qconv runs on cpu or cuda, not {dev}")
    for v in srcs + (wq, mult, bias):
        if not v.is_contiguous():
            raise ValueError("qconv needs contiguous tensors")
    B, H, W = srcs[0].shape[:3]
    N = wq.shape[0]
    a, b = srcs[0], (srcs[1] if len(srcs) == 2 else None)
    ca, cb = a.shape[3], (b.shape[3] if b is not None else 0)
    aligned = all(t.data_ptr() % 16 == 0 for t in srcs + (wq,))
    kind, bn = route(ca, cb, N, aligned, W)
    if force_sync:
        kind = "sync"
    lib = _build.load("qconv")
    out = torch.empty((B, H, W, N), dtype=torch.int8, device=dev)
    bf16 = int(mult.dtype == torch.bfloat16)
    if kind == "c3":
        # (x, w, mult, bias, bf16, out, B, H, W, N, stream)
        fn = lib.qconv_s8_c3
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        args = (a.data_ptr(), wq.data_ptr(), mult.data_ptr(), bias.data_ptr(), bf16,
                out.data_ptr(), B, H, W, N)
    else:
        # (xa, ca, xb, cb, w, mult, bias, bf16, out, B, H, W, N, bn[, vec], stream)
        argtypes = ([ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                    + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5)
        if kind == "wgmma":
            fn, vec = lib.qconv_s8_wgmma, ()
        else:
            # the sync kernel's 16-byte copies take the shapes the wgmma route takes
            fn, vec = lib.qconv_s8_sync, (int(ca % 32 == 0 and cb % 32 == 0 and aligned),)
            argtypes.append(ctypes.c_int)
        fn.argtypes = argtypes + [ctypes.c_void_p]
        args = (a.data_ptr(), ca, b.data_ptr() if b is not None else None, cb,
                wq.data_ptr(), mult.data_ptr(), bias.data_ptr(), bf16, out.data_ptr(),
                B, H, W, N, bn, *vec)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"qconv launch failed ({kind} route, BN {bn}): CUDA error {err}")
    launches += 1
    if kind == "wgmma":
        launches_wgmma += 1
    elif kind == "c3":
        launches_c3 += 1
    else:
        launches_sync += 1
    return out


def qconv(x: Source, wq: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The fused int8 conv + requant; (B, H, W, N) int8. A CUDA input
    launches the kernel that `route` names."""
    srcs = _check(x, wq, mult, bias)
    if srcs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"qconv runs on cpu or cuda, not {srcs[0].device}")
    return torch.ops.unet_tpu_torch.qconv(list(srcs), wq, mult, bias)


@torch.library.custom_op("unet_tpu_torch::qconv", mutates_args=(), device_types="cpu")
def _qconv_op(x: List[torch.Tensor], wq: torch.Tensor, mult: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    return qconv_plain(tuple(x), wq, mult, bias)


@_qconv_op.register_kernel("cuda")
def _(x, wq, mult, bias):
    return _launch(tuple(x), wq, mult, bias, force_sync=False)


@_qconv_op.register_fake
def _(x, wq, mult, bias):
    return x[0].new_empty((*x[0].shape[:3], wq.shape[0]))


def qconv_sync(x: Source, wq: torch.Tensor, mult: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """`qconv` through the mma.sync kernel at any shape: the yardstick
    that the wgmma and c3 routes are timed against. Not on the main path."""
    srcs = _check(x, wq, mult, bias)
    if srcs[0].device.type == "cpu":
        return qconv_plain(x, wq, mult, bias)
    return _launch(srcs, wq, mult, bias, force_sync=True)


def conv_acc_plain(x: Source, wq: torch.Tensor) -> torch.Tensor:
    """The int32 accumulator of the stride-1, zero-padded 3x3 conv, on any
    device: nine tap products as float64 matrix products (exact for these
    integers in any summation order), summed in float64. (B, H, W, N) int32."""
    srcs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    x64 = torch.cat([s.to(torch.float64) for s in srcs], dim=-1)
    B, H, W, _ = x64.shape
    xp = F.pad(x64, (0, 0, 1, 1, 1, 1))
    w64 = wq.to(torch.float64)
    acc = torch.zeros((B, H, W, wq.shape[0]), dtype=torch.float64, device=x64.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + H, dx:dx + W, :] @ w64[:, dy, dx, :].T
    return acc.to(torch.int32)


def requant_plain(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """int32 accumulator -> int8 codes of the next layer's scale: the
    dequant, bias, ReLU and requant of unet_tpu/models/quantized.py
    `_requant` (:207-219), each op rounding to the compute type."""
    y = acc.to(mult.dtype) * mult + bias
    return torch.clamp(torch.round(y), 0, 127).to(torch.int8)


def qconv_plain(x: Source, wq: torch.Tensor, mult: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """`qconv` in plain PyTorch, on any device."""
    _check(x, wq, mult, bias)
    return requant_plain(conv_acc_plain(x, wq), mult, bias)
