"""Masked min-propagation fixpoint: the CUDA kernel and its plain version.

Counterpart of unet_tpu/ops/cc_pallas.py `propagate` (:152-190), the TPU
kernel behind Canny's hysteresis (C=1) and the burr CC filter's label/bbox
propagation (C=4). The kernel is `csrc/cc_propagate.cu` (its header says how
it is built and bounded); `propagate_plain` is the same function in plain
PyTorch.

Both follow the reference's SCHEDULE, not only its fixpoint: per outer
iteration `pool_iters` Jacobi masked min-pools, then a segmented run-min
along rows, then along columns, until nothing changes or `max_iters`
iterations ran. So both equal the JAX package even where it truncates.

`propagate` dispatches on the device of its input: a CPU tensor goes to
`propagate_plain`, a CUDA tensor launches the kernel or raises. `launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_tpu_torch import _build

INT32_MAX = 2 ** 31 - 1

launches = 0


def _check(state0: torch.Tensor, fg: torch.Tensor, pool_iters: int,
           max_iters: int, connectivity: int) -> None:
    if state0.dtype != torch.int32 or state0.ndim != 4:
        raise ValueError(f"state0 must be (B, C, H, W) int32, got "
                         f"{tuple(state0.shape)} {state0.dtype}")
    B, _, H, W = state0.shape
    if fg.dtype != torch.bool or tuple(fg.shape) != (B, H, W):
        raise ValueError(f"fg must be ({B}, {H}, {W}) bool, got "
                         f"{tuple(fg.shape)} {fg.dtype}")
    if fg.device != state0.device:
        raise ValueError(f"state0 on {state0.device} but fg on {fg.device}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if pool_iters < 0 or max_iters < 0:
        raise ValueError("pool_iters and max_iters must be >= 0")


def propagate(state0: torch.Tensor, fg: torch.Tensor, *, pool_iters: int,
              max_iters: int, connectivity: int = 8) -> torch.Tensor:
    """Run the CC min-propagation fixpoint.

    state0: (B, C, H, W) int32 seed values (label / bbox channels).
    fg:     (B, H, W) bool foreground mask.
    Returns the (B, C, H, W) state after the reference's schedule.
    Background pixels keep their seeds.
    """
    global launches
    _check(state0, fg, pool_iters, max_iters, connectivity)
    if state0.device.type == "cpu":
        return propagate_plain(state0, fg, pool_iters=pool_iters,
                               max_iters=max_iters, connectivity=connectivity)
    if state0.device.type != "cuda":
        raise ValueError(f"propagate runs on cpu or cuda, not {state0.device}")
    if not (state0.is_contiguous() and fg.is_contiguous()):
        raise ValueError("propagate needs contiguous state0 and fg")
    B, C, H, W = state0.shape
    if H * W >= 2 ** 31:
        raise ValueError(f"plane of {H}x{W} is too large for the kernel")
    lib = _build.load("cc_propagate")
    fn = lib.cc_propagate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(state0)
    scratch = torch.empty_like(state0)
    with torch.cuda.device(state0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(state0.data_ptr(), fg.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B, C, H, W, pool_iters, max_iters,
                 connectivity, stream)
    if err != 0:
        raise RuntimeError(f"cc_propagate launch failed: CUDA error {err}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _min_pool(s: torch.Tensor, fgC: torch.Tensor, connectivity: int) -> torch.Tensor:
    """One masked 3x3 (or cross) min-pool step == cc_pallas._kernel.pool."""
    H, W = s.shape[-2:]
    m = torch.where(fgC, s, INT32_MAX)
    p = F.pad(m, (1, 1, 1, 1), value=INT32_MAX)
    o = m
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if (dr == 0 and dc == 0) or (connectivity == 4 and dr and dc):
                continue
            o = torch.minimum(o, p[..., 1 + dr:1 + dr + H, 1 + dc:1 + dc + W])
    return torch.where(fgC, o, s)


def _run_min(s: torch.Tensor, fgC: torch.Tensor, dim: int) -> torch.Tensor:
    """Segmented min over each contiguous fg run along `dim` (-1: rows,
    -2: columns). Each run gets an id from a cumulative count of run heads;
    the min per id is one scatter-reduce."""
    v = s.transpose(dim, -1)
    f = fgC.transpose(dim, -1)
    head = f & ~F.pad(f[..., :-1], (1, 0), value=False)
    ids = torch.cumsum(head.reshape(-1), 0)
    vals = torch.where(f, v, INT32_MAX).reshape(-1)
    mins = torch.full((int(ids[-1]) + 1 if ids.numel() else 1,), INT32_MAX,
                      dtype=s.dtype, device=s.device)
    mins = mins.scatter_reduce(0, ids, vals, "amin")
    out = torch.where(f, mins[ids].reshape(v.shape), v)
    return out.transpose(dim, -1)


def propagate_plain(state0: torch.Tensor, fg: torch.Tensor, *, pool_iters: int,
                    max_iters: int, connectivity: int = 8) -> torch.Tensor:
    """`propagate` in plain PyTorch, on any device, with the same schedule."""
    _check(state0, fg, pool_iters, max_iters, connectivity)
    fgC = fg[:, None].expand(state0.shape)
    s = state0
    for _ in range(max_iters):
        m = s
        for _ in range(pool_iters):
            m = _min_pool(m, fgC, connectivity)
        m = _run_min(m, fgC, -1)
        m = _run_min(m, fgC, -2)
        changed = bool((m != s).any())
        s = m
        if not changed:
            break
    return s.clone() if s is state0 else s
