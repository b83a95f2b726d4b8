"""Masked min-propagation fixpoint: the CUDA kernels and their plain version.

Counterpart of unet_tpu/ops/cc_pallas.py `propagate` (:152-190), the TPU
kernel behind Canny's hysteresis (C=1) and the burr CC filter's label/bbox
propagation (C=4). The kernels are in `csrc/cc_propagate.cu` (its header
says how they are built and bounded); `propagate_plain` is the same function
in plain PyTorch.

All follow the reference's SCHEDULE, not only its fixpoint: per outer
iteration `pool_iters` Jacobi masked min-pools, then a segmented run-min
along rows, then along columns, until nothing changes or `max_iters`
iterations ran. So all equal the JAX package even where it truncates.

`propagate` dispatches on the device of its input: a CPU tensor goes to
`propagate_plain`; a CUDA tensor launches a kernel or raises. Which kernel
is decided from the plane's shape before the launch (`route`): a plane
whose stripe fits a thread-block cluster's shared memory takes the cluster
kernel (`propagate_cluster`), a larger one the global-memory kernel
(`propagate_global`), as `cc_pallas.supported` splits the JAX package's
routes. `launches` counts every kernel launch; `launches_cluster` and
`launches_global` count each route's, and `launches` is their sum;
`launches_per_cluster` splits the cluster route's by cluster size.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Set, Tuple

import torch
import torch.nn.functional as F

from unet_tpu_torch import _build

INT32_MAX = 2 ** 31 - 1

# The cluster route: K CTAs per (image, channel) plane, each holding a stripe
# of ceil(H / K) rows in shared memory (csrc/cc_propagate.cu's header).
CLUSTER_SIZES = (8, 16)          # 8 is portable; 16 where a stripe of 8 does not fit
SMEM_LIMIT = 232448              # opt-in shared memory per block on sm_90

launches = 0
launches_cluster = 0
launches_global = 0
launches_per_cluster = {K: 0 for K in CLUSTER_SIZES}

_prepared: Set[Tuple[int, int, int, int]] = set()   # (device, H, W, K) checked
_prepare_lock = threading.Lock()


def cluster_smem_bytes(H: int, W: int, K: int) -> int:
    """Shared memory one CTA of a K-CTA cluster needs for an H x W plane:
    its stripe with a pad column each side, four halo rows, the stripe's
    mask bits, three column summaries and two stop words (int32 each)."""
    S = -(-H // K)
    P, NW = W + 2, -(-W // 32)
    return 4 * (S * P + 4 * P + S * NW + 3 * W + 2)


def cluster_fits(H: int, W: int, K: int) -> bool:
    # one thread per column; a thread keeps at most 32 (1024 threads) or 64
    # (512 threads) pixels of its column in registers
    S = -(-H // K)
    threads = 32 * -(-W // 32)
    if cluster_smem_bytes(H, W, K) > SMEM_LIMIT:
        return False
    return (S <= 32 and threads <= 1024) or (S <= 64 and threads <= 512)


def route(H: int, W: int) -> Tuple[str, Optional[int]]:
    """The kernel an H x W plane takes: ("cluster", K) with the smallest
    cluster size K whose stripe fits, else ("global", None). The kernels
    handle each (image, channel) plane alone, so neither the batch nor the
    channel count enters."""
    for K in CLUSTER_SIZES:
        if cluster_fits(H, W, K):
            return "cluster", K
    return "global", None


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
    _check(state0, fg, pool_iters, max_iters, connectivity)
    kw = dict(pool_iters=pool_iters, max_iters=max_iters, connectivity=connectivity)
    if state0.device.type == "cpu":
        return propagate_plain(state0, fg, **kw)
    which, K = route(*state0.shape[-2:])
    if which == "cluster":
        return propagate_cluster(state0, fg, cluster=K, **kw)
    return propagate_global(state0, fg, **kw)


def _cuda_args(state0: torch.Tensor, fg: torch.Tensor, pool_iters: int,
               max_iters: int, connectivity: int) -> None:
    _check(state0, fg, pool_iters, max_iters, connectivity)
    if state0.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda tensors, not {state0.device}")
    if not (state0.is_contiguous() and fg.is_contiguous()):
        raise ValueError("the kernels need contiguous state0 and fg")
    H, W = state0.shape[-2:]
    if H * W >= 2 ** 31:
        raise ValueError(f"plane of {H}x{W} is too large for the kernels")


_ARGTYPES = {
    "cc_propagate_global": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "cc_propagate_cluster": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "cc_propagate_cluster_prepare": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _call(name: str, *args) -> None:
    """Call csrc/cc_propagate.cu's C function `name`; raise on a CUDA error."""
    fn = getattr(_build.load("cc_propagate"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def propagate_cluster(state0: torch.Tensor, fg: torch.Tensor, *, pool_iters: int,
                      max_iters: int, connectivity: int = 8,
                      cluster: int = 8) -> torch.Tensor:
    """The cluster kernel: one cluster of `cluster` CTAs per plane, the plane
    in their shared memory. Raises if the plane's stripe does not fit or the
    card cannot hold one such cluster."""
    global launches, launches_cluster
    _cuda_args(state0, fg, pool_iters, max_iters, connectivity)
    B, C, H, W = state0.shape
    if cluster not in CLUSTER_SIZES or not cluster_fits(H, W, cluster):
        raise ValueError(f"a {H}x{W} plane does not fit a cluster of {cluster} CTAs "
                         f"(route: {route(H, W)})")
    out = torch.empty_like(state0)
    with torch.cuda.device(state0.device):
        key = (state0.device.index or 0, H, W, cluster)
        with _prepare_lock:
            if key not in _prepared:
                active = ctypes.c_int(0)
                _call("cc_propagate_cluster_prepare", H, W, cluster,
                      ctypes.addressof(active))
                if active.value <= 0:
                    raise RuntimeError(
                        f"the card holds no cluster of {cluster} CTAs with "
                        f"{cluster_smem_bytes(H, W, cluster)} B of shared memory each")
                _prepared.add(key)
        stream = torch.cuda.current_stream().cuda_stream
        _call("cc_propagate_cluster", state0.data_ptr(), fg.data_ptr(), out.data_ptr(),
              B, C, H, W, cluster, pool_iters, max_iters, connectivity, stream)
    launches += 1
    launches_cluster += 1
    launches_per_cluster[cluster] += 1
    return out


def propagate_global(state0: torch.Tensor, fg: torch.Tensor, *, pool_iters: int,
                     max_iters: int, connectivity: int = 8) -> torch.Tensor:
    """The global-memory kernel: one block per plane, the plane and a
    ping-pong copy in device memory. Takes any plane."""
    global launches, launches_global
    _cuda_args(state0, fg, pool_iters, max_iters, connectivity)
    B, C, H, W = state0.shape
    out = torch.empty_like(state0)
    scratch = torch.empty_like(state0)
    with torch.cuda.device(state0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _call("cc_propagate_global", state0.data_ptr(), fg.data_ptr(), out.data_ptr(),
              scratch.data_ptr(), B, C, H, W, pool_iters, max_iters, connectivity, stream)
    launches += 1
    launches_global += 1
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
