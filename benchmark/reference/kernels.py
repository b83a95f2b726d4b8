"""The kernels' plain versions, frozen copies of the port's
(`ops/cc_kernels.propagate_plain`, `ops/nlm_kernels.nlm_plain`): the
masked min-propagation fixpoint behind Canny's hysteresis and the CC
filter, and non-local means. Plain PyTorch, on any device."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import _pad_hw_reflect101

INT32_MAX = 2 ** 31 - 1
_MAX_TEMPLATE = 11


def _check_propagate(state0: torch.Tensor, fg: torch.Tensor, pool_iters: int,
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


def propagate(state0: torch.Tensor, fg: torch.Tensor, *, pool_iters: int,
                    max_iters: int, connectivity: int = 8) -> torch.Tensor:
    """The min-propagation fixpoint in plain PyTorch, on any device, with the same schedule."""
    _check_propagate(state0, fg, pool_iters, max_iters, connectivity)
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


def _check_nlm(x: torch.Tensor, h: float, template: int, search: int) -> None:
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
    """Non-local means in plain PyTorch, on any device: for each non-centre offset,
    the squared difference with the shifted plane, a box sum over H then
    over W (terms in order, as the JAX scan sums them), the weight
    exp(-d2 / template^2 / h^2) and the two accumulators; the centre pixel
    then enters with weight 1."""
    _check_nlm(x, h, template, search)
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
