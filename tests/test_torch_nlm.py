"""Non-local means: the port's plain version (unet_tpu_torch.ops.nlm_kernels.
nlm_plain) against the JAX package's XLA scan (unet_tpu.ops.frames.
nlm_denoise) and its Pallas kernel (unet_tpu.ops.nlm_pallas.nlm_padded, in
interpret mode, as tests/test_nlm_pallas.py runs it). The CUDA kernel is held
against the plain version on the card in tests/test_torch_cuda_kernels.py.

Tolerance: rtol 2e-5, atol 2e-3 on 0-255 (chip_smoke.NLM_TOL), the JAX
package's own gate for its kernel against the XLA path; the four differ in
summation order and in how the weight's exponent is scaled. The parity test
prints the max difference it measures (run with `-s`).
"""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import NLM_TOL, _nlm_weight_pairs, noisy_planes
from unet_tpu.ops import frames as jframes
from unet_tpu.ops import nlm_pallas
from unet_tpu_torch import _build
from unet_tpu_torch.ops import frames, nlm_kernels


def _inputs(rng, kind):
    if kind == "uniform":      # the input of tests/test_nlm_pallas.py
        return (rng.random((2, 40, 56)) * 255).astype(np.float32)
    return noisy_planes((2, 40, 56), seed=7)


def _pallas(img, h, template, search):
    pad = search // 2 + template // 2
    x = jnp.pad(jnp.asarray(img), ((0, 0), (pad, pad), (pad, pad)), mode="reflect")
    return np.asarray(nlm_pallas.nlm_padded(x, h, template, search)[:, pad:-pad, pad:-pad])


@pytest.mark.parametrize("kind", ["uniform", "scene"])
@pytest.mark.parametrize("search,template", [(9, 5), (21, 7)])
def test_nlm_plain_matches_jax(rng, kind, search, template):
    img = _inputs(rng, kind)
    got = nlm_kernels.nlm_plain(torch.from_numpy(img), 10.0, template, search).numpy()
    assert got.shape == img.shape and got.dtype == np.float32
    xla = np.asarray(jframes.nlm_denoise(jnp.asarray(img), h=10.0, template=template,
                                         search=search))
    pallas = _pallas(img, 10.0, template, search)
    print(f"nlm_plain {kind} search {search} template {template}: max |d| vs XLA scan "
          f"{np.abs(got - xla).max():.3g}, vs Pallas (interpret) {np.abs(got - pallas).max():.3g}")
    np.testing.assert_allclose(got, xla, **NLM_TOL)
    np.testing.assert_allclose(got, pallas, **NLM_TOL)
    if kind == "scene":        # the weights matter: the output moved
        assert np.abs(got - img).mean() > 1.0


def test_nlm_denoise_leading_dims(rng):
    img = noisy_planes((2, 3, 30, 34), seed=1)
    got = frames.nlm_denoise(torch.from_numpy(img), 12.0, 5, 9).numpy()
    want = np.asarray(jframes.nlm_denoise(jnp.asarray(img), 12.0, 5, 9))
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, **NLM_TOL)


def test_nlm_denoises(rng):
    clean = np.full((1, 40, 56), 128.0, np.float32)
    noisy = clean + rng.normal(0, 12, clean.shape).astype(np.float32)
    out = nlm_kernels.nlm(torch.from_numpy(noisy), 10.0, 7, 21).numpy()
    assert np.abs(out - clean).mean() < 0.4 * np.abs(noisy - clean).mean()


def test_nlm_dispatch_and_checks(rng):
    x = torch.from_numpy(noisy_planes((1, 30, 34)))
    before = nlm_kernels.launches
    out = nlm_kernels.nlm(x, 10.0, 5, 9)
    assert nlm_kernels.launches == before       # CPU: plain version, no launch
    assert torch.equal(out, nlm_kernels.nlm_plain(x, 10.0, 5, 9))
    for bad in (dict(x=x.double()), dict(x=x[0]), dict(template=4), dict(template=13),
                dict(search=8), dict(h=0.0), dict(x=x[:, :12, :]),
                dict(x=x.to("meta"))):
        kw = dict(x=x, h=10.0, template=7, search=21)
        kw.update(bad)
        with pytest.raises(ValueError):
            nlm_kernels.nlm(kw["x"], kw["h"], kw["template"], kw["search"])


# -- a numpy model of csrc/nlm.cu's tiling and summation order ---------------

def _tiling():
    """(kRows, kWarps, kCols), read from csrc/nlm.cu, so that the model
    follows the kernel's geometry when it is retuned."""
    src = (_build.CSRC / "nlm.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kRows", "kWarps", "kCols"))


_ROWS, _WARPS, _COLS = _tiling()


def _up(v, d):
    """__shfl_up_sync over the lane axis (last): lane l reads lane l - d; the
    first d lanes keep their own value."""
    return np.concatenate([v[..., :d], v[..., :-d]], axis=-1) if d else v


def _down(v, d):
    """__shfl_down_sync: lane l reads lane l + d; the last d keep their own."""
    return np.concatenate([v[..., d:], v[..., -d:]], axis=-1) if d else v


def _box_rows(sq, n):
    """box_rows<N>: sums of 2, 4, 8 rows, then the binary pieces of n left
    to right, over axis -2 (the strip's rows)."""
    top = n.bit_length() - 1
    s = [sq]
    for k in range(1, top + 1):
        h = 1 << (k - 1)
        s.append(s[-1][..., :-h, :] + s[-1][..., h:, :])
    rows = sq.shape[-2] - n + 1
    t = s[top][..., :rows, :]
    off = 1 << top
    for k in range(top - 1, -1, -1):
        if (n >> k) & 1:
            t = t + s[k][..., off:off + rows, :]
            off += 1 << k
    return t


def _box_cols(a, b, T):
    """box_cols<T>: the lane's two box sums from every lane's column sums."""
    if T == 0:
        return a, b
    q = a + b
    m = T // 2
    if T % 2:
        c = _up(q, m) if m else q
        for k in range(m - 1, 0, -1):
            c = c + _up(q, k)
        if m:
            c = c + q
        for k in range(1, m + 1):
            c = c + _down(q, k)
        return _up(b, m + 1) + c, c + _down(a, m + 1)
    c = q
    for k in range(1, m):
        c = _up(q, k) + c + _down(q, k)
    return _up(q, m) + c + _down(a, m), _up(b, m) + c + _down(q, m)


def _kernel_model(x, h, template, search):
    """What csrc/nlm.cu computes, block by block, warp by warp, lane by lane:
    tiles of 64 - 2T columns by kWarps * kRows rows, staged with reflect-101
    indices and the kernel's clamp, strips of two columns a lane, the
    fixed-order row sums, the shuffles with their edge behaviour, the
    default weight route (exp2 of the box sum times -log2(e) / (h^2 t^2))
    and the store mask. All in float32; it differs from the kernel only in
    FMA contraction and the last bits of exp2. Also returns how often each
    output pixel was stored."""
    B, H, W = x.shape
    R, T = search // 2, template // 2
    halo, TX, TY = R + T, _COLS - 2 * T, _WARPS * _ROWS
    nby, nbx = -(-H // TY), -(-W // TX)
    SW, SH, n_in = _COLS + 2 * R, TY + 2 * halo, _ROWS + 2 * T

    def refl(i, n):
        i = np.abs(i)
        return np.clip(np.where(i >= n, 2 * (n - 1) - i, i), 0, n - 1)

    ys = refl(np.arange(nby)[:, None] * TY - halo + np.arange(SH), H)     # (nby, SH)
    xs = refl(np.arange(nbx)[:, None] * TX - halo + np.arange(SW), W)     # (nbx, SW)
    X = x[:, ys[:, None, :, None], xs[None, :, None, :]]     # (B, nby, nbx, SH, SW)
    # input row i of warp w: staged row w * kRows + R + i
    rows = (np.arange(_WARPS)[:, None] * _ROWS + R + np.arange(n_in))   # (warps, n_in)
    ctr = X[:, :, :, rows, R:R + _COLS]                      # (..., warps, n_in, 64)
    scale = np.float32(-np.log2(np.e) / (h * h * float(template) ** 2))
    num = np.zeros(ctr.shape[:-2] + (_ROWS, _COLS), np.float32)
    den = np.zeros_like(num)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            sh = X[:, :, :, rows + dy, R + dx:R + dx + _COLS]
            sq = (ctr - sh) ** 2
            v = _box_rows(sq, 2 * T + 1)                     # (..., kRows, 64)
            s0, s1 = _box_cols(v[..., 0::2], v[..., 1::2], T)
            s = np.stack([s0, s1], axis=-1).reshape(v.shape)
            w = np.exp2(s * scale)
            num += w * sh[..., T:T + _ROWS, :]
            den += w
    out = np.zeros_like(x)
    stores = np.zeros(x.shape, np.int64)
    col = np.arange(_COLS)
    keep = (col >= T) & (col <= _COLS - 1 - T)
    for by in range(nby):
        for bx in range(nbx):
            gx = bx * TX - T + col
            kc = keep & (gx < W)
            for wp in range(_WARPS):
                gy = by * TY + wp * _ROWS + np.arange(_ROWS)
                kr = gy < H
                vals = num[:, by, bx, wp] / den[:, by, bx, wp]
                out[:, gy[kr][:, None], gx[kc][None]] = vals[:, kr][:, :, kc]
                stores[:, gy[kr][:, None], gx[kc][None]] += 1
    return out, stores


@pytest.mark.parametrize("search,template", [(9, 5), (21, 7), (21, 3), (11, 11), (3, 1)])
@pytest.mark.parametrize("plane", ["narrow", "ragged", "smallest"])
def test_kernel_model_matches_plain(search, template, plane):
    """The kernel's tiling against nlm_plain: a plane narrower than one
    strip, one with partial tiles on both axes, and the smallest plane the
    wrapper takes (R + T = H - 1 = W - 1)."""
    pad = search // 2 + template // 2
    shape = {"narrow": (2, 40, 56), "ragged": (1, 70, 130),
             "smallest": (1, pad + 1, pad + 1)}[plane]
    img = noisy_planes(shape, seed=11)
    got, stores = _kernel_model(img, 10.0, template, search)
    assert (stores == 1).all(), "an output pixel stored other than once"
    want = nlm_kernels.nlm_plain(torch.from_numpy(img), 10.0, template, search).numpy()
    np.testing.assert_allclose(got, want, **NLM_TOL)


@pytest.mark.parametrize("shape,search", [((1, 6, 7), 5), ((2, 9, 5), 3), ((1, 12, 14), 9)])
def test_nlm_bound_counts_each_weight_pair_once(shape, search):
    """chip_smoke's bound counts one weight per unordered pair {p, p + o}
    (d2 is symmetric), the centre none: against an enumeration of pairs."""
    B, H, W = shape
    r = search // 2
    pairs = set()
    for y in range(H):
        for x in range(W):
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    if dy or dx:
                        pairs.add(frozenset([(y, x), (y + dy, x + dx)]))
    updates = B * H * W * (search * search - 1)
    assert _nlm_weight_pairs(shape, search) == (B * len(pairs), updates)
