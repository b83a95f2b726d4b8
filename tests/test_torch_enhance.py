"""Parity of the port's enhancement ops (unet_tpu_torch.ops.color Lab,
clahe, image filters, frames, stages.enhance_frames) with the JAX package,
on the same numpy inputs.

Tolerances (each float test prints the max difference it measures; run
with `-s` to see them):
  * CLAHE, filter2d and sharpen are bit-identical (integer LUT work, the
    same float order, including the tile-parity-dependent blend order).
  * Lab goes through `pow`, whose last bit differs between PyTorch and XLA:
    over all 2**24 BGR colours |dL|, |db| <= 6.1e-5 and |da| <= 1.6e-4,
    gated at 1e-3, and round(L), which CLAHE consumes, differs for 104
    colours, each within 3.1e-5 of a .5 tie (tests/torch_lab_sweep.py).
  * exp differs in the last bit too: the bilateral filter is gated at 1e-3,
    the NLM-denoised and the enhanced frames at 0.1 on 0-255.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unet_tpu.ops import clahe as jclahe
from unet_tpu.ops import color as jcolor
from unet_tpu.ops import frames as jframes
from unet_tpu.ops import image as jimage
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.ops import clahe, color, frames, image
from unet_tpu_torch.pipeline import presets, stages


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


def _report(what: str, got, want) -> None:
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    print(f"{what}: max |d| {d:.3g}")


def _colours(n: int, seed: int) -> np.ndarray:
    """n distinct BGR colours of the 2**24, as float32 (n, 3)."""
    idx = np.random.default_rng(seed).choice(1 << 24, n, replace=False)
    return np.stack([(idx >> 16) & 255, (idx >> 8) & 255, idx & 255], -1).astype(np.float32)


def test_bgr2lab_on_a_colour_sample():
    bgr = _colours(1 << 18, seed=0)
    got = [v.numpy() for v in color.bgr2lab(torch.from_numpy(bgr))]
    want = [np.asarray(v) for v in jax.jit(jcolor.bgr2lab)(jnp.asarray(bgr))]
    for name, g, w in zip("Lab", got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        _report(f"bgr2lab {name}, 2**18 colours", g, w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    # round(L): equal away from a .5 tie; the last-bit difference of pow can
    # only flip a level whose L sits on a tie
    L, JL = got[0], want[0]
    differ = np.round(L) != np.round(JL)
    assert differ.sum() <= 4
    assert np.all(np.abs(np.abs(JL[differ] - np.floor(JL[differ])) - 0.5) < 1e-4)


def test_lab2bgr_round_trip(rng):
    bgr = _colours(1 << 16, seed=1).reshape(256, 256, 3)
    L, a, b = (np.asarray(v) for v in jcolor.bgr2lab(jnp.asarray(bgr)))
    # perturb off the forward image, as CLAHE and NLM do
    L = np.clip(np.round(L) + rng.integers(-3, 4, L.shape), 0, 255).astype(np.float32)
    a = (a + rng.normal(0, 2, a.shape)).astype(np.float32)
    b = (b + rng.normal(0, 2, b.shape)).astype(np.float32)
    got = color.lab2bgr(*(torch.from_numpy(v) for v in (L, a, b))).numpy()
    want = np.asarray(jcolor.lab2bgr(*(jnp.asarray(v) for v in (L, a, b))))
    assert got.shape == want.shape == (256, 256, 3) and got.dtype == want.dtype
    _report("lab2bgr, 2**16 colours", got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    back = color.lab2bgr(*color.bgr2lab(torch.from_numpy(bgr))).numpy()
    assert np.abs(back - bgr).max() < 0.05


@pytest.mark.parametrize("shape", [(93, 121), (96, 128), (112, 200), (2, 56, 100)])
@pytest.mark.parametrize("clip,grid", [(3.0, (8, 8)), (2.0, (4, 4))])
def test_clahe_bit_identical(rng, shape, clip, grid):
    # (96, 128) at (8, 8) and (56, 100) at (4, 4) have even tile sides (the
    # JAX one-hot blend); (93, 121) and (112, 200) at (8, 8) are odd (gather)
    g = np.round(rng.random(shape) * 255).astype(np.float32)
    g[..., :10, :10] = 255.0          # a clipped histogram
    _eq(clahe.clahe(torch.from_numpy(g), clip, grid), jclahe.clahe(jnp.asarray(g), clip, grid))


def test_clahe_main_path_geometry_is_even():
    """At 448x800 with grid (8, 8) the tiles are 56x100, both even: the
    JAX package blends with precomputed weights there."""
    g = np.round(np.random.default_rng(3).random((448, 800)) * 255).astype(np.float32)
    _eq(clahe.clahe(torch.from_numpy(g), 3.0, (8, 8)), jclahe.clahe(jnp.asarray(g), 3.0, (8, 8)))


@pytest.mark.parametrize("channels", [False, True])
def test_filter2d_and_sharpen(rng, channels):
    shape = (2, 30, 44, 3) if channels else (2, 30, 44)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    k = rng.normal(0, 1, (3, 5)).astype(np.float32)
    k[1, 2] = 0.0
    _eq(image.filter2d(torch.from_numpy(x), k, channel_dim=channels),
        jimage.filter2d(jnp.asarray(x), k, channel_dim=channels))
    _eq(image.sharpen(torch.from_numpy(x), channel_dim=channels),
        jimage.sharpen(jnp.asarray(x), channel_dim=channels))


@pytest.mark.parametrize("channels", [False, True])
def test_bilateral_filter(rng, channels):
    shape = (2, 30, 44, 3) if channels else (2, 30, 44)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    got = image.bilateral_filter(torch.from_numpy(x), d=7, sigma_color=25.0,
                                 sigma_space=5.0, channel_dim=channels).numpy()
    want = np.asarray(jimage.bilateral_filter(jnp.asarray(x), d=7, sigma_color=25.0,
                                              sigma_space=5.0, channel_dim=channels))
    assert got.shape == want.shape and got.dtype == want.dtype
    _report(f"bilateral_filter {shape}", got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_nlm_denoise_colored():
    from chip_smoke import noisy_planes
    bgr = np.stack([noisy_planes((2, 40, 56), seed=c) for c in range(3)], -1)
    got = frames.nlm_denoise_colored(torch.from_numpy(bgr)).numpy()
    want = np.asarray(jframes.nlm_denoise_colored(jnp.asarray(bgr)))
    assert got.shape == want.shape == bgr.shape and got.dtype == want.dtype
    _report("nlm_denoise_colored (2, 40, 56, 3)", got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)


@pytest.mark.parametrize("denoise", ["nlm", "bilateral", "none"])
def test_enhance_frames(denoise):
    from chip_smoke import synthetic_frames
    bgr = synthetic_frames(2, 56, 100, seed=4, patch=10).astype(np.float32)
    cfg = presets.enhanced(denoise=denoise)
    jcfg = jpresets.enhanced(denoise=denoise)
    got = stages.enhance_frames(torch.from_numpy(bgr), cfg).numpy()
    want = np.asarray(jstages.enhance_frames(jnp.asarray(bgr), jcfg))
    assert got.shape == want.shape == bgr.shape and got.dtype == want.dtype
    _report(f"enhance_frames denoise={denoise} (2, 56, 100, 3)", got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)
