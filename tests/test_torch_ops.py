"""Parity of the port's image ops (unet_tpu_torch.ops) with the JAX package:
the same numpy inputs through both, bit-identical outputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unet_tpu.ops import color as jcolor
from unet_tpu.ops import edges as jedges
from unet_tpu.ops import image as jimage
from unet_tpu.ops import morph as jmorph
from unet_tpu_torch.ops import color, edges, image, morph


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_resize_bilinear_frame_to_model(rng):
    # 448x800 -> 512^2 is an upscale of the rows: row 0's source index is
    # -0.0625, where the index (not the coordinate) is clamped
    frames = rng.uniform(0, 255, (2, 448, 800, 3)).astype(np.float32)
    _eq(image.resize_bilinear(torch.from_numpy(frames), (512, 512)),
        jimage.resize_bilinear(jnp.asarray(frames), (512, 512)))


def test_resize_bilinear_uint8_rounds(rng):
    img = rng.integers(0, 256, (3, 40, 56), dtype=np.uint8)
    _eq(image.resize_bilinear(torch.from_numpy(img), (64, 48), channel_dim=False),
        jimage.resize_bilinear(jnp.asarray(img), (64, 48), channel_dim=False))


def test_resize_nearest_model_to_frame(rng):
    mask = rng.random((2, 512, 512)) < 0.5
    _eq(image.resize_nearest(torch.from_numpy(mask), (448, 800), channel_dim=False),
        jimage.resize_nearest(jnp.asarray(mask), (448, 800), channel_dim=False))


@pytest.mark.parametrize("ksize,sigma", [(5, 1.0), (3, 0.0), (7, 2.0)])
def test_gaussian_blur_round(rng, ksize, sigma):
    gray = rng.uniform(0, 255, (2, 60, 84)).astype(np.float32)
    got = torch.round(image.gaussian_blur(torch.from_numpy(gray), ksize, sigma,
                                          channel_dim=False))
    want = jnp.round(jimage.gaussian_blur(jnp.asarray(gray), ksize, sigma,
                                          channel_dim=False))
    _eq(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_bgr2gray(rng, dtype):
    # float32 exactly: each weight rounds to float32 and the sum runs left to
    # right on both sides (the pipeline's gray is float and unrounded)
    bgr = rng.uniform(0, 255, (2, 48, 64, 3)).astype(dtype)
    _eq(color.bgr2gray(torch.from_numpy(bgr)), jcolor.bgr2gray(jnp.asarray(bgr)))
    _eq(color.bgr2rgb(torch.from_numpy(bgr)), jcolor.bgr2rgb(jnp.asarray(bgr)))


@pytest.mark.parametrize("k", [2, 3, 8])
def test_morphology_ellipse(rng, k):
    mask = rng.random((2, 40, 56)) < 0.3
    mask[0, 10:20, 10:30] = True
    mask[1, 0:5, 50:56] = True          # touches the border
    se = jmorph.ellipse_kernel(k)
    assert np.array_equal(morph.ellipse_kernel(k), se)
    t, j = torch.from_numpy(mask), jnp.asarray(mask)
    for fn, jfn in ((morph.dilate, jmorph.dilate), (morph.erode, jmorph.erode),
                    (morph.open_, jmorph.open_), (morph.close_, jmorph.close_),
                    (morph.outer_band, jmorph.outer_band)):
        _eq(fn(t, se), jfn(j, se))


@pytest.mark.parametrize("seed", [0, 1])
def test_canny_textured(seed):
    # the pattern of tests/test_cc_pallas.py::test_canny_pallas_path_matches
    r = np.random.default_rng(seed)
    img = (r.random((2, 56, 72)) * 255).astype(np.float32)
    img[:, 20:36, 10:60] += 90.0
    _eq(edges.canny(torch.from_numpy(img), 50.0, 150.0),
        jedges.canny(jnp.asarray(img), 50.0, 150.0))
