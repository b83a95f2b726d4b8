"""Parity of the port's Sobel / Laplacian stack and the enhanced preset's
multiscale burr stage (unet_tpu_torch.ops.edges, pipeline.stages.
burr_multiscale / _burr_on_roi_crop) with the JAX package: bit-identical on
the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import enhanced_scenes
from unet_tpu.ops import color as jcolor
from unet_tpu.ops import edges as jedges
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.ops import edges
from unet_tpu_torch.pipeline import presets, stages

H, W = 112, 200


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("border", ["reflect101", "replicate"])
@pytest.mark.parametrize("dx,dy", [(1, 0), (0, 1), (2, 0), (1, 1)])
def test_sobel(rng, border, dx, dy):
    img = rng.uniform(0, 255, (2, 30, 41)).astype(np.float32)
    _eq(edges.sobel(torch.from_numpy(img), dx, dy, border=border),
        jedges.sobel(jnp.asarray(img), dx, dy, border=border))


def test_sobel_magnitude_laplacian_uint8_wrap(rng):
    img = rng.uniform(0, 255, (2, 30, 41)).astype(np.float32)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    _eq(edges.sobel_magnitude(t), jedges.sobel_magnitude(j))
    for k in (1, 3):
        _eq(edges.laplacian(t, k), jedges.laplacian(j, k))
    # |laplacian| reaches past 255 here, so the wrap matters
    lap = np.abs(np.asarray(jedges.laplacian(j)))
    assert lap.max() > 256
    _eq(edges.uint8_wrap(torch.from_numpy(lap)), jedges.uint8_wrap(jnp.asarray(lap)))
    x = np.array([0.0, 0.99, 1.5, 255.9, 256.0, 511.2, 1000.7], np.float32)
    _eq(edges.uint8_wrap(torch.from_numpy(x)), jedges.uint8_wrap(jnp.asarray(x)))


def _gray_and_cable(seed):
    """The JAX side's own enhanced gray and ROI-limited cable mask at HxW:
    chip_smoke.enhanced_scenes through the JAX preprocess; cable by the colour rule of
    chip_smoke.ColourClassModel at frame resolution."""
    jcfg = jpresets.enhanced().replace_in("preprocess", normalize_wh=(W, H))
    frames = enhanced_scenes(2, H, W, seed=seed, patch=14)
    bgr = np.asarray(jstages.preprocess_frames(jnp.asarray(frames), jcfg))
    cable = (bgr[..., 2] > 153) & (bgr[..., 0] > 153)
    cable = np.array(jstages.roi_limit(jnp.asarray(cable), jcfg.roi, (H, W)))
    gray = np.array(jcolor.bgr2gray(jnp.asarray(bgr)))
    return gray, cable, jcfg


@pytest.mark.parametrize("seed", [0, 2])
def test_burr_multiscale(seed):
    gray, cable, jcfg = _gray_and_cable(seed)
    cfg = presets.enhanced().replace_in("preprocess", normalize_wh=(W, H))
    tg, tc = torch.from_numpy(gray), torch.from_numpy(cable)
    jg, jc = jnp.asarray(gray), jnp.asarray(cable)
    want = np.asarray(jstages.burr_multiscale(jg, jc, jcfg.burr))
    _eq(stages.burr_multiscale(tg, tc, cfg.burr), want)
    assert want.any(), "no burr candidate survived: the CC gates are untested"
    mag_max = np.asarray(jnp.max(jedges.sobel_magnitude(jg), axis=(-2, -1))) * 0.75
    _eq(stages.burr_multiscale(tg, tc, cfg.burr, mag_max=torch.from_numpy(mag_max)),
        jstages.burr_multiscale(jg, jc, jcfg.burr, mag_max=jnp.asarray(mag_max)))
    _eq(stages._burr_on_roi_crop(tg, tc, cfg, stages.burr_multiscale, (H, W)),
        jstages._burr_on_roi_crop(jg, jc, jcfg, jstages.burr_multiscale, (H, W)))


def test_burr_on_roi_crop_448x800():
    """The main path's geometry: a 448x512 crop at columns 146-658 of the
    800-wide frame, normalized by the full frame's Sobel maximum."""
    r = np.random.default_rng(11)
    gray = np.round(r.uniform(40, 70, (1, 448, 800))).astype(np.float32)
    gray[:, :, 280:360] = 180.0
    gray[:, 100:116, 312:328] = np.where(
        (np.mgrid[0:16, 0:16].sum(0) // 3) % 2 == 0, 10.0, 150.0)
    gray[:, :, 700:720] = 255.0        # outside the crop: sets the Sobel max
    cable = np.zeros((1, 448, 800), bool)
    cable[:, :, 280:360] = True
    cable[:, 100:116, 312:328] = False
    cfg, jcfg = presets.enhanced(), jpresets.enhanced()
    got = stages._burr_on_roi_crop(torch.from_numpy(gray), torch.from_numpy(cable), cfg,
                                   stages.burr_multiscale, (448, 800))
    want = jstages._burr_on_roi_crop(jnp.asarray(gray), jnp.asarray(cable), jcfg,
                                     jstages.burr_multiscale, (448, 800))
    _eq(got, want)
    assert np.asarray(want).any()
