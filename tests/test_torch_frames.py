"""The rest of ops/frames.py against the JAX package's
(unet_tpu/ops/frames.py:20-57, 142-164): grayscale detection, the
grayscale enhancement (CLAHE, gamma, bilateral or non-local means), the
per-frame conditional select, and the aspect-preserving model resize with
its mask inverse. No preset's step calls them, in either package. Inputs
from a numpy seed at 64x96."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_cable_frame
from unet_tpu.ops import frames as jframes
from unet_tpu_torch.ops import frames
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _batch():
    """A colour scene, its blue channel as a gray frame, and a tinted gray
    frame whose largest mean channel difference (6) lies under the threshold 10."""
    bgr, _ = synthetic_cable_frame(64, 96, cable_x=(40, 56), tape_y=(20, 44), seed=3)
    gray = np.repeat(bgr[..., :1], 3, axis=-1)
    tinted = np.clip(gray.astype(np.int16) + np.array([0, 3, -3]), 0, 255).astype(np.uint8)
    return np.stack([bgr, gray, tinted])


def test_is_grayscale_frame_matches_jax():
    b = _batch()
    want = np.asarray(jframes.is_grayscale_frame(jnp.asarray(b)))
    assert want.tolist() == [False, True, True]
    for threshold in (10.0, 4.0, 60.0):
        got = frames.is_grayscale_frame(torch.from_numpy(b), threshold)
        assert got.tolist() == np.asarray(jframes.is_grayscale_frame(jnp.asarray(b),
                                                                     threshold)).tolist()


@pytest.mark.parametrize("denoise,gamma", [("bilateral", 0.8), ("nlm", 0.8), ("none", 1.0),
                                           ("none", 1.6)])
def test_enhance_grayscale_frame_matches_jax(denoise, gamma):
    """CLAHE is bit-identical; the gamma power may differ from XLA's in the
    last bit, which moves a rounded level by one where the power lands on a
    half: levels within 1, and equal on >= 0.999 of the pixels; the
    denoisers then sum in their own order (within 1e-3 of a level)."""
    b = _batch()[1:]
    kw = dict(gamma=gamma, denoise=denoise, denoise_strength=5)
    want = np.asarray(jframes.enhance_grayscale_frame(jnp.asarray(b), **kw))
    got = frames.enhance_grayscale_frame(torch.from_numpy(b), **kw).numpy()
    assert got.shape == want.shape == b.shape and got.dtype == np.float32
    assert np.array_equal(got[..., 0], got[..., 2])
    diff = np.abs(got - want)
    print(f"{denoise} gamma {gamma}: max diff {diff.max():.3e}, "
          f"share equal within 1e-3 {(diff <= 1e-3).mean():.6f}")
    assert diff.max() <= 1.0 + 1e-3
    assert (diff <= 1e-3).mean() >= 0.999


def test_conditional_grayscale_enhance_selects_per_frame():
    b = _batch()
    want = np.asarray(jframes.conditional_grayscale_enhance(jnp.asarray(b), gamma=1.0,
                                                            denoise="none"))
    got = frames.conditional_grayscale_enhance(torch.from_numpy(b), gamma=1.0,
                                               denoise="none").numpy()
    assert np.array_equal(got[0], b[0].astype(np.float32))     # the colour frame untouched
    assert not np.array_equal(got[1], b[1].astype(np.float32))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("target", [128, 50])
def test_resize_for_model_and_back_match_jax(target):
    """uint8 frames bit for bit (rounded like cv2), float frames within
    1e-4, the zero pad at the bottom and right; the mask inverse exactly."""
    b = _batch()
    want, wscale = jframes.resize_for_model(jnp.asarray(b), target)
    got, scale = frames.resize_for_model(torch.from_numpy(b), target)
    assert scale == wscale and got.shape == (3, target, target, 3) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    nh = int(64 * scale)
    assert not got[:, nh:].any()
    bf = b.astype(np.float32) / 255.0
    np.testing.assert_allclose(frames.resize_for_model(torch.from_numpy(bf), target)[0].numpy(),
                               np.asarray(jframes.resize_for_model(jnp.asarray(bf), target)[0]),
                               atol=1e-4)
    mask = np.random.default_rng(0).integers(0, 3, (3, target, target)).astype(np.int32)
    back = frames.resize_mask_back(torch.from_numpy(mask), (64, 96), scale)
    assert back.shape == (3, 64, 96)
    assert np.array_equal(back.numpy(), np.asarray(jframes.resize_mask_back(
        jnp.asarray(mask), (64, 96), wscale)))
