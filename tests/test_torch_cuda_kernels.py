"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch for CUDA:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Without a card every test skips. The CPU parity of the plain versions with
the JAX package is in tests/test_torch_nlm.py and tests/test_torch_cc.py.
"""
import numpy as np
import pytest
import torch

from chip_smoke import NLM_TOL, noisy_planes
from unet_tpu_torch.ops import cc, cc_kernels, nlm_kernels


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,search,template", [
    ((2, 40, 56), 9, 5), ((2, 40, 56), 21, 7), ((3, 100, 130), 21, 7),
    ((1, 33, 65), 21, 3), ((2, 64, 96), 11, 11), ((1, 14, 14), 3, 1)])
def test_nlm_kernel_matches_plain(card, shape, search, template):
    rng = np.random.default_rng(0)
    for img in (noisy_planes(shape, seed=2), (rng.random(shape) * 255).astype(np.float32)):
        x = torch.from_numpy(img).to(card)
        before = nlm_kernels.launches
        got = nlm_kernels.nlm(x, 10.0, template, search)
        torch.cuda.synchronize()
        assert nlm_kernels.launches == before + 1
        want = nlm_kernels.nlm_plain(x, 10.0, template, search)
        torch.testing.assert_close(got, want, **NLM_TOL)


@pytest.mark.cuda
def test_nlm_kernel_refuses_what_it_does_not_take(card):
    x = torch.from_numpy(noisy_planes((2, 40, 56))).to(card)
    with pytest.raises(ValueError, match="contiguous"):
        nlm_kernels.nlm(x.transpose(1, 2), 10.0, 7, 21)
    with pytest.raises(ValueError):
        nlm_kernels.nlm(x.half(), 10.0, 7, 21)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [1, 2, 64])
def test_cc_propagate_at_the_enhanced_crop(card, max_iters):
    """B1 at the enhanced path's crop, 448x512, on a noise mask, C=1 and C=4."""
    rng = np.random.default_rng(5)
    fg = torch.from_numpy(rng.random((2, 448, 512)) < 0.4).to(card)
    seeds = torch.from_numpy(
        np.where(rng.random((2, 1, 448, 512)) < 0.1, 0, 1).astype(np.int32)).to(card)
    for state0, pool in ((seeds, 16), (cc._bbox_seed_state(fg), 4)):
        got = cc_kernels.propagate(state0, fg, pool_iters=pool, max_iters=max_iters)
        want = cc_kernels.propagate_plain(state0, fg, pool_iters=pool, max_iters=max_iters)
        assert torch.equal(got, want)
