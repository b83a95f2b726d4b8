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
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import NLM_TOL, _nlm_weight_pairs, noisy_planes
from unet_tpu.ops import frames as jframes
from unet_tpu.ops import nlm_pallas
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
