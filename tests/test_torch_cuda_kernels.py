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

from chip_smoke import (NLM_TOL, _serpentine, noisy_planes, seeded_nested_unet, stripe_masks,
                        synthetic_frames, wrap_scenes)
from unet_tpu_torch.models import quantized
from unet_tpu_torch.ops import cc, cc_kernels, geometry, nlm_kernels, qconv_kernels
from unet_tpu_torch.pipeline import presets, stages


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,search,template", [
    ((2, 40, 56), 9, 5), ((2, 40, 56), 21, 7), ((3, 100, 130), 21, 7),
    ((1, 33, 65), 21, 3), ((2, 64, 96), 11, 11), ((1, 14, 14), 3, 1)] + [
    # partial tiles and strips on both axes (tiles of 64 - 2T columns by 64
    # rows, strips of 16 rows), a plane narrower than one strip, the main path
    (shape, 21, template) for shape in ((1, 70, 130), (2, 45, 30), (3, 448, 800))
    for template in (1, 3, 5, 7, 9, 11)])
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
@pytest.mark.parametrize("api", ["legacy", "per_operator"])
def test_fp32_step_pins_its_conv_precision(card, api):
    """With TF32 on process-wide (PyTorch's default for cuDNN convs, set
    here by either API), the fp32 step's NestedUNet logits stay within the
    1e-3 gate of tests/test_models_parity.py of the CPU's, and the flags are
    as the step found them."""
    b = torch.backends
    saved = (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision)
    try:
        if api == "legacy":
            b.cudnn.allow_tf32 = True
        else:
            b.cudnn.conv.fp32_precision = "tf32"
        before = (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision)
        model = seeded_nested_unet()
        cfg = presets.two_stage().replace_in("preprocess", model_size=(256, 256))
        frames = synthetic_frames(1, 224, 400, seed=0)
        seen = []
        hook = model.register_forward_hook(lambda m, i, o: seen.append(o.detach().cpu()))
        stages.build_step(model, cfg, device=card)(frames)
        hook.remove()
        assert (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision) == before
        x = stages.model_input(stages.geometric_preprocess(torch.from_numpy(frames), cfg), cfg)
        with torch.inference_mode():
            want = model.cpu()(x.permute(0, 3, 1, 2).contiguous())
        torch.testing.assert_close(seen[0], want, atol=1e-3, rtol=1e-3)
    finally:
        b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision = saved


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


def _seeds(fg: torch.Tensor, seed: int = 0):
    """The two callers' seeds: hysteresis (C=1, strong 0 / weak 1, pool 16,
    truncated at 16) and the CC filter (C=4 label/bbox, pool 4, max 64)."""
    rng = np.random.default_rng(seed)
    strong = np.where(rng.random((fg.shape[0], 1) + tuple(fg.shape[1:])) < 0.05, 0, 1)
    return [(torch.from_numpy(strong.astype(np.int32)).to(fg.device), 16, (1, 2, 3, 16, 64)),
            (cc._bbox_seed_state(fg), 4, (1, 2, 3, 64))]


def _routes_taken(fn):
    before = (cc_kernels.launches_cluster, cc_kernels.launches_global)
    out = fn()
    return out, (cc_kernels.launches_cluster - before[0], cc_kernels.launches_global - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("case", range(len(stripe_masks())))
def test_cc_cluster_route_across_stripe_boundaries(card, case, connectivity):
    """The cluster route bit for bit against the plain version on masks that
    cross its stripe boundaries, truncated and full, C=1 and C=4."""
    name, mask = stripe_masks()[case]
    fg = torch.from_numpy(mask).to(card)
    assert cc_kernels.route(*mask.shape[-2:])[0] == "cluster"
    for state0, pool, iters in _seeds(fg):
        for max_iters in iters:
            kw = dict(pool_iters=pool, max_iters=max_iters, connectivity=connectivity)
            got, taken = _routes_taken(lambda: cc_kernels.propagate(state0, fg, **kw))
            assert taken == (1, 0)
            want = cc_kernels.propagate_plain(state0, fg, **kw)
            assert torch.equal(got, want), f"{name} C={state0.shape[1]} {kw}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 5, 40), (3, 64, 128), (1, 448, 800)])
def test_cc_cluster_route_short_and_wide_planes(card, shape):
    """Fewer rows than CTAs (empty stripes), the tests' masks' shape, and
    the frame-sized plane that needs a cluster of 16."""
    rng = np.random.default_rng(11)
    fg = torch.from_numpy(rng.random(shape) < 0.6).to(card)
    for state0, pool, iters in _seeds(fg, seed=1):
        for max_iters in iters:
            kw = dict(pool_iters=pool, max_iters=max_iters)
            got, taken = _routes_taken(lambda: cc_kernels.propagate(state0, fg, **kw))
            assert taken == (1, 0)
            assert torch.equal(got, cc_kernels.propagate_plain(state0, fg, **kw))


@pytest.mark.cuda
def test_cc_cluster_route_unaligned_tensors(card):
    """Views that start 4 bytes into their storage take the 4-byte loads."""
    rng = np.random.default_rng(12)
    B, H, W = 2, 448, 384
    fg_store = torch.zeros(B * H * W + 1, dtype=torch.bool, device=card)
    fg = fg_store[1:].view(B, H, W)
    fg.copy_(torch.from_numpy(rng.random((B, H, W)) < 0.6).to(card))
    s_store = torch.empty(B * 4 * H * W + 1, dtype=torch.int32, device=card)
    state0 = s_store[1:].view(B, 4, H, W)
    state0.copy_(cc._bbox_seed_state(fg))
    assert state0.data_ptr() % 16 != 0 and state0.is_contiguous()
    kw = dict(pool_iters=4, max_iters=64)
    assert torch.equal(cc_kernels.propagate(state0, fg, **kw),
                       cc_kernels.propagate_plain(state0, fg, **kw))


@pytest.mark.cuda
def test_cc_plane_beyond_the_cluster_takes_the_global_route(card):
    rng = np.random.default_rng(13)
    fg = torch.from_numpy(rng.random((1, 1024, 1024)) < 0.6).to(card)
    assert cc_kernels.route(1024, 1024) == ("global", None)
    state0, pool, _ = _seeds(fg, seed=2)[0]
    for max_iters in (1, 16):
        kw = dict(pool_iters=pool, max_iters=max_iters)
        got, taken = _routes_taken(lambda: cc_kernels.propagate(state0, fg, **kw))
        assert taken == (0, 1)
        assert torch.equal(got, cc_kernels.propagate_plain(state0, fg, **kw))
    with pytest.raises(ValueError, match="does not fit"):
        cc_kernels.propagate_cluster(state0, fg, pool_iters=16, max_iters=1, cluster=16)


@pytest.mark.cuda
def test_cc_global_route_matches_the_cluster_route(card):
    """The global kernel, called directly, at the enhanced crop."""
    rng = np.random.default_rng(14)
    fg = torch.from_numpy(rng.random((2, 448, 512)) < 0.5).to(card)
    for state0, pool, iters in _seeds(fg, seed=3):
        kw = dict(pool_iters=pool, max_iters=iters[-1])
        assert torch.equal(cc_kernels.propagate_global(state0, fg, **kw),
                           cc_kernels.propagate_cluster(state0, fg, cluster=8, **kw))


def _label_masks(shape, seed=0):
    """Masks for B1 in label mode: noise, wrap scenes' class masks, and a
    serpentine (one component threaded through every row band)."""
    B, H, W = shape
    rng = np.random.default_rng(seed)
    scenes = wrap_scenes(B, H, W, seed=seed)
    tape = (scenes[..., 2] > 150) & (scenes[..., 0] < 100)
    return {"noise": rng.random(shape) < 0.55, "wrap tape": tape, "serpentine": _serpentine(*shape)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cluster", [((4, 256, 256), 8), ((2, 448, 800), 16)])
@pytest.mark.parametrize("mask", ["noise", "wrap tape", "serpentine"])
def test_cc_label_mode_matches_plain(card, shape, cluster, mask):
    """B1 as connected_components runs it (C=1 label seeds, pool 16, max 64)
    at the geometry presets' planes: 256x256 on a cluster of 8 (wrap), and
    448x800 on a cluster of 16 (production, three_class_full), bit for bit
    with the plain version, also truncated: the 448x800 serpentine needs
    more than 64 iterations."""
    fg = torch.from_numpy(_label_masks(shape)[mask]).to(card)
    B, H, W = shape
    state0 = cc._label_seed(H, W, card).expand(B, 1, H, W).contiguous()
    assert cc_kernels.route(H, W) == ("cluster", cluster)
    for max_iters in (1, 2, 64):
        kw = dict(pool_iters=16, max_iters=max_iters)
        before = dict(cc_kernels.launches_per_cluster)
        got = cc_kernels.propagate(state0, fg, **kw)
        assert cc_kernels.launches_per_cluster[cluster] == before[cluster] + 1
        assert torch.equal(got, cc_kernels.propagate_plain(state0, fg, **kw)), kw
    if mask == "serpentine" and H == 448:
        longer = cc_kernels.propagate_plain(state0, fg, pool_iters=16, max_iters=256)
        assert not torch.equal(got, longer), "the serpentine converged within 64 iterations"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 256), (2, 448, 800)])
def test_connected_components_and_geometry_card_equals_cpu(card, shape):
    """The labelling, the component statistics and the geometry built on
    them, card against CPU: integers equal, floats within 1e-4."""
    masks = _label_masks(shape, seed=3)
    for name, m in masks.items():
        t = torch.from_numpy(m)
        lab_cpu = cc.connected_components(t)
        lab = cc.connected_components(t.to(card))
        assert torch.equal(lab.cpu(), lab_cpu), name
        for k in (1, 32):
            got, want = cc.component_stats(lab, k), cc.component_stats(lab_cpu, k)
            for f in got._fields:
                assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (name, k, f)
        assert torch.equal(cc.largest_component(t.to(card), min_area=50).cpu(),
                           cc.largest_component(t, min_area=50))
        assert torch.equal(cc.count_components(t.to(card), max_components=32).cpu(),
                           cc.count_components(t, max_components=32))
    scenes = wrap_scenes(*shape, seed=5)
    pred = np.where((scenes[..., 0] > 150) & (scenes[..., 2] > 150), 1,
                    np.where((scenes[..., 2] > 150) & (scenes[..., 0] < 100), 2, 0))
    pred = torch.from_numpy(pred.astype(np.uint8))
    for fn in (geometry.diameter_metrics, geometry.analyze_defects):
        got, want = fn(pred.to(card)), fn(pred)
        for f in got._fields:
            g, w = getattr(got, f).cpu(), getattr(want, f)
            if w.is_floating_point():
                torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
            else:
                assert torch.equal(g, w), f


def _qconv_case(shape, cin, n, pair, signed, dtype, seed=0):
    """Random codes for `qconv`: sources (one, or a pair splitting `cin`),
    OHWI weights and an epilogue in `dtype` whose outputs span 0..127."""
    rng = np.random.default_rng(seed)
    lo = -127 if signed else 0
    cuts = (cin,) if not pair else (cin // 3, cin - cin // 3)
    srcs = tuple(torch.from_numpy(rng.integers(lo, 128, shape + (c,)).astype(np.int8))
                 for c in cuts)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, 3, 3, cin)).astype(np.int8))
    spread = np.sqrt(9 * cin) * 5340 / 40      # acc's std over 40: y spans about +-40
    mult = torch.from_numpy((rng.uniform(0.5, 2.0, n) / spread).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.uniform(-20, 80, n).astype(np.float32)).to(dtype)
    return (srcs if pair else srcs[0]), wq, mult, bias


def _to(x, dev):
    return tuple(t.to(dev) for t in x) if isinstance(x, tuple) else x.to(dev)


def _launch_counts():
    return (qconv_kernels.launches, qconv_kernels.launches_wgmma, qconv_kernels.launches_sync,
            qconv_kernels.launches_c3)


def _expect_route(x, n):
    srcs = x if isinstance(x, tuple) else (x,)
    ca, cb = srcs[0].shape[-1], (srcs[1].shape[-1] if len(srcs) == 2 else 0)
    return qconv_kernels.route(ca, cb, n, aligned=True, width=srcs[0].shape[2])


_ROUTE_DELTA = {"wgmma": (1, 0, 0), "sync": (0, 1, 0), "c3": (0, 0, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cin,n,pair,signed", [
    ((2, 32, 32), 3, 32, False, True),       # conv0_0.conv1: Cin 3, the c3 kernel
    # the c3 kernel: three distinct images (the halo at image borders), a
    # ragged last row tile with W x 3 % 16 == 0, two N blocks; and Cin 3
    # rows that end inside a 16-byte chunk, which take the sync byte path
    ((3, 512, 512), 3, 32, False, True),
    ((1, 33, 48), 3, 32, False, True),
    ((2, 17, 80), 3, 64, False, True),
    ((1, 9, 15), 3, 32, False, True),
    ((1, 7, 9), 5, 10, False, True),         # ragged: odd N, Cin and plane
    ((2, 5, 3), 37, 33, True, False),        # a ragged pair (byte path)
    ((2, 64, 64), 32, 32, False, False),     # conv0_0.conv2
    ((1, 33, 65), 96, 32, True, False),      # conv0_4.conv1's pair form, ragged plane
    ((2, 16, 16), 192, 64, True, False),     # conv1_3.conv1
    ((1, 8, 8), 768, 256, True, False),      # conv3_1.conv1
    ((3, 4, 4), 256, 512, False, False),     # conv4_0.conv1
    ((1, 130, 3), 64, 128, False, False),    # 128-pixel tiles cut across rows
    # the wgmma route: M not a multiple of 128, K tails (9 C not a multiple
    # of 128), signed codes, N = 32 ... 512 at each tile width
    ((1, 9, 15), 32, 32, False, True),       # BN 32, K = 288, one partial tile
    ((2, 17, 19), 96, 32, True, True),       # BN 32, a 32 + 64 pair, K = 864
    ((1, 23, 29), 32, 64, False, True),      # BN 64
    ((2, 11, 13), 96, 64, True, False),      # BN 64, pair
    ((1, 21, 22), 64, 128, False, True),     # BN 128
    ((1, 13, 11), 768, 256, True, True),     # BN 128, a 256 + 512 pair, two N tiles
    ((2, 5, 7), 256, 512, False, True),      # BN 128, four N tiles
    ((1, 6, 10), 768, 512, True, False),     # K = 6912, 54 slices
])
def test_qconv_matches_plain(card, dtype, shape, cin, n, pair, signed):
    """The kernel bit for bit against `qconv_plain`, single and pair forms,
    every route (wgmma for every source width a multiple of 32, c3 for one
    source of 3 channels with rows of whole 16-byte chunks, mma.sync's
    byte path otherwise), every tile width (N % 128, % 64, else 32) and
    both compute types; each launch counted on the route `route` names."""
    x, wq, mult, bias = _qconv_case(shape, cin, n, pair, signed, dtype)
    if pair:
        assert (x[0].shape[-1] % 32 == 0) == (cin % 96 == 0)
    xd, wd, md, bd = _to(x, card), wq.to(card), mult.to(card), bias.to(card)
    kind, _ = _expect_route(x, n)
    before = _launch_counts()
    got = qconv_kernels.qconv(xd, wd, md, bd)
    torch.cuda.synchronize()
    after = _launch_counts()
    assert after[0] == before[0] + 1
    assert tuple(a - b for a, b in zip(after[1:], before[1:])) == _ROUTE_DELTA[kind]
    want = qconv_kernels.qconv_plain(xd, wd, md, bd)
    assert got.shape == shape + (n,) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert 0 < int(got.float().mean()) and int(got.max()) == 127  # the epilogue's range is used
    assert torch.equal(got.cpu(), qconv_kernels.qconv_plain(x, wq, mult, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cin,n,pair", [
    ((1, 9, 15), 32, 32, False), ((2, 11, 13), 96, 64, True), ((1, 13, 11), 768, 256, True),
    ((1, 130, 3), 64, 128, False)])
def test_qconv_sync_route_matches_plain_at_wgmma_shapes(card, dtype, shape, cin, n, pair):
    """`qconv_sync`, the mma.sync kernel kept as the wgmma route's yardstick, at
    shapes the main path sends to wgmma: bit for bit, counted as sync."""
    x, wq, mult, bias = _qconv_case(shape, cin, n, pair, True, dtype, seed=5)
    xd, wd, md, bd = _to(x, card), wq.to(card), mult.to(card), bias.to(card)
    assert _expect_route(x, n)[0] == "wgmma"
    before = _launch_counts()
    got = qconv_kernels.qconv_sync(xd, wd, md, bd)
    torch.cuda.synchronize()
    after = _launch_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 1, 0)
    assert torch.equal(got, qconv_kernels.qconv(xd, wd, md, bd))
    assert torch.equal(got, qconv_kernels.qconv_plain(xd, wd, md, bd))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [32, 3])
def test_qconv_misaligned_source_takes_the_sync_route(card, cin):
    """A source that is not 16-byte aligned (a view one byte into its
    storage) goes to the sync kernel's byte path, by the route alone: at a
    wgmma shape and at a c3 shape."""
    x, wq, mult, bias = _qconv_case((1, 12, 16), cin, 32, False, False, torch.bfloat16)
    assert _expect_route(x, 32)[0] == ("wgmma" if cin == 32 else "c3")
    flat = torch.empty(x.numel() + 1, dtype=torch.int8, device=card)
    xd = flat[1:].view(x.shape)
    xd.copy_(x.to(card))
    assert xd.data_ptr() % 16 != 0 and xd.is_contiguous()
    before = _launch_counts()
    got = qconv_kernels.qconv(xd, wq.to(card), mult.to(card), bias.to(card))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (1, 0, 1, 0)
    assert torch.equal(got.cpu(), qconv_kernels.qconv_plain(x, wq, mult, bias))


@pytest.mark.cuda
def test_qconv_refuses_what_it_does_not_take(card):
    x, wq, mult, bias = _qconv_case((1, 8, 8), 32, 32, False, False, torch.bfloat16)
    x, wq, mult, bias = x.to(card), wq.to(card), mult.to(card), bias.to(card)
    with pytest.raises(ValueError, match="contiguous"):
        qconv_kernels.qconv(x.transpose(1, 2), wq, mult, bias)
    with pytest.raises(ValueError, match="int8"):
        qconv_kernels.qconv(x.float(), wq, mult, bias)
    with pytest.raises(ValueError, match="wq"):
        qconv_kernels.qconv(x, wq[:, :, :, :16], mult, bias)
    with pytest.raises(ValueError, match="share"):
        qconv_kernels.qconv(x, wq, mult, bias.float())
    with pytest.raises(ValueError, match="device"):
        qconv_kernels.qconv(x, wq.cpu(), mult, bias)


@pytest.mark.cuda
def test_int8_forward_on_the_card_equals_the_cpu(card):
    """The int8 forward through the kernel on the card and through the
    plain versions on the CPU, with the same weights and scales: every one
    of the 19 int8 tensors equal, logits within bf16 rounding."""
    model = seeded_nested_unet()
    x = torch.from_numpy(np.random.default_rng(3).random((2, 64, 64, 3)).astype(np.float32))
    scales = quantized.calibrate(model.state_dict(), [x])
    qp_cpu = quantized.prepare_int8_params(model.state_dict(), scales)
    qp_card = quantized.prepare_int8_params(model.state_dict(), scales, device=card)
    taps_cpu, taps_card = {}, {}
    before = _launch_counts()
    with torch.inference_mode():
        want = quantized.nested_unet_forward_int8(qp_cpu, x, taps_cpu)
        got = quantized.nested_unet_forward_int8(qp_card, x.to(card), taps_card)
    torch.cuda.synchronize()
    # 17 convs on the wgmma route, conv0_0.conv1 (Cin 3) on the c3 kernel
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (18, 17, 0, 1)
    assert sorted(taps_card) == sorted(quantized.TAP_NAMES)
    for name in quantized.TAP_NAMES:
        assert torch.equal(taps_card[name].cpu(), taps_cpu[name]), name
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.05, rtol=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fast_forward", "int8"])
def test_bf16_and_int8_steps_on_the_card(card, route):
    """The two_stage step with the bf16 fast forward or calibrated int8
    scales, on the card against the same step on the CPU: class maps agree
    on >= 0.995 of the pixels (int8: equal int8 tensors, bf16 head in
    another summation order; bf16: cuDNN against the CPU's convs)."""
    model = seeded_nested_unet(dtype=torch.bfloat16)
    cfg = presets.two_stage().replace_in("preprocess", model_size=(128, 128))
    frames = synthetic_frames(2, 224, 400, seed=1)
    if route == "int8":
        cfg = stages.calibrate_int8(model, cfg, [frames], device=card)
        assert len(cfg.segment.int8_scales) == 19
    else:
        cfg = cfg.replace_in("segment", fast_forward=True)
    before = _launch_counts()
    got = stages.build_step(model, cfg, device=card)(frames)
    torch.cuda.synchronize()
    assert (tuple(a - b for a, b in zip(_launch_counts(), before))
            == ((18, 17, 0, 1) if route == "int8" else (0, 0, 0, 0)))
    want = stages.build_step(model, cfg, device="cpu")(frames)
    agree = float((got.class_map.cpu() == want.class_map).float().mean())
    assert agree >= 0.995, agree


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wrap_uniformity", "production", "three_class_full"])
def test_geometry_presets_on_the_card_equal_the_cpu(card, name):
    """The geometry presets' steps with the colour->class model on 448x800
    frames, card against CPU, with B1's launches per cluster size: wrap
    labels at its model's 256x256 (cluster of 8), production (and its burr
    crops, 8) and three_class_full at 448x800 (cluster of 16: their 512x512
    model input is taller than the frame)."""
    from chip_smoke import ColourClassModel

    cfg = presets.get_preset(name)
    frames = (synthetic_frames(2, 448, 800, seed=2) if name == "production"
              else wrap_scenes(2, 448, 800, seed=2))
    before = dict(cc_kernels.launches_per_cluster)
    got = stages.build_step(ColourClassModel(), cfg, device=card)(frames)
    torch.cuda.synchronize()
    took = {K: cc_kernels.launches_per_cluster[K] - before[K] for K in before}
    assert took == {"wrap_uniformity": {8: 2, 16: 0}, "production": {8: 2, 16: 5},
                    "three_class_full": {8: 0, 16: 2}}[name]
    want = stages.build_step(ColourClassModel(), cfg, device="cpu")(frames)
    for f in ("class_map", "cable_px", "tape_px", "burr_px"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for part in ("diameters", "defects"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None)
        for f in (g._fields if g is not None else ()):
            gv, wv = getattr(g, f).cpu(), getattr(w, f)
            if wv.is_floating_point():
                torch.testing.assert_close(gv, wv, atol=1e-4, rtol=0)
            else:
                assert torch.equal(gv, wv), (part, f)
    assert float(got.diameters.dc_px.min()) > 0


@pytest.mark.cuda
def test_multistream_server_on_the_card(card):
    """The server on the card: each (stream, frame) once, with the result
    of the card's step on that frame."""
    from chip_smoke import ColourClassModel
    from unet_tpu_torch.serve import MultiStreamServer

    class Source:
        def __init__(self, sid, n):
            self.sid, self.n = sid, n

        def frames(self):
            for i in range(self.n):
                yield i + 1, wrap_scenes(1, 448, 800, seed=10 * self.sid + i)[0]

    cfg = presets.wrap_uniformity()
    server = MultiStreamServer(ColourClassModel(), cfg, device=card)
    results = []
    server.serve([Source(0, 3), Source(1, 2), Source(2, 4)], results.append)
    assert sorted((r.stream_id, r.frame_id) for r in results) == \
        [(0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (2, 1), (2, 2), (2, 3), (2, 4)]
    step = stages.build_step(ColourClassModel(), cfg, device=card)
    for r in results:
        out = step(wrap_scenes(1, 448, 800, seed=10 * r.stream_id + r.frame_id - 1))
        assert (r.cable_px, r.tape_px) == (int(out.cable_px[0]), int(out.tape_px[0]))
        assert (r.dc_px, r.dt_px) == (float(out.diameters.dc_px[0]), float(out.diameters.dt_px[0]))
        assert r.dt_px > r.dc_px > 0
