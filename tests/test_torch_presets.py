"""The ops of the eight presets that label, threshold and gate
(video_full, optimized, robust, simple_7class, strict, v3_high_quality,
spatial, roi_first) and sliding-window inference, the port against the JAX
package on numpy-seeded inputs at small sizes (model 64x64, frames up to
160x224). The presets' steps are in tests/test_torch_presets_steps.py.

Integer and bool results (masks, boxes, class maps, px counts, the integer
fields of diameters, defects and defect components) must be bit-identical;
float results agree within 1e-4 (the gate of
tests/test_ops_clahe_geometry.py), the quality statistics within 1e-4
relative (float32 sums in another order). The references are the JAX
package's JITTED functions: inside jit XLA turns a division by a constant
into a product with its float32 reciprocal, and contracts some products and
sums into fused multiply-adds; the port computes those forms where they
decide a result (`ops.image.recip32`, `box_smooth_same`).

The threshold modes threshold softmax probabilities; XLA's float32 exp and
torch's differ in the last bit on about a tenth of inputs, so a probability
that lies within one ulp of a threshold could fall on either side (ROADMAP
C). The seeded logits here have none there."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import defect_scenes, synthetic_frames
from unet_tpu.ops import cc as jcc
from unet_tpu.ops import edges as jedges
from unet_tpu.ops import image as jimage
from unet_tpu.ops import morph as jmorph
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.ops import cc, edges, image, morph
from unet_tpu_torch.pipeline import presets, stages

ATOL = 1e-4
NEW_PRESETS = ("video_full", "optimized", "robust", "simple_7class", "strict",
               "v3_high_quality", "spatial", "roi_first")


def _eq(got, want, what=""):
    g, w = got.cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape, g.dtype, w.dtype)
    assert np.array_equal(g, w), (what, int((g != w).sum()))


def _close(got, want, what="", rtol=0.0):
    g, w = got.cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, atol=0 if rtol else ATOL, rtol=rtol, err_msg=what)


def _fields(got, want, exact=()):
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        (_eq if np.asarray(w).dtype.kind in "biu" or f in exact else _close)(g, w, f)


# ---------------------------------------------------------------------------
# ops/image.py: letterbox, dynamic crop, ROI detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((48, 80), (64, 64)), ((80, 48), (64, 64)),
                                     ((96, 128), (64, 48)), ((64, 64), (64, 64))])
def test_letterbox_and_unletterbox_match_jax(src, dst):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (2,) + src + (3,)).astype(np.float32)
    assert image.letterbox_params(src, dst) == jimage.letterbox_params(src, dst)
    want = jax.jit(lambda x: jimage.letterbox(x, dst))(jnp.asarray(img))
    _close(image.letterbox(torch.from_numpy(img), dst), want)
    mask = rng.random((2,) + dst) < 0.5
    _eq(image.unletterbox_mask(torch.from_numpy(mask), src, dst),
        jimage.unletterbox_mask(jnp.asarray(mask), src, dst))
    _eq(image.rotate90_cw(torch.from_numpy(img)), jimage.rotate90_cw(jnp.asarray(img)))


# boxes that reach both edges, narrow, empty, reversed and one that starts
# past the image
BOXES = [(0, 128), (0, 20), (100, 128), (40, 41), (60, 60), (70, 50), (127, 128), (5, 90)]


def _boxes(n):
    x0, x1 = zip(*[BOXES[i % len(BOXES)] for i in range(n)])
    return np.asarray(x0, np.int32), np.asarray(x1, np.int32)


@pytest.mark.parametrize("out_hw", [(64, 64), (40, 96)])
def test_crop_resize_bilinear_matches_jitted_jax(out_hw):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (len(BOXES), 48, 128, 3)).astype(np.float32)
    x0, x1 = _boxes(len(BOXES))
    want = jax.jit(lambda i, a, b: jimage.crop_resize_bilinear(i, a, b, out_hw))(
        jnp.asarray(img), jnp.asarray(x0), jnp.asarray(x1))
    got = image.crop_resize_bilinear(torch.from_numpy(img), torch.from_numpy(x0),
                                     torch.from_numpy(x1), out_hw)
    _close(got, want)


@pytest.mark.parametrize("mask_hw", [(64, 64), (32, 40)])
def test_uncrop_resize_nearest_bit_identical(mask_hw):
    """Boxes reaching both edges; left of a box, (ox - x0) * mw // span
    floor-divides a negative number."""
    rng = np.random.default_rng(3)
    mask = rng.random((len(BOXES),) + mask_hw) < 0.5
    x0, x1 = _boxes(len(BOXES))
    want = jax.jit(lambda m, a, b: jimage.uncrop_resize_nearest(m, a, b, (48, 128)))(
        jnp.asarray(mask), jnp.asarray(x0), jnp.asarray(x1))
    _eq(image.uncrop_resize_nearest(torch.from_numpy(mask), torch.from_numpy(x0),
                                    torch.from_numpy(x1), (48, 128)), want)


@pytest.mark.parametrize("n", [30, 31, 12, 7])
@pytest.mark.parametrize("W", [128, 800])
def test_box_smooth_same_bit_identical_to_jitted_convolve(n, W):
    """The smoothed projection itself: integer column counts (up to 448
    rows), so that exact ties with rel_thresh * max occur and the float32
    sums' order decides them."""
    rng = np.random.default_rng(n + W)
    counts = rng.integers(0, 449, (4, W)).astype(np.float32)
    counts[1] = (rng.random(W) < 0.2) * rng.integers(0, 40, W)
    k = jnp.ones((n,), jnp.float32) / n
    want = jax.jit(jax.vmap(lambda p: jnp.convolve(p, k, mode="same")))(jnp.asarray(counts))
    _eq(image.box_smooth_same(torch.from_numpy(counts), n), want)


def _roi_frames(seed):
    """Gray frames: vertical bands of edges at per-frame columns, a frame
    with a band at each side, and flat frames (no edge: the central-half
    fallback)."""
    rng = np.random.default_rng(seed)
    H, W = 56, 128
    g = np.full((6, H, W), 90.0, np.float32)
    for i, (a, b) in enumerate([(30, 60), (2, 20), (100, 127), (50, 54)]):
        g[i, :, a:b] = np.where((np.arange(a, b) % 4) < 2, 200.0, 40.0)
        g[i] += rng.normal(0, 3, (H, W))
    g[3, :, 5:9] = 220.0
    g[5] += rng.normal(0, 0.5, (H, W))
    return np.clip(np.round(g), 0, 255)


def test_detect_vertical_roi_matches_jitted_jax():
    gray = _roi_frames(4)
    want = jax.jit(jimage.detect_vertical_roi)(jnp.asarray(gray))
    got = image.detect_vertical_roi(torch.from_numpy(gray))
    _eq(got[0], want[0], "x0")
    _eq(got[1], want[1], "x1")
    W = gray.shape[-1]
    assert got[0][4:].tolist() == [W // 4] * 2 and got[1][4:].tolist() == [3 * W // 4] * 2
    assert len(set(zip(got[0][:4].tolist(), got[1][:4].tolist()))) == 4


# ---------------------------------------------------------------------------
# ops/morph.py, ops/edges.py, ops/cc.py
# ---------------------------------------------------------------------------

def test_disk_ring_band_gradient_dog_component_any():
    rng = np.random.default_rng(5)
    m = np.zeros((2, 48, 64), bool)
    m[0, 10:30, 20:26] = True
    m[1] = rng.random((48, 64)) < 0.05
    for r in (0, 1, 3, 6):
        assert np.array_equal(morph.disk_kernel(r), jmorph.disk_kernel(r))
    for r_in, r_out in ((0, 3), (2, 5), (4, 9)):
        _eq(morph.ring_band(torch.from_numpy(m), r_in, r_out),
            jmorph.ring_band(jnp.asarray(m), r_in, r_out))
    for se in (morph.ellipse_kernel(3), morph.ellipse_kernel(4), morph.disk_kernel(2)):
        _eq(morph.gradient(torch.from_numpy(m), se), jmorph.gradient(jnp.asarray(m), se))
    gray = synthetic_frames(2, 48, 64, seed=6)[..., 1].astype(np.float32)
    _eq(edges.dog(torch.from_numpy(gray)), jax.jit(jedges.dog)(jnp.asarray(gray)))
    labels = np.array(jcc.connected_components(jnp.asarray(rng.random((3, 40, 56)) < 0.45)))
    flags = rng.random((3, 40, 56)) < 0.01
    flags[2] = False
    _eq(cc.component_any(torch.from_numpy(labels), torch.from_numpy(flags)),
        jcc.component_any(jnp.asarray(labels), jnp.asarray(flags)))


# ---------------------------------------------------------------------------
# pipeline/stages.py: the threshold modes and the postprocess ops
# ---------------------------------------------------------------------------

def _logits(seed, C, B=2, h=64, w=64, scale=2.0):
    """Seeded logits with a cable strip, a tape band and defect blobs, in
    (B, h, w, C) for JAX; probabilities spread over every threshold."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, scale, (B, h, w, C)).astype(np.float32)
    lg[:, :, 24:40, 1] += 3
    lg[:, 16:48, 18:46, 2] += 2.5
    for k in range(3, C):
        lg[:, 4 * k:4 * k + 6, 4:12, k] += 5
    return lg


MODES = {"per_class": dict(class_thresholds=(0.0, 0.35, 0.35, 0.7, 0.7, 0.7, 0.7)),
         "per_class_ratio": dict(threshold_mode="per_class", ct_ratio=1.2,
                                 class_thresholds=(0.0, 0.6, 0.6, 0.7, 0.7, 0.7, 0.7)),
         "relative": dict(bg_ratio_cable=2.0, bg_ratio_tape=2.5),
         "ultra_strict": {}, "exclusive": dict(class_thresholds=(0.0, 0.5, 0.5),
                                               bg_margin=0.05, ct_margin=0.05)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_threshold_modes_match_jitted_jax(mode, dtype):
    kw = dict(MODES[mode])
    kw.setdefault("threshold_mode", mode)
    C = len(kw.get("class_thresholds", ())) or 3
    cfgs = [mod.PipelineCfg(segment=mod.SegmentCfg(num_classes=C, **kw))
            for mod in (presets, jpresets)]
    lg = _logits(7, C)
    jl = jnp.asarray(lg).astype(getattr(jnp, dtype))
    want = jax.jit(lambda x: jstages.extract_masks(x, cfgs[1]))(jl)
    tl = torch.from_numpy(np.ascontiguousarray(lg.transpose(0, 3, 1, 2))).to(getattr(torch, dtype))
    got = stages.extract_masks(tl, cfgs[0])
    for g, w, name in zip(got, want, ("cable", "tape")):
        _eq(g, w, name)
        assert 0 < int(g.sum()) < g.numel(), name
    probs = stages.softmax(tl)
    jp = jax.jit(lambda x: jax.nn.softmax(x, axis=-1))(jl)
    _close(probs.float().permute(0, 2, 3, 1), np.asarray(jp.astype(jnp.float32)), "softmax",
           rtol=1e-6 if dtype == "float32" else 1e-2)


def test_unknown_threshold_mode_raises_value_error():
    cfg = presets.two_stage().replace_in("segment", threshold_mode="nearest")
    with pytest.raises(ValueError, match="nearest"):
        stages.extract_masks(torch.zeros(1, 3, 4, 4), cfg)


def _gate_masks(seed=8, shape=(2, 64, 64)):
    """Strips of several widths and heights, squat blobs, small specks and
    edge-hugging columns, so that every gate keeps some and drops some."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    m[:, 4:60, 28:34] = True         # a centred strip
    m[:, 2:8, 2:40] = True           # a wide squat band
    m[0, 10:50, 0:3] = True          # a column on the left edge
    m[1, 20:63, 58:64] = True        # one on the right
    m[:, 40:44, 40:44] = True        # a speck
    m |= rng.random(shape) < 0.02
    return m


def _small_post(mod, mode):
    """The spatial / refine gates scaled to a 64x64 model input."""
    return mod.PostprocessCfg(enabled=True, mode=mode, spatial_min_area=30,
                              spatial_cable_w=(3, 20), spatial_tape_w=(2, 40),
                              refine_min_area=20, refine_wide_w=30, refine_edge_area=150,
                              max_components=16)


def test_component_gates_match_jitted_jax():
    m = _gate_masks()
    tm, jm = torch.from_numpy(m), jnp.asarray(m)
    p, jp = _small_post(presets, "spatial"), _small_post(jpresets, "spatial")
    for bounds in ((3, 20), (2, 40), (7, 64)):
        want = jax.jit(lambda x: jstages.spatial_strip_filter(x, bounds, jp))(jm)
        got = stages.spatial_strip_filter(tm, bounds, p)
        _eq(got, want, f"spatial {bounds}")
        assert 0 < int(got.sum()) < int(tm.sum())
    p, jp = _small_post(presets, "refine"), _small_post(jpresets, "refine")
    want = jax.jit(lambda x: jstages.refine_mask_by_geometry(x, jp))(jm)
    got = stages.refine_mask_by_geometry(tm, p)
    _eq(got, want, "refine")
    assert 0 < int(got.sum()) < int(tm.sum())


def test_shape_postprocess_matches_jitted_jax():
    rng = np.random.default_rng(9)
    H, W = 96, 128
    cable = np.zeros((3, H, W), bool)
    cable[0, :, 50:62] = True                     # the best-scored strip
    cable[0, 10:30, 5:30] = True                  # a fat blob off-centre
    cable[1, 20:90, 100:110] = True               # a strip too far off-centre
    cable[1, :, 60:66] = True
    cable[2] = rng.random((H, W)) < 0.03          # no component passes
    tape = np.zeros((3, H, W), bool)
    tape[:, 20:70, 40:75] = True
    tape[:, 0:6, :] = True
    pp, jpp = (mod.PostprocessCfg(enabled=True, cable_min_area=200) for mod in (presets, jpresets))
    tc, tt = torch.from_numpy(cable), torch.from_numpy(tape)
    jc, jt = jnp.asarray(cable), jnp.asarray(tape)
    for roi_w in (W, 90):
        want = jax.jit(lambda c: jstages.filter_cable_by_shape(c, jpp, roi_w))(jc)
        got = stages.filter_cable_by_shape(tc, pp, roi_w)
        _eq(got, want, f"filter_cable_by_shape {roi_w}")
    assert got[0].any() and not got[2].any()
    best = torch.from_numpy(np.array(want))
    jbest = jnp.asarray(want)
    _eq(stages.constrain_tape_to_ring(tt, best, pp),
        jax.jit(lambda t, c: jstages.constrain_tape_to_ring(t, c, jpp))(jt, jbest), "ring")
    for pad in (0, 5, 80):
        _eq(stages.cable_bbox_limit(tt, best, pad),
            jax.jit(lambda t, c: jstages.cable_bbox_limit(t, c, pad))(jt, jbest), f"bbox {pad}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_defect_map_from_thresholds_matches_jitted_jax(dtype):
    cfgs = [mod.v3_high_quality().replace_in("preprocess", model_size=(64, 64))
            for mod in (presets, jpresets)]
    lg = _logits(11, 6, scale=1.5)
    rng = np.random.default_rng(12)
    cable, tape = rng.random((2, 2, 96, 128)) < 0.3
    jl = jnp.asarray(lg).astype(getattr(jnp, dtype))
    want = jax.jit(lambda x, c, t: jstages.defect_map_from_thresholds(x, c, t, cfgs[1], (96, 128)))(
        jl, jnp.asarray(cable), jnp.asarray(tape))
    tl = torch.from_numpy(np.ascontiguousarray(lg.transpose(0, 3, 1, 2))).to(getattr(torch, dtype))
    got = stages.defect_map_from_thresholds(tl, torch.from_numpy(cable), torch.from_numpy(tape),
                                            cfgs[0], (96, 128))
    _eq(got, want)
    assert set(np.unique(got.numpy())) >= {0, 1, 2, 4, 5, 6}


def test_imagenet_model_input_matches_jitted_jax():
    frames = synthetic_frames(2, 48, 80, seed=3)
    cfgs = [mod.two_stage().replace_in("preprocess", model_size=(64, 64),
                                       normalization="imagenet") for mod in (presets, jpresets)]
    want = jax.jit(lambda f: jstages.model_input(jstages.geometric_preprocess(f, cfgs[1]),
                                                 cfgs[1]))(jnp.asarray(frames))
    got = stages.model_input(stages.geometric_preprocess(torch.from_numpy(frames), cfgs[0]),
                             cfgs[0])
    _close(got, want)


def test_centroid_past_2_24_and_the_gates_that_read_it():
    """ComponentStats.cx of a component whose column sum passes 2**24: the
    port sums in int64 and rounds once, the JAX package adds float32 in
    pixel order (ROADMAP C). The centroids differ in the last bits; the
    refine and shape gates that read them keep the same components here,
    where no centroid lies that close to a gate's edge."""
    m = np.zeros((1, 300, 512), bool)
    m[0, 10:290, 200:460] = True                      # column sum 2.4e7
    m[0, 20:280, 20:40] = True
    labels = np.array(jcc.connected_components(jnp.asarray(m)))
    got = cc.component_stats(torch.from_numpy(labels), 4)
    want = jax.jit(jcc.component_stats, static_argnums=1)(jnp.asarray(labels), 4)
    exact = float(np.mean(np.nonzero(m[0, 10:290, 200:460])[1] + 200))
    assert float(got.cx[0, 0]) == np.float32(exact) == 329.5
    # the JAX package's float32 sum drifts by 0.15 px here (329.3498)
    assert 0.05 < abs(float(got.cx[0, 0]) - float(want.cx[0, 0])) < 0.5
    _eq(got.cx[:, 1:], want.cx[:, 1:], "cx below 2**24")
    p, jp = _small_post(presets, "refine"), _small_post(jpresets, "refine")
    _eq(stages.refine_mask_by_geometry(torch.from_numpy(m), p),
        jax.jit(lambda x: jstages.refine_mask_by_geometry(x, jp))(jnp.asarray(m)))
    pp, jpp = (mod.PostprocessCfg(enabled=True) for mod in (presets, jpresets))
    _eq(stages.filter_cable_by_shape(torch.from_numpy(m), pp, 512),
        jax.jit(lambda x: jstages.filter_cable_by_shape(x, jpp, 512))(jnp.asarray(m)))


# ---------------------------------------------------------------------------
# pipeline/sliding_window.py
# ---------------------------------------------------------------------------

class _TwoClass(torch.nn.Module):
    """A 2-class model: the defect logit grows with green over red, so the
    probabilities spread over the gate and hysteresis thresholds."""

    def forward(self, x):
        d = 8.0 * (x[:, 1] - x[:, 0])
        return torch.stack([torch.zeros_like(d), d], dim=1)


class _JTwoClass:
    def apply(self, variables, x, train=False):
        d = 8.0 * (x[..., 1] - x[..., 0])
        return jnp.stack([jnp.zeros_like(d), d], axis=-1)


def test_sliding_window_matches_jax():
    """predict (gated and not) within 1e-4 of the JAX package's (the
    resizes' lerps are fused multiply-adds under jit), then the hysteresis,
    the component + mean-probability filter and the threshold scan on the
    same probabilities, bit for bit."""
    from unet_tpu.pipeline import sliding_window as jsw
    from unet_tpu_torch.pipeline import sliding_window as sw

    img = defect_scenes(1, 160, 224, seed=5, classes=1)[0]
    kw = dict(patch_size=96, stride=48, target_size=64, gate_thr=0.7)
    port = sw.SlidingWindowInference(_TwoClass(), device="cpu", **kw)
    ref = jsw.SlidingWindowInference(_JTwoClass(), {}, **kw)
    for gating in (True, False):
        got, want = port.predict(img, gating), ref.predict(img, gating)
        assert got.shape == want.shape == (160, 224, 2)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pm = np.ascontiguousarray(want[..., 1])[None]
    hyst = sw.apply_hysteresis(torch.from_numpy(pm), 0.9, 0.6)
    jhyst = jsw.apply_hysteresis(jnp.asarray(pm), 0.9, 0.6)
    _eq(hyst, jhyst)
    for min_area, thr in ((5, 0.85), (40, 0.9)):
        _eq(sw.filter_by_cc_and_prob(hyst, torch.from_numpy(pm), min_area, thr),
            jsw.filter_by_cc_and_prob(jhyst, jnp.asarray(pm), min_area, thr))
    assert 0 < int(hyst.sum()) and 0 < int(sw.filter_by_cc_and_prob(hyst, torch.from_numpy(pm),
                                                                    5, 0.85).sum())
    gt = [pm[0] > 0.8]
    assert sw.scan_thresholds([want], gt) == jsw.scan_thresholds([want], gt)
