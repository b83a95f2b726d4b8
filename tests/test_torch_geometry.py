"""The port's connected components, geometry, geometry presets and host
inspection modules against the JAX package's, on numpy-seeded inputs at
small sizes (model 64x64, frames up to 128 px a side).

Integer results (labels, areas, counts, class maps, px counts, valid rows,
hole counts, defect areas) must be bit-identical. Float results must agree
within 1e-4, the gate of tests/test_ops_clahe_geometry.py: the smoothed
widths sum 31 terms, where XLA may fuse a product into its sum. The
coverages divide by a constant and are held against the JITTED JAX
functions, where that division is a product with the float32 reciprocal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import ColourClassModel, _serpentine, synthetic_frames, wrap_scenes
from unet_tpu.inspect import decision as jdecision
from unet_tpu.inspect import uniformity as juniformity
from unet_tpu.inspect import window as jwindow
from unet_tpu.ops import cc as jcc
from unet_tpu.ops import geometry as jgeo
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.inspect import decision, uniformity, window
from unet_tpu_torch.ops import cc, geometry as geo
from unet_tpu_torch.pipeline import presets, stages

ATOL = 1e-4


def _masks():
    rng = np.random.default_rng(11)
    blobs = np.zeros((2, 40, 56), bool)
    blobs[0, 2:9, 3:10] = True          # area 49
    blobs[0, 20:27, 30:37] = True       # area 49: a tie with the first
    blobs[0, 30:33, 2:50] = True        # area 144
    blobs[1, 5:25, 40:41] = True        # a thin column
    blobs[1, 0, :] = True               # a row on the border
    return {"noise": rng.random((3, 40, 56)) < 0.45, "blobs": blobs,
            "serpentine": _serpentine(2, 41, 57), "empty": np.zeros((1, 16, 24), bool),
            "one batch dim": rng.random((2, 2, 24, 32)) < 0.5}


def _eq(got, want, what=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape, g.dtype, w.dtype)
    assert np.array_equal(g, w), what


def _close(got, want, what=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)


def _fields(got, want, exact=()):
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        (_eq if np.asarray(w).dtype.kind in "biu" or f in exact else _close)(g, w, f)


@pytest.mark.parametrize("name", list(_masks()))
@pytest.mark.parametrize("connectivity,max_iters", [(8, 64), (4, 64), (8, 2)])
def test_connected_components_labels_bit_identical(name, connectivity, max_iters):
    """The labels themselves, root included, also where max_iters cuts the
    propagation short (the serpentine needs more than 2 iterations)."""
    m = _masks()[name]
    want = jcc.connected_components(jnp.asarray(m), connectivity, max_iters)
    got = cc.connected_components(torch.from_numpy(m), connectivity, max_iters)
    _eq(got, want)
    if name == "serpentine" and max_iters == 2:
        full = cc.connected_components(torch.from_numpy(m), connectivity, 64)
        assert not torch.equal(got, full), "the serpentine converged within 2 iterations"


@pytest.mark.parametrize("name,k", [("noise", 4), ("noise", 64), ("blobs", 1), ("blobs", 2),
                                    ("blobs", 8), ("serpentine", 3), ("empty", 5),
                                    ("one batch dim", 6)])
def test_component_stats_bit_identical(name, k):
    """Every field, with more components than K (noise) and ties of equal
    areas, which both order as jax.lax.top_k does: lower label first."""
    labels = np.asarray(jcc.connected_components(jnp.asarray(_masks()[name])))
    want = jax.jit(jcc.component_stats, static_argnums=1)(jnp.asarray(labels), k)
    got = cc.component_stats(torch.from_numpy(labels), k)
    _fields(got, want, exact=("cx", "cy"))
    if name == "blobs" and k == 2:
        # the two 49-pixel squares tie for second place: the lower root wins
        assert got.area[0].tolist() == [144, 49] and got.label[0, 1] == 2 * 56 + 3


@pytest.mark.parametrize("name", ["noise", "blobs", "serpentine", "empty"])
@pytest.mark.parametrize("min_area", [0, 49, 50])
def test_largest_component_and_count_bit_identical(name, min_area):
    m = jnp.asarray(_masks()[name])
    tm = torch.from_numpy(_masks()[name])
    _eq(cc.largest_component(tm, min_area=min_area), jcc.largest_component(m, min_area=min_area))
    for k in (1, 3, 64):
        _eq(cc.count_components(tm, max_components=k), jcc.count_components(m, max_components=k))
    if name == "blobs" and min_area == 49:
        # an area tie between the largest components goes to the lower root
        tie = _masks()["blobs"][:1].copy()
        tie[0, 30:33] = False
        kept = cc.largest_component(torch.from_numpy(tie), min_area=min_area)[0]
        assert kept[2:9, 3:10].all() and not kept[20:27, 30:37].any()


def test_keep_mask_bit_identical():
    labels = np.asarray(jcc.connected_components(jnp.asarray(_masks()["noise"])))
    st_j = jcc.component_stats(jnp.asarray(labels), 16)
    st_t = cc.component_stats(torch.from_numpy(labels), 16)
    keep = np.random.default_rng(4).random((3, 16)) < 0.5
    _eq(cc.keep_mask(torch.from_numpy(labels), st_t, torch.from_numpy(keep)),
        jcc.keep_mask(jnp.asarray(labels), st_j, jnp.asarray(keep)))


def _class_maps(seed=5, shape=(3, 64, 80)):
    """Class maps with a cable strip, a tape band with holes, defect blobs
    and noise, so that every geometry field is non-trivial."""
    rng = np.random.default_rng(seed)
    B, H, W = shape
    pred = np.zeros(shape, np.uint8)
    for b in range(B):
        x1 = 20 + 3 * b
        pred[b, :, x1:x1 + 16] = 1
        pred[b, 10:50, x1 - 5:x1 + 21] = 2
        pred[b, 20:23, x1 + 4:x1 + 8] = 0        # a hole of 12 pixels
        pred[b, 30:32, x1 + 2:x1 + 4] = 0        # a hole under hole_min_size
        pred[b, 55:60, 60:66] = 3 + b
        pred[b, 40:44, 2:6] = 1                  # a second cable component
    noise = rng.random(shape) < 0.02
    pred[noise] = rng.integers(0, 7, noise.sum())
    return pred


def test_width_smooth_median_bit_identical_or_close():
    pred = _class_maps()
    m = pred == 2
    _eq(geo.width_per_row(torch.from_numpy(m)), jgeo.width_per_row(jnp.asarray(m)))
    w = jgeo.width_per_row(jnp.asarray(m))
    for k in (1, 30, 31):
        _close(geo.smooth_widths(torch.from_numpy(np.asarray(w)), k), jgeo.smooth_widths(w, k))
    rng = np.random.default_rng(2)
    x = rng.random((4, 33)).astype(np.float32)
    valid = rng.random((4, 33)) < 0.5
    valid[3] = False
    valid[2] = False
    valid[2, 7] = True
    _eq(geo.masked_median(torch.from_numpy(x), torch.from_numpy(valid)),
        jgeo.masked_median(jnp.asarray(x), jnp.asarray(valid)))


@pytest.mark.parametrize("denoise", [True, False])
def test_diameter_metrics_against_jitted_jax(denoise):
    pred = _class_maps()
    fn = jax.jit(lambda p: jgeo.diameter_metrics(p, denoise=denoise, cc_min_area=30))
    want = fn(jnp.asarray(pred))
    got = geo.diameter_metrics(torch.from_numpy(pred), denoise=denoise, cc_min_area=30)
    _fields(got, want, exact=("cable_coverage", "tape_coverage"))
    assert float(got.dc_px.min()) > 0 and float(got.dt_px.min()) > float(got.dc_px.max())


def test_largest_component_lowres_and_masks_metrics():
    pred = _class_maps(shape=(2, 40, 48))
    low = jnp.asarray(pred == 1)
    for min_area in (0, 50, 3000):
        want = jgeo.largest_component_lowres(low, (96, 120), min_area=min_area)
        got = geo.largest_component_lowres(torch.from_numpy(pred == 1), (96, 120),
                                           min_area=min_area)
        _eq(got, want, f"min_area {min_area}")
    cable, tape = jnp.asarray(pred == 1), jnp.asarray(pred == 2)
    want = jax.jit(lambda c, t: jgeo.diameter_metrics_from_masks(
        c, t, mm_per_px=0.07, min_valid_rows=5, smooth_ksize=9))(cable, tape)
    got = geo.diameter_metrics_from_masks(torch.from_numpy(pred == 1), torch.from_numpy(pred == 2),
                                          mm_per_px=0.07, min_valid_rows=5, smooth_ksize=9)
    _fields(got, want, exact=("cable_coverage", "tape_coverage"))


def test_thickness_and_diameter_profiles():
    pred = _class_maps()
    _fields(geo.thickness_profile(torch.from_numpy(pred)), jgeo.thickness_profile(jnp.asarray(pred)))
    got = geo.diameter_profile(torch.from_numpy(pred), 1, 2, smooth_ksize=15)
    want = jgeo.diameter_profile(jnp.asarray(pred), 1, 2, smooth_ksize=15)
    _close(got[0], want[0])
    _close(got[1], want[1])
    _eq(got[2], want[2])


@pytest.mark.parametrize("hole_min_size,k", [(10, 64), (1, 2), (100, 32)])
def test_analyze_defects_against_jitted_jax(hole_min_size, k):
    pred = _class_maps()
    want = jax.jit(lambda p: jgeo.analyze_defects(p, hole_min_size=hole_min_size,
                                                  max_components=k))(jnp.asarray(pred))
    got = geo.analyze_defects(torch.from_numpy(pred), hole_min_size=hole_min_size,
                              max_components=k)
    _fields(got, want, exact=("tape_hole_ratio", "tape_coverage", "tape_largest_area_ratio"))
    if hole_min_size == 10:
        assert got.tape_num_holes.min() >= 1 and got.cable_num_components.min() >= 2


# ---------------------------------------------------------------------------
# the geometry presets, both steps
# ---------------------------------------------------------------------------

class _JColourClassModel:
    """JAX twin of chip_smoke.ColourClassModel (NHWC)."""

    def apply(self, variables, x, train=False):
        cable = (x[..., 0] > 0.6) & (x[..., 2] > 0.6)
        tape = (x[..., 0] > 0.6) & (x[..., 2] < 0.4) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        return jax.nn.one_hot(cls, 3) * 10.0


class _FixedLogits(torch.nn.Module):
    def __init__(self, logits_nchw: np.ndarray):
        super().__init__()
        self.logits = torch.from_numpy(logits_nchw)

    def forward(self, x):
        return self.logits


class _JFixedLogits:
    def __init__(self, logits_nhwc: np.ndarray):
        self.logits = jnp.asarray(logits_nhwc)

    def apply(self, variables, x, train=False):
        return self.logits


# (frame H, W): the wrap presets label at model resolution (frames at least
# the model's 64x64); three_class_* at frame resolution (H < 64, as 448 <
# 512 on the real frames); production always (it has an ROI)
PRESET_FRAMES = {"wrap_uniformity": (96, 128), "wrap_7class": (96, 128),
                 "production": (128, 160), "three_class_full": (56, 128),
                 "three_class_best": (56, 128)}


def _preset(mod, name):
    return mod.get_preset(name).replace_in("preprocess", model_size=(64, 64))


def _assert_step_outputs(got, want):
    for name in ("class_map", "cable_px", "tape_px", "burr_px"):
        _eq(getattr(got, name), getattr(want, name), name)
    for part in ("diameters", "defects"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        if g is not None:
            _fields(g, w, exact=("cable_coverage", "tape_coverage", "tape_hole_ratio",
                                 "tape_largest_area_ratio"))


def _scenes(name, seed):
    """Wrap scenes (unbroken cable, tape on both sides) for the wrap and
    full-frame presets; production takes the burr scenes of two_stage."""
    H, W = PRESET_FRAMES[name]
    if name == "production":
        return synthetic_frames(2, H, W, seed=seed, patch=10)
    return wrap_scenes(2, H, W, seed=seed)


@pytest.mark.parametrize("name", list(PRESET_FRAMES))
def test_geometry_presets_match_jitted_jax(name):
    """Each preset through both build_steps with the colour->class model:
    class map, px counts and every field of diameters and defects."""
    frames = _scenes(name, 4)
    want = jstages.build_step(_JColourClassModel(), _preset(jpresets, name))({}, jnp.asarray(frames))
    got = stages.build_step(ColourClassModel(), _preset(presets, name), device="cpu")(frames)
    _assert_step_outputs(got, want)
    d = got.diameters
    assert d is not None and (got.defects is not None) == (name == "production")
    if name == "production":
        assert int(got.burr_px.sum()) > 0, "no burr: the burr stage's B1 calls were not run"
        assert got.defects.tape_num_components.min() > 0
    else:
        assert d.valid_rows.min() >= 20 and float((d.dt_px - d.dc_px).min()) > 0


def test_defect_classes_from_a_7_class_model_with_remap():
    """wrap_7class with defect analysis: the argmax of 7-class logits,
    remapped, lays classes >= 3 over the cable/tape map
    (unet_tpu/pipeline/stages.py:612-627, 647-660)."""
    rng = np.random.default_rng(9)
    B, h, w = 2, 64, 64
    logits = rng.normal(0, 1, (B, h, w, 7)).astype(np.float32)
    logits[:, :, 24:40, 1] += 6
    logits[:, 16:48, 20:44, 2] += 8
    logits[:, 4:10, 4:12, 3] += 12
    logits[:, 50:60, 50:58, 5] += 12
    remap = (0, 1, 2, 4, 5, 6, 3)

    def cfg(mod):
        return (_preset(mod, "wrap_7class").replace_in("geometry", analyze_defects=True)
                .replace_in("segment", class_remap=remap))

    frames = synthetic_frames(B, 96, 128, seed=1)
    want = jstages.build_step(_JFixedLogits(logits), cfg(jpresets))({}, jnp.asarray(frames))
    got = stages.build_step(_FixedLogits(np.ascontiguousarray(logits.transpose(0, 3, 1, 2))),
                            cfg(presets), device="cpu")(frames)
    _assert_step_outputs(got, want)
    assert got.defects.total_defect_area.min() > 0
    assert got.defects.defect_areas[:, 1].min() > 0   # class 3 remapped to 4


def test_preset_branches_still_unported_raise():
    """What remains: a denoiser the JAX package does not have names ROADMAP
    A9; an unknown threshold mode raises ValueError when the step runs, as
    the JAX package's does. Every preset builds."""
    model = ColourClassModel()
    with pytest.raises(NotImplementedError, match="A9"):
        stages.build_step(model, presets.enhanced(denoise="median"), device="cpu")
    bad = presets.wrap_uniformity().replace_in("preprocess", model_size=(64, 64)).replace_in(
        "segment", threshold_mode="softmax_argmax")
    step = stages.build_step(model, bad, device="cpu")
    with pytest.raises(ValueError, match="softmax_argmax"):
        step(wrap_scenes(1, 64, 64))
    jbad = jpresets.wrap_uniformity().replace_in("preprocess", model_size=(64, 64)).replace_in(
        "segment", threshold_mode="softmax_argmax")
    with pytest.raises(ValueError, match="softmax_argmax"):
        jstages.build_step(_JColourClassModel(), jbad)({}, jnp.asarray(wrap_scenes(1, 64, 64)))
    for name in presets.PRESETS:
        stages.build_step(model, presets.get_preset(name), device="cpu")


# ---------------------------------------------------------------------------
# host inspection modules, fed the same sequences in both packages
# ---------------------------------------------------------------------------

def test_wrap_uniformity_monitor_and_measure(tmp_path):
    rng = np.random.default_rng(3)
    seq = [(float(dc), float(dt)) for dc, dt in
           zip(rng.uniform(-2, 30, 40), rng.uniform(15, 45, 40))]
    mons = [mod.WrapUniformityMonitor(window_size=8, csv_path=str(tmp_path / f"{i}.csv"))
            for i, mod in enumerate((uniformity, juniformity))]
    for i, (dc, dt) in enumerate(seq):
        assert mons[0].update(i, dc, dt) == mons[1].update(i, dc, dt)
    assert (tmp_path / "0.csv").read_text() == (tmp_path / "1.csv").read_text()
    pred = _class_maps()
    for b in range(2):
        got = uniformity.measure_cable_tape_diameter_px(torch.from_numpy(pred[b]))
        want = juniformity.measure_cable_tape_diameter_px(pred[b])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert uniformity.measure_cable_tape_diameter_px(
        torch.from_numpy(np.zeros((40, 30), np.uint8))) is None


def test_window_aggregator_and_decision_from_the_steps():
    """FrameResult.from_device on each package's production step outputs,
    through WindowAggregator, get_statistics and make_decision."""
    H, W = PRESET_FRAMES["production"]
    frames = wrap_scenes(4, H, W, seed=8)
    outs = (stages.build_step(ColourClassModel(), _preset(presets, "production"),
                              device="cpu")(frames),
            jstages.build_step(_JColourClassModel(), _preset(jpresets, "production"))(
                {}, jnp.asarray(frames)))
    decisions = []
    for mod, out in zip((window, jwindow), outs):
        agg = mod.WindowAggregator(window_duration_sec=0.1, min_frames=2, max_frames=3)
        results = []
        for i in range(4):
            agg.add_frame(mod.FrameResult.from_device(i * 40_000_000, i, out.diameters,
                                                      out.defects, index=i))
            if agg.is_ready():
                results.append(mod.make_decision(
                    agg.get_statistics(), mod.ThresholdConfig(target_delta_d=0.5)))
                agg.reset()
        decisions.append(results)
    got, want = decisions
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.window_id, g.result, g.reasons, g.severity) == \
            (w.window_id, w.result, w.reasons, w.severity)
        assert g.metrics.keys() == w.metrics.keys()
        for k in g.metrics:
            np.testing.assert_allclose(g.metrics[k], w.metrics[k], atol=0.011, err_msg=k)


def test_compute_metrics_and_decide():
    pred = _class_maps()
    thr = jdecision.SimpleThresholds(wrap_delta_max_mm=0.9, bulge_mm=0.1, cv_wrap=0.01)
    for b, mm_per_px in ((0, None), (1, 0.05)):
        want = jdecision.compute_metrics(pred[b], 1, 2, 3, mm_per_px, 9.0)
        got = decision.compute_metrics(torch.from_numpy(pred[b]), 1, 2, 3, mm_per_px, 9.0)
        for k, v in vars(want).items():
            np.testing.assert_allclose(getattr(got, k), v, rtol=1e-5, atol=ATOL, err_msg=k)
        tthr = decision.SimpleThresholds(**vars(thr))
        assert [vars(f) for f in decision.decide(got, tthr)] == \
            [vars(f) for f in jdecision.decide(want, thr)]
    empty = decision.compute_metrics(torch.from_numpy(np.zeros((30, 30), np.uint8)), 1, 2,
                                     None, None, 9.0)
    assert vars(empty) == vars(jdecision.compute_metrics(np.zeros((30, 30), np.uint8), 1, 2,
                                                         None, None, 9.0))
