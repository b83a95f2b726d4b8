"""The eight presets of tests/test_torch_presets.py (video_full, optimized,
robust, simple_7class, strict, v3_high_quality, spatial, roi_first)
through the port's step and the jitted JAX step on the CPU, with
colour->class models (7 and 6 classes paint the defect colours of
chip_smoke.defect_scenes) and with seeded logits whose probabilities
spread over every threshold; also the `laplacian` and `dog` burr stages
and the defect tracker's components on a 3-class model. Model input
64x64, frames up to 128x160; the `slow` cases run the eight at 448x800
and their own model sizes. Class maps, px counts and the integer fields
of diameters, defects and defect components bit for bit; float fields
within 1e-4, the quality statistics within 1e-4 relative."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import (ColourClassModel, ColourDefectModel, defect_scenes, synthetic_frames,
                        wrap_scenes)
from tests.test_torch_presets import NEW_PRESETS, _close, _eq, _fields, _logits, _small_post
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.pipeline import presets, stages


# ---------------------------------------------------------------------------
# the eight presets, both steps
# ---------------------------------------------------------------------------

class _JColourClassModel:
    """JAX twin of chip_smoke.ColourClassModel / ColourDefectModel (NHWC)."""

    def __init__(self, num_classes=3):
        self.num_classes = num_classes

    def apply(self, variables, x, train=False):
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        hi, lo = (lambda c: c > 0.6), (lambda c: c < 0.4)
        cable = hi(r) & hi(b)
        tape = hi(r) & lo(b) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        colours = (hi(g) & lo(r) & lo(b), hi(b) & lo(r) & lo(g),
                   hi(r) & hi(g) & lo(b), hi(r) & hi(b) & lo(g))
        for k in range(3, self.num_classes):
            cls = jnp.where(colours[k - 3], k, cls)
        return jax.nn.one_hot(cls, self.num_classes) * 10.0


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


# (frame H, W) of each preset's CPU parity: robust's letterbox and
# roi_first's crop see frames wider than tall, as the 448x800 frames are
PRESET_FRAMES = {"video_full": (96, 128), "optimized": (96, 128), "simple_7class": (96, 128),
                 "strict": (96, 128), "v3_high_quality": (96, 128), "robust": (96, 128),
                 "spatial": (128, 160), "roi_first": (56, 128)}


def _preset(mod, name):
    cfg = mod.get_preset(name).replace_in("preprocess", model_size=(64, 64))
    if name in ("spatial", "roi_first"):
        cfg = cfg.replace(postprocess=_small_post(mod, cfg.postprocess.mode))
    return cfg


def _scenes(name, B=2, seed=4):
    H, W = PRESET_FRAMES[name]
    n = presets.get_preset(name).segment.num_classes
    return defect_scenes(B, H, W, seed=seed, classes=n - 3) if n > 3 else wrap_scenes(B, H, W, seed)


def _assert_step_outputs(got, want):
    for name in ("class_map", "cable_px", "tape_px", "burr_px"):
        _eq(getattr(got, name), getattr(want, name), name)
    for part in ("diameters", "defects", "defect_components", "quality"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        if g is None:
            continue
        if part == "quality":
            for f in g._fields:
                _close(getattr(g, f), getattr(w, f), f, rtol=1e-4)
        else:
            _fields(g, w)


def _steps(name, model, jmodel):
    return (stages.build_step(model, _preset(presets, name), device="cpu"),
            jstages.build_step(jmodel, _preset(jpresets, name)))


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_presets_with_colour_model_match_jitted_jax(name):
    """Each preset through both build_steps with the colour->class model of
    its class count: class map, px counts and every field of diameters,
    defects, defect components and quality statistics."""
    n = presets.get_preset(name).segment.num_classes
    frames = _scenes(name)
    prev = frames[1:2] if name in ("video_full", "optimized") else None
    step, jstep = _steps(name, ColourDefectModel(n), _JColourClassModel(n))
    kw = {} if prev is None else dict(prev_frame_bgr=prev)
    got = step(frames, **kw)
    want = jstep({}, jnp.asarray(frames), **{k: jnp.asarray(v) for k, v in kw.items()})
    _assert_step_outputs(got, want)
    assert int(got.cable_px.min()) > 0 and int(got.tape_px.min()) > 0
    if got.defects is not None and n > 3:
        assert int(got.defects.total_defect_area.min()) > 0
    if got.defect_components is not None:
        assert got.defect_components.valid.sum(-1).min() >= n - 3
    if got.quality is not None:
        assert float(got.quality.mad[0]) > 0


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_presets_with_seeded_logits_match_jitted_jax(name):
    """Seeded logits whose probabilities spread over every threshold."""
    n = presets.get_preset(name).segment.num_classes
    lg = _logits(20 + len(name), n)
    frames = _scenes(name, seed=6)
    step, jstep = _steps(name, _FixedLogits(np.ascontiguousarray(lg.transpose(0, 3, 1, 2))),
                         _JFixedLogits(lg))
    _assert_step_outputs(step(frames), jstep({}, jnp.asarray(frames)))


@pytest.mark.parametrize("method", ["laplacian", "dog"])
def test_burr_laplacian_and_dog_match_jitted_jax(method):
    frames = synthetic_frames(2, 96, 128, seed=2, patch=10)
    cfgs = [mod.two_stage().replace_in("preprocess", model_size=(64, 64)).replace(
        roi=None).replace_in("burr", method=method, band_px=4, min_area=5, laplacian_thresh=10)
        for mod in (presets, jpresets)]
    got = stages.build_step(ColourClassModel(), cfgs[0], device="cpu")(frames)
    want = jstages.build_step(_JColourClassModel(), cfgs[1])({}, jnp.asarray(frames))
    _assert_step_outputs(got, want)
    assert int(got.burr_px.sum()) > 0


def test_track_defects_on_burr_of_a_three_class_model():
    """A 3-class model has no defect classes: the tracker's components are
    the burr's, class 3."""
    frames = synthetic_frames(2, 128, 160, seed=3, patch=10)
    cfgs = [mod.two_stage().replace_in("preprocess", model_size=(64, 64)).replace_in(
        "inspect", track_defects=True, quality_stats=True) for mod in (presets, jpresets)]
    got = stages.build_step(ColourClassModel(), cfgs[0], device="cpu")(frames)
    want = jstages.build_step(_JColourClassModel(), cfgs[1])({}, jnp.asarray(frames))
    _assert_step_outputs(got, want)
    dc = got.defect_components
    assert int(dc.valid.sum()) > 0 and set(dc.class_id[dc.valid].tolist()) == {3}
    assert float(got.quality.mad[0]) == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("name", NEW_PRESETS)
def test_presets_at_full_size_match_jitted_jax(name):
    """Each preset at its own model size and gates on 448x800 frames
    (chip_smoke.preset_scenes), one frame, with the colour->class model:
    the 512x512 labels, robust's ring and roi_first's crop at the sizes the
    card runs (slow: the JAX step compiles for a minute)."""
    from chip_smoke import preset_colour_model, preset_scenes

    n = presets.get_preset(name).segment.num_classes
    frames = preset_scenes(name, 1, 448, 800, 1)
    got = stages.build_step(preset_colour_model(n), presets.get_preset(name),
                            device="cpu")(frames)
    want = jstages.build_step(_JColourClassModel(n), jpresets.get_preset(name))(
        {}, jnp.asarray(frames))
    _assert_step_outputs(got, want)
    assert int(got.cable_px.min()) > 0 and int(got.tape_px.min()) > 0
