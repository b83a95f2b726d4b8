"""The port's two_stage and enhanced steps (unet_tpu_torch.pipeline.stages)
against the JAX package's, end to end at model_size 64x64 on synthetic cable
scenes."""
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import ColourClassModel, enhanced_scenes, synthetic_frames
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.pipeline import presets, stages

H, W = 224, 400


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
        self.logits = torch.from_numpy(np.array(logits_nchw))

    def forward(self, x):
        return self.logits


class _JFixedLogits:
    def __init__(self, logits_nhwc: np.ndarray):
        self.logits = jnp.asarray(logits_nhwc)

    def apply(self, variables, x, train=False):
        return self.logits


def _cfg(jax_side: bool):
    mod = jpresets if jax_side else presets
    return mod.two_stage().replace_in("preprocess", model_size=(64, 64))


def _assert_same(got, want):
    for name in ("class_map", "cable_px", "tape_px", "burr_px"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_crop_box_is_448x384():
    y1, y2, x1, x2 = stages.roi_crop_box(presets.two_stage(), (448, 800))
    assert (y1, y2, x1, x2) == (0, 448, 183, 567)


def test_crop_box_enhanced_is_448x512():
    # ROI(200, 0, 600, 448) in (800, 448), pad 25 + 5 + 24 = 54, width
    # rounded up to 512
    y1, y2, x1, x2 = stages.roi_crop_box(presets.enhanced(), (448, 800))
    assert (y1, y2, x1, x2) == (0, 448, 146, 658)


@pytest.mark.parametrize("seed", [0, 3])
def test_two_stage_fabricated_logits_bit_identical(seed):
    frames = synthetic_frames(2, H, W, seed=seed, patch=14)
    want = jstages.build_step(_JColourClassModel(), _cfg(True))({}, jnp.asarray(frames))
    got = stages.build_step(ColourClassModel(), _cfg(False), device="cpu")(frames)
    _assert_same(got, want)
    assert got.cable_px.min() > 0 and got.tape_px.min() > 0
    assert got.burr_px.sum() > 0, "no burr candidate survived: stage 2 untested"


def test_two_stage_nested_unet_shared_weights():
    """Real NestedUNet, flax-initialised weights carried across. Masks must
    agree wherever the JAX logits' top-2 margin is >= 1e-3; on those logits
    stage 2 is then identical (checked by feeding both pipelines the JAX
    logits)."""
    frames = synthetic_frames(2, H, W, seed=5, patch=14)
    jm = JNestedUNet(num_classes=3, deep_supervision=True)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 64, 64, 3)), train=False))
    # spread the classes so cable reaches the ROI and stage 2 runs
    jcfg = _cfg(True)
    x = jstages.model_input(jstages.geometric_preprocess(jnp.asarray(frames), jcfg), jcfg)
    logits = np.asarray(jm.apply(variables, x, train=False))
    variables["params"]["final"]["bias"] = (
        variables["params"]["final"]["bias"] - logits.mean(axis=(0, 1, 2))
        + np.array([0.0, 0.3, -0.3], np.float32)).astype(np.float32)
    logits = np.asarray(jm.apply(variables, x, train=False))

    tm = NestedUNet(num_classes=3, deep_supervision=False)
    tm.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        tx = stages.model_input(stages.geometric_preprocess(
            torch.from_numpy(frames), _cfg(False)), _cfg(False))
        tlogits = tm.eval()(tx.permute(0, 3, 1, 2).contiguous()).numpy()
    np.testing.assert_allclose(tlogits.transpose(0, 2, 3, 1), logits,
                               atol=1e-3, rtol=1e-3)
    top2 = np.sort(logits, axis=-1)
    sure = (top2[..., -1] - top2[..., -2]) >= 1e-3
    assert np.array_equal(tlogits.argmax(1)[sure], logits.argmax(-1)[sure])

    want = jstages.build_step(jm, jcfg)(variables, jnp.asarray(frames))
    got = stages.build_step(tm, _cfg(False), device="cpu")(frames)
    assert np.asarray(want.cable_px).min() > 0
    if sure.all():
        _assert_same(got, want)
    # stage 2 on the JAX logits, through both pipelines
    want = jstages.build_step(_JFixedLogits(logits), jcfg)({}, jnp.asarray(frames))
    got = stages.build_step(_FixedLogits(logits.transpose(0, 3, 1, 2)), _cfg(False),
                            device="cpu")(frames)
    _assert_same(got, want)


@pytest.mark.parametrize("seed,denoise", [(0, "nlm"), (2, "nlm"), (2, "bilateral"),
                                          (0, "none")])
def test_enhanced_colour_model_matches_jax(seed, denoise):
    """The enhanced step at normalize_wh (200, 112): scenes rotated
    clockwise, so that the preset's counter-clockwise turn gives back a
    vertical cable inside ROI x 200-600 of 800. Flat backgrounds with noise 2
    keep CLAHE from turning the background into edges. The enhanced frames
    differ from the JAX package's in the last float bits (exp, pow), so the
    class maps are held at agreement >= 0.999; on these scenes they are
    equal."""
    H2, W2 = 112, 200
    frames = enhanced_scenes(2, H2, W2, seed=seed, patch=14)
    assert frames.shape == (2, W2, H2, 3)
    jcfg = jpresets.enhanced(denoise=denoise).replace_in(
        "preprocess", normalize_wh=(W2, H2), model_size=(64, 64))
    cfg = presets.enhanced(denoise=denoise).replace_in(
        "preprocess", normalize_wh=(W2, H2), model_size=(64, 64))
    want = jstages.build_step(_JColourClassModel(), jcfg)({}, jnp.asarray(frames))
    got = stages.build_step(ColourClassModel(), cfg, device="cpu")(frames)
    assert got.class_map.shape == (2, H2, W2)
    agree = float((got.class_map.numpy() == np.asarray(want.class_map)).mean())
    assert agree >= 0.999, agree
    assert got.cable_px.min() > 0 and got.tape_px.min() > 0
    if denoise == "nlm":     # the other denoisers leave no burr on these scenes
        assert got.burr_px.sum() > 0, "no burr candidate survived: stage 2 untested"
        for name in ("cable_px", "tape_px", "burr_px"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), atol=2)


def test_unported_branches_raise():
    model = ColourClassModel()
    for name in ("video_full", "strict", "robust", "spatial", "roi_first"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            stages.build_step(model, presets.get_preset(name), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        stages.build_step(model, presets.enhanced(denoise="median"), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        NestedUNet(num_classes=3, pretrained_encoder=True)


def _precision_flags():
    b = torch.backends
    return (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision,
            b.cudnn.fp32_precision, b.cuda.matmul.fp32_precision, b.fp32_precision)


class _PrecisionProbe(ColourClassModel):
    """ColourClassModel that records the cuDNN conv precision its forward
    runs under."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(torch.backends.cudnn.conv.fp32_precision)
        return super().forward(x)


@pytest.mark.parametrize("start", ["default", "legacy_tf32_off", "conv_tf32", "conv_ieee"])
def test_step_pins_fp32_convs_and_restores_the_flags(start):
    """The step runs the forward with cuDNN convs in full fp32 (no TF32),
    whatever the process-wide flags say, and leaves them as it found them."""
    saved = _precision_flags()
    try:
        if start == "legacy_tf32_off":
            torch.backends.cudnn.allow_tf32 = False
        elif start != "default":
            torch.backends.cudnn.conv.fp32_precision = start.split("_")[1]
        before = _precision_flags()
        probe = _PrecisionProbe()
        step = stages.build_step(probe, _cfg(False), device="cpu")
        step(synthetic_frames(1, H, W, seed=0, patch=14))
        assert probe.seen == ["ieee"]
        assert _precision_flags() == before
    finally:
        b = torch.backends
        (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision,
         b.cuda.matmul.fp32_precision, b.fp32_precision) = saved


def test_forward_logits_from_threads_restores_the_flags():
    """Forwards from several threads each run with fp32 convs and leave the
    process-wide precision as it was. The threads start 10 ms apart and each
    forward takes 50 ms, so unguarded set/restore pairs would interleave and
    the last restore would leave "ieee"."""
    saved = _precision_flags()
    try:
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        before = _precision_flags()

        class Slow(_PrecisionProbe):
            def forward(self, x):
                out = super().forward(x)
                time.sleep(0.05)
                return out

        probe = Slow()
        x = torch.zeros(1, 3, 8, 8)
        threads = [threading.Thread(target=stages.forward_logits, args=(probe, x))
                   for _ in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        for t in threads:
            t.join()
        assert probe.seen == ["ieee"] * 4
        assert _precision_flags() == before
    finally:
        b = torch.backends
        (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision,
         b.cuda.matmul.fp32_precision, b.fp32_precision) = saved


def test_chip_smoke_low_precision_phases_run_on_the_cpu(monkeypatch):
    """chip_smoke.py's bf16/int8 phase and qconv phase, end to end on the
    CPU at a small size (plain versions, so no kernel launches and zero
    counts; the card's timers replaced by host clocks): the rehearsal of the
    chip run's new code."""
    import chip_smoke as cs

    def host_ms(fn, reps=1, warmup=0):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_time_ms", host_ms)
    monkeypatch.setattr(cs, "_time_step", lambda step, frames, reps=1: host_ms(lambda: step(frames)))
    monkeypatch.setattr(cs, "_profile_step", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_device_ops", lambda fn: 0)
    zero = {"cc_propagate": 0, "cc_propagate_cluster": 0, "cc_propagate_global": 0,
            "cc_propagate_cluster8": 0, "cc_propagate_cluster16": 0,
            "nlm": 0, "qconv": 0, "qconv_wgmma": 0, "qconv_sync": 0, "qconv_c3": 0}
    expect = {"two_stage_bf16": zero, "two_stage_int8": zero}
    counts = {}
    cfg = presets.two_stage().replace_in("preprocess", model_size=(32, 32))
    timings, q_rec, checks, ups = cs.phase_low_precision(cfg, expect, counts, 1.0, "cpu", 112,
                                                         200, device="cpu")
    assert set(timings) == set(counts) == set(ups) == {"two_stage_bf16", "two_stage_int8"}
    for path, up in ups.items():
        assert up["calls_per_forward"] == 4
        assert [c["shape"][1] for c in up["per_call"]] == [2, 4, 8, 16]
        assert up["sum_ms"] == sum(c["ms"] for c in up["per_call"]) > 0
    assert checks["int8_taps_bit_identical_card_vs_cpu"] == 19
    assert len(q_rec) == 18
    per_route, max_err = cs.phase_qconv(q_rec, device="cpu")
    assert max_err == 0
    assert {r: len(v) for r, v in per_route.items()} == {"wgmma": 17, "c3": 1, "sync": 0}
    assert per_route["c3"][0]["site"] == "two_stage_int8/conv0_0.conv1"
    assert per_route["c3"][0]["f32_epilogue_ms"] > 0
    assert all(p["library_ms"] > 0 and p["sync_ms"] > 0 for v in per_route.values() for p in v)


def test_build_step_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.build_step(ColourClassModel(), presets.two_stage())
