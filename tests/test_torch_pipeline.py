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

from chip_smoke import ColourClassModel, enhanced_scenes, high_res_scenes, synthetic_frames
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.pipeline import presets, stages
from tests.torch_threads import one_intra_op_thread  # noqa: F401

H, W = 224, 400


class _JColourClassModel:
    """JAX twin of chip_smoke.ColourClassModel (NHWC)."""

    def apply(self, variables, x, train=False):
        cable = (x[..., 0] > 0.6) & (x[..., 2] > 0.6)
        tape = (x[..., 0] > 0.6) & (x[..., 2] < 0.4) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        return jax.nn.one_hot(cls, 3) * 10.0


def enhanced_colour_model_matches_jax(seed, denoise):
    """The body of test_enhanced_colour_model_matches_jax, whose cases
    tests/test_torch_enhanced_step.py and test_torch_enhanced_denoisers.py
    split between them. The enhanced step at normalize_wh (200, 112):
    scenes rotated clockwise, so that the preset's counter-clockwise turn
    gives back a vertical cable inside ROI x 200-600 of 800. Flat
    backgrounds with noise 2 keep CLAHE from turning the background into
    edges. The enhanced frames differ from the JAX package's in the last
    float bits (exp, pow), so the class maps are held at agreement >= 0.999;
    on these scenes they are equal."""
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


def test_unported_branches_raise():
    """Every preset builds; what raises is a denoiser the JAX package does
    not have (A9). The ResNet50 encoder (A13) builds, and its step too; the
    BN-folded fast forward is the custom encoder's only."""
    model = ColourClassModel()
    for name in ("video_full", "strict", "robust", "spatial", "roi_first"):
        stages.build_step(model, presets.get_preset(name), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        stages.build_step(model, presets.enhanced(denoise="median"), device="cpu")
    r50 = NestedUNet(num_classes=3, pretrained_encoder=True)
    assert r50.pretrained_encoder and r50.conv4_0[0].conv3.out_channels == 2048
    stages.build_step(r50, presets.two_stage(), device="cpu")
    with pytest.raises(ValueError, match="custom-encoder NestedUNet"):
        stages.build_step(r50, presets.two_stage().replace_in("segment", fast_forward=True),
                          device="cpu")


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


def test_build_step_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.build_step(ColourClassModel(), presets.two_stage())


def test_high_res_roi_colour_model_bit_identical():
    """high_res_roi (ROADMAP A8): two 2048x2448 frames, turned and resized
    to 800x448, the burr stage on its 448x384 crop; class map and px counts
    equal to the jitted JAX step's, with burr found."""
    frames = high_res_scenes(2, seed=1, patch=20)
    assert frames.shape == (2, 2048, 2448, 3)
    jcfg = jpresets.high_res_roi().replace_in("preprocess", model_size=(64, 64))
    cfg = presets.high_res_roi().replace_in("preprocess", model_size=(64, 64))
    want = jstages.build_step(_JColourClassModel(), jcfg)({}, jnp.asarray(frames))
    got = stages.build_step(ColourClassModel(), cfg, device="cpu")(frames)
    _assert_same(got, want)
    assert got.class_map.shape == (2, 448, 800)
    assert got.cable_px.min() > 0 and got.tape_px.min() > 0
    assert got.burr_px.min() > 0, "no burr survived the resize: stage 2 untested"
    assert stages.roi_crop_box(cfg, (448, 800)) == (0, 448, 215, 599)   # 448x384


def test_debug_fixed_7_class_logits_bit_identical():
    """debug (ROADMAP A8): plain argmax of a 7-class model, no ROI, no burr
    stage; fixed logits with ties between classes."""
    rng = np.random.default_rng(8)
    logits = rng.integers(0, 4, (2, 64, 64, 7)).astype(np.float32)   # many ties
    frames = synthetic_frames(2, 96, 160, seed=8)
    jcfg = jpresets.debug().replace_in("preprocess", model_size=(64, 64))
    cfg = presets.debug().replace_in("preprocess", model_size=(64, 64))
    want = jstages.build_step(_JFixedLogits(logits), jcfg)({}, jnp.asarray(frames))
    got = stages.build_step(_FixedLogits(logits.transpose(0, 3, 1, 2)), cfg,
                            device="cpu")(frames)
    _assert_same(got, want)
    assert got.cable_px.min() > 0 and got.tape_px.min() > 0 and int(got.burr_px.sum()) == 0
