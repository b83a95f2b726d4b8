"""The port's BN-folded fast forward (unet_tpu_torch.models.fast_forward)
and its align-corners upsample against the JAX package's, on the CPU: the
upsample bit for bit in bf16, the f32 forward within the JAX package's own
gate (rtol/atol 2e-4, tests/test_fast_forward.py), bf16 class maps > 0.995
(tests/test_fast_forward.py:66-77), and the two_stage step with
`segment.fast_forward` against JAX's run_pipeline."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import ColourClassModel, synthetic_frames
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.models import fast_forward as jff
from unet_tpu.ops.image import upsample2x_align_corners as jupsample
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models import fast_forward as ff
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.ops.image import upsample2x_align_corners
from unet_tpu_torch.pipeline import presets, stages


def randomised_variables(seed: int = 7):
    """Flax NestedUNet variables at 64^2 with BN statistics, scales and
    biases randomised as tests/test_fast_forward.py:14-35 does, as numpy."""
    import flax
    model = JNestedUNet(num_classes=3, deep_supervision=True)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    flat = flax.traverse_util.flatten_dict(variables)
    out = {}
    keys = jax.random.split(jax.random.PRNGKey(3), len(flat))
    for k, (path, v) in zip(keys, flat.items()):
        if path[0] == "batch_stats" and path[-1] == "mean":
            v = jax.random.normal(k, v.shape) * 0.2
        elif path[0] == "batch_stats" and path[-1] == "var":
            v = jnp.abs(jax.random.normal(k, v.shape)) * 0.5 + 0.5
        elif path[-1] in ("scale",):
            v = 1.0 + jax.random.normal(k, v.shape) * 0.1
        elif path[-1] == "bias":
            v = jax.random.normal(k, v.shape) * 0.05
        out[path] = np.asarray(v, np.float32)
    return flax.traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def shared():
    """(flax variables, the port's state dict, a (2, 64, 64, 3) input)."""
    variables = randomised_variables()
    tm = NestedUNet(num_classes=3, deep_supervision=False)
    tm.load_state_dict(state_dict_from_flax(variables))
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    return variables, tm.state_dict(), x


@pytest.mark.parametrize("n", [1, 2, 7, 32])
@pytest.mark.parametrize("values", ["codes", "normal"])
def test_upsample2x_bf16_bit_identical(n, values):
    """bf16, as the bf16 and int8 forwards use it: bit for bit, on int8
    codes (trap of `_up_int8`) and on signed activations."""
    rng = np.random.default_rng(n)
    x = (rng.integers(0, 128, (2, n, n + 3, 8)) if values == "codes"
         else rng.normal(0, 3, (2, n, n + 3, 8))).astype(np.float32)
    want = np.asarray(jupsample(jnp.asarray(x).astype(jnp.bfloat16), 1, 2).astype(jnp.float32))
    got = upsample2x_align_corners(torch.from_numpy(x).to(torch.bfloat16), 1, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2 * n, 2 * n + 6, 8)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_upsample2x_f32_equals_interpolate():
    """float32: the JAX package's and F.interpolate(align_corners=True)'s
    function, up to float32 rounding."""
    x = np.random.default_rng(1).normal(0, 3, (2, 4, 16, 16)).astype(np.float32)
    got = upsample2x_align_corners(torch.from_numpy(x), 2, 3)
    ref = torch.nn.functional.interpolate(torch.from_numpy(x), scale_factor=2,
                                          mode="bilinear", align_corners=True)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    want = np.asarray(jupsample(jnp.asarray(x), 2, 3))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_fold_bn_matches_jax(shared):
    variables, sd, _ = shared
    folded = ff.folded_layers(sd)
    for name in ff.BLOCK_NAMES:
        p, s = variables["params"][name], variables["batch_stats"][name]
        for i, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
            w, b = jff._fold_bn(jnp.asarray(p[conv]["kernel"]), jnp.asarray(p[conv]["bias"]),
                                p[bn], s[bn])
            tw, tb = folded[name][i]
            # XLA's rsqrt and PyTorch's differ in the last bit
            np.testing.assert_allclose(tw.permute(2, 3, 1, 0).numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tb.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_fast_forward_f32_matches_jax(shared):
    variables, sd, x = shared
    want = np.asarray(jff.fast_apply(variables, jnp.asarray(x), dtype=jnp.float32))
    with torch.inference_mode():
        got = ff.fast_apply(sd, torch.from_numpy(x), dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64, 3)
    diff = np.abs(got.numpy() - want).max()
    print(f"f32 fast forward vs JAX fast_apply: max abs diff {diff:.3e}")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_fast_forward_bf16_class_map(shared):
    variables, sd, x = shared
    want = np.asarray(jnp.argmax(jff.fast_apply(variables, jnp.asarray(x)), -1))
    with torch.inference_mode():
        got = ff.fast_apply(sd, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    agree = (got.float().argmax(-1).numpy() == want).mean()
    print(f"bf16 fast forward vs JAX fast_apply bf16: class-map agreement {agree:.6f}")
    assert agree > 0.995


def test_nested_unet_dtype_is_the_compute_type(shared):
    """`NestedUNet(dtype=bfloat16)` keeps float32 parameters, computes its
    own forward in bf16 (class maps against flax's bf16 model > 0.995), and
    the fast path takes bf16 from it."""
    variables, sd, x = shared
    tm = NestedUNet(num_classes=3, deep_supervision=False, dtype=torch.bfloat16)
    tm.load_state_dict(sd)
    assert tm.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        out = tm.eval()(tx)
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    jm = JNestedUNet(num_classes=3, deep_supervision=True, dtype=jnp.bfloat16)
    want = np.asarray(jnp.argmax(jm.apply(variables, jnp.asarray(x), train=False), -1))
    assert (out.float().argmax(1).numpy() == want).mean() > 0.995
    cfg = presets.two_stage().replace_in("segment", fast_forward=True)
    with torch.inference_mode():
        logits = stages.segment_forward(tm, cfg, "cpu")(torch.from_numpy(x))
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 3, 64, 64)
    f32 = NestedUNet(num_classes=3, deep_supervision=False)
    assert stages.segment_forward(f32, cfg, "cpu")(torch.from_numpy(x)).dtype == torch.float32


@pytest.mark.parametrize("segment", [dict(fast_forward=True),
                                     dict(int8_scales=(("input", 0.01),))])
def test_low_precision_forwards_need_a_nested_unet(segment):
    cfg = presets.two_stage().replace_in("segment", **segment)
    with pytest.raises(ValueError, match="fast_forward/int8_scales"):
        stages.build_step(ColourClassModel(), cfg, device="cpu")


def _spread_classes(variables, frames, jcfg, jm):
    """Shift the head's bias so that the random model marks cable inside the
    ROI and the burr stage runs (as tests/test_torch_pipeline.py does)."""
    x = jstages.model_input(jstages.geometric_preprocess(jnp.asarray(frames), jcfg), jcfg)
    logits = np.asarray(jm.apply(variables, x, train=False))
    variables["params"]["final"]["bias"] = (
        variables["params"]["final"]["bias"] - logits.mean(axis=(0, 1, 2))
        + np.array([0.0, 0.3, -0.3], np.float32)).astype(np.float32)
    return variables


def test_two_stage_fast_forward_step_matches_jax():
    """The two_stage step with `segment.fast_forward` and a bf16 model, the
    port's against JAX's run_pipeline with the same config and weights, at
    model size 64^2: class maps agree on > 0.995 of the pixels and the px
    counts within 1 % of the frame (bf16 logits round differently: cuDNN/
    oneDNN against XLA, one rounding per conv against JAX's two)."""
    frames = synthetic_frames(2, 224, 400, seed=5, patch=14)
    jcfg = jpresets.two_stage().replace_in("preprocess", model_size=(64, 64))
    jm = JNestedUNet(num_classes=3, deep_supervision=True, dtype=jnp.bfloat16)
    variables = _spread_classes(randomised_variables(), frames, jcfg, jm)
    want = jstages.build_step(jm, jcfg.replace_in("segment", fast_forward=True))(
        variables, jnp.asarray(frames))
    tm = NestedUNet(num_classes=3, deep_supervision=False, dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_flax(variables))
    cfg = presets.two_stage().replace_in("preprocess", model_size=(64, 64)).replace_in(
        "segment", fast_forward=True)
    got = stages.build_step(tm, cfg, device="cpu")(frames)
    agree = (got.class_map.numpy() == np.asarray(want.class_map)).mean()
    print(f"two_stage fast_forward step vs JAX: class maps {agree:.6f}, cable_px "
          f"{got.cable_px.tolist()} vs {np.asarray(want.cable_px).tolist()}")
    assert np.asarray(want.cable_px).min() > 0
    assert agree > 0.995
    for name in ("cable_px", "tape_px", "burr_px"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=0.01 * 224 * 400)
