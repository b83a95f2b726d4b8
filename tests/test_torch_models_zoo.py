"""The port's model zoo against the JAX package's (unet_tpu/models): the
ResNet50 NestedUNet, SimpleUNet and the lightweight UNet++ with each of its
six encoders. With the JAX package's variables carried across by
`state_dict_from_flax` (every flax variable carried, every port key
filled), the eval logits agree within the gates of tests/test_models_parity.py (1e-3,
2e-3 for the resnet50 encoder) and their argmax is equal but on tie pixels
(top two logits within 1e-3), which are counted; bf16 within the tolerance
stated at its test. The encoders' stage features, the deep-supervision
heads in train mode, reference .pth files read by both packages,
`channel_shuffle` and `resize_bilinear_align_corners` are held too. Inputs
come from numpy seeds, at 64^2 (shufflenet's fifth stage is /64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests import torch_zoo as zoo
from tests.torch_ref import TMobileNetV3Features, TNestedUNetResNet50, TSimpleUNet
from unet_tpu.models import convert as jconvert
from unet_tpu.models.mobilenet import MobileNetV3Encoder as JMobileNetV3Encoder
from unet_tpu.models.shufflenet import channel_shuffle as jchannel_shuffle
from unet_tpu.ops.image import resize_bilinear_align_corners as jresize_ac
from unet_tpu_torch.cli.main import load_model
from unet_tpu_torch.models import convert
from unet_tpu_torch.models.mobilenet import (LARGE_LAST, LARGE_SPEC, MobileNetV3Encoder,
                                             SMALL_LAST, SMALL_SPEC)
from unet_tpu_torch.models.shufflenet import channel_shuffle
from unet_tpu_torch.ops.image import resize_bilinear_align_corners
from tests.torch_threads import one_intra_op_thread  # noqa: F401

SIZE = 64


# logits' side at a 64^2 input: the encoder's first stage
OUT_SIDE = {"nested_unet_resnet50": 16, "simple_unet": 64, "lightweight:custom": 64,
            "lightweight:mobilenet_v3_large": 32}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    cache = {}

    def get(arch, train=False):
        if (arch, train) not in cache:
            cache[arch, train] = zoo.jax_variables(arch, 7 if arch == "simple_unet" else 3,
                                                   SIZE, seed=1, train=train)
        return cache[arch, train]
    return get


@pytest.fixture(scope="module")
def jax_logits(x, variables):
    """The JAX model's eval logits on `x`, once per (arch, dtype)."""
    cache = {}

    def get(arch, dtype=jnp.float32):
        if (arch, dtype) not in cache:
            cache[arch, dtype] = zoo.jax_logits(arch, variables(arch), x, _classes(arch), dtype)
        return cache[arch, dtype]
    return get


def _classes(arch):
    return 7 if arch == "simple_unet" else 3


@pytest.mark.parametrize("arch", zoo.ARCHS)
def test_eval_forward_matches_jax(arch, x, variables, jax_logits):
    v = variables(arch)
    k = _classes(arch)
    want = jax_logits(arch)
    model = zoo.port_model(arch, v, k)
    got = zoo.port_logits(model, x)
    side = OUT_SIDE.get(arch, 16)
    assert got.shape == want.shape == (2, side, side, k)
    atol = zoo.ATOL.get(arch, 1e-3)
    err = float(np.abs(got - want).max())
    ties = cs.tie_pixels(torch.from_numpy(want.copy()).permute(0, 3, 1, 2)).numpy()
    flips = got.argmax(-1) != want.argmax(-1)
    print(f"{arch}: logits max abs err {err:.3e} (gate {atol}), {int(ties.sum())} tie "
          f"pixels, {int(flips.sum())} argmax flips")
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-3)
    assert not (flips & ~ties).any()
    # every flax variable has its port key (the model loaded strictly: every
    # port key was filled)
    sd = convert.state_dict_from_flax(v, arch)
    assert len(jax.tree.leaves(v)) == sum(not k.endswith("num_batches_tracked") for k in sd)


@pytest.mark.parametrize("arch", zoo.ARCHS)
def test_bf16_forward_matches_jax(arch, x, variables, jax_logits):
    """bf16 compute on float32 parameters in both packages: the port's bf16
    logits are as far from flax's bf16 logits as flax's own bf16 logits are
    from its float32 ones, within 2x (convs round once in cuDNN/oneDNN and
    per XLA op in flax), and so are their class maps."""
    v = variables(arch)
    k = _classes(arch)
    want, f32 = jax_logits(arch, jnp.bfloat16), jax_logits(arch)
    model = zoo.port_model(arch, v, k, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = zoo.port_logits(model, x)
    err, own = float(np.abs(got - want).max()), float(np.abs(want - f32).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    own_agree = float((want.argmax(-1) == f32.argmax(-1)).mean())
    print(f"{arch} bf16: logits max abs err {err:.3e} against flax bf16 (flax bf16 against "
          f"f32: {own:.3e}); argmax agreement {agree:.4f} ({own_agree:.4f})")
    assert err <= 2 * own
    assert 1 - agree <= 2 * (1 - own_agree) + 1 / got[..., 0].size   # one pixel of slack


@pytest.mark.parametrize("variant,spec,last,channels", [
    ("small", SMALL_SPEC, SMALL_LAST, (16, 24, 40, 48, 576)),
    ("large", LARGE_SPEC, LARGE_LAST, (16, 24, 40, 80, 960))])
def test_mobilenet_stage_features(variant, spec, last, channels):
    """tests/test_mobilenet.py:24-49 for the port: torchvision-layout weights
    load into the encoder as they are (`mobilenet_encoder_state_dict`), and
    its five stages equal the torch stack cut at SMALL/LARGE_STAGES and the
    JAX encoder's, within 5e-5 / 1e-4."""
    tm = TMobileNetV3Features(spec, last).eval()
    g = torch.Generator().manual_seed(0)
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    sd = {f"backbone.{k}": v for k, v in tm.state_dict().items()}
    enc = MobileNetV3Encoder(variant).eval()
    enc.load_state_dict(convert.mobilenet_encoder_state_dict(sd, variant, "backbone."))
    assert enc.out_channels == channels
    xt = torch.randn(1, 3, SIZE, SIZE, generator=g)
    want, y = [], xt
    with torch.inference_mode():
        for idx, layer in enumerate(tm.features):
            y = layer(y)
            if idx + 1 in (2, 4, 7, 9):
                want.append(y.numpy())
        want.append(y.numpy())
        got = [f.numpy() for f in enc(xt)]
    jv = jconvert.convert_mobilenet_encoder({k: v.numpy() for k, v in tm.state_dict().items()},
                                            variant)
    jenc = JMobileNetV3Encoder(variant=variant)
    jf = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(
        jv, jnp.asarray(xt.numpy().transpose(0, 2, 3, 1)))
    assert [f.shape[1] for f in got] == list(channels)
    for f, w, j in zip(got, want, jf):
        np.testing.assert_allclose(f, w, atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(f, np.asarray(j).transpose(0, 3, 1, 2), atol=5e-5, rtol=1e-4)
    del sd["backbone.features.3.block.0.1.running_var"]
    with pytest.raises(KeyError, match="features.3.block.0.1.running_var"):
        convert.mobilenet_encoder_state_dict(sd, variant, "backbone.")


@pytest.mark.parametrize("arch", ["nested_unet_resnet50", "lightweight:mobilenet_v3_small"])
def test_train_mode_heads_match_jax(arch, variables):
    """Train mode with deep supervision: [out, ds1_3, ds2_2, ds3_1], the main
    output at the first stage's resolution, the heads resized to the input
    (align corners), BatchNorm on the batch's statistics; values within the
    train-mode gate of tests/test_models_parity.py (2e-3 / 1e-3)."""
    v = variables(arch, train=True)
    xs = np.random.default_rng(3).normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = zoo.jax_model(arch, 3, deep_supervision=True)
    wants, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(xs))
    model = zoo.port_model(arch, v).train()
    assert model.deep_supervision
    with torch.no_grad():
        outs = model(torch.from_numpy(xs.transpose(0, 3, 1, 2).copy()))
    assert len(outs) == len(wants) == 4
    side = OUT_SIDE.get(arch, 16)
    assert tuple(outs[0].shape) == (2, 3, side, side)
    for got, want in zip(outs, wants):
        if got is not outs[0]:
            assert tuple(got.shape) == (2, 3, SIZE, SIZE)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   atol=2e-3, rtol=1e-3)


def _randomize_bn(model, g):
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.2)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)


@pytest.mark.parametrize("kind", ["simple_unet", "nested_unet_resnet50"])
def test_reference_pth_loads_in_both_packages(kind, tmp_path, x):
    """A reference `.pth` (tests/torch_ref.py's TSimpleUNet or
    TNestedUNetResNet50, in a {model, epoch} container) loads strictly into
    the port through `cli.load_model`, which reads its family from its keys,
    and into the JAX package through `convert_checkpoint`: equal logits
    within the family's gate."""
    g = torch.Generator().manual_seed(4)
    ref = TSimpleUNet(num_classes=7) if kind == "simple_unet" else TNestedUNetResNet50(3)
    _randomize_bn(ref, g)
    path = tmp_path / "ref.pth"
    torch.save({"model": ref.state_dict(), "epoch": 3}, path)
    model, k, arch = load_model(str(path), "nested_unet", "float32", 3)
    assert (arch, k) == (kind, 7 if kind == "simple_unet" else 3)
    assert all(torch.equal(model.state_dict()[n], t) for n, t in ref.state_dict().items())
    got = zoo.port_logits(model, x)
    want = zoo.jax_logits(kind, jconvert.convert_checkpoint(str(path)), x, k)
    if kind == "simple_unet":   # the reference's own forward runs: the same function
        with torch.inference_mode():
            np.testing.assert_allclose(
                got, ref.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
                .numpy().transpose(0, 2, 3, 1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=zoo.ATOL.get(kind, 1e-3), rtol=1e-3)


def test_resnet50_stages_equal_the_reference_layers():
    """The ResNet50 NestedUNet's conv0_0 ... conv4_0 are the reference's
    stem and torchvision layers: with the reference's weights they compute
    what TNestedUNetResNet50's do."""
    from unet_tpu_torch.models import NestedUNet

    g = torch.Generator().manual_seed(5)
    ref = TNestedUNetResNet50(3).eval()
    _randomize_bn(ref, g)
    port = NestedUNet(3, deep_supervision=False, pretrained_encoder=True).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    xt = torch.randn(1, 3, SIZE, SIZE, generator=g)
    with torch.inference_mode():
        a = b = xt
        for name in ("conv0_0", "conv1_0", "conv2_0", "conv3_0", "conv4_0"):
            a, b = getattr(port, name)(a), getattr(ref, name)(b)
            assert torch.equal(a, b), name


def test_channel_shuffle_matches_jax():
    xs = np.random.default_rng(6).normal(0, 1, (2, 5, 3, 12)).astype(np.float32)
    for groups in (2, 3, 4):
        want = np.asarray(jchannel_shuffle(jnp.asarray(xs), groups))
        got = channel_shuffle(torch.from_numpy(xs.transpose(0, 3, 1, 2).copy()), groups)
        assert np.array_equal(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_hw", [((2, 7, 5, 3), (13, 11)), ((1, 16, 16, 4), (64, 64)),
                                          ((1, 9, 6, 2), (4, 3)), ((1, 1, 5, 2), (3, 1))])
def test_resize_bilinear_align_corners_bit_identical(shape, out_hw, dtype):
    """Up, down, from and to a single row, in float32 and bf16: bit for bit
    the JAX function (its bf16 rounds every operation, as the port does)."""
    xs = np.random.default_rng(7).normal(0, 3, shape).astype(np.float32)
    jx = jnp.asarray(xs).astype(getattr(jnp, dtype))
    want = np.asarray(jresize_ac(jx, out_hw, 1, 2).astype(jnp.float32))
    tx = torch.from_numpy(xs).to(getattr(torch, dtype))
    got = resize_bilinear_align_corners(tx, out_hw, 1, 2)
    assert got.dtype == tx.dtype and tuple(got.shape[1:3]) == out_hw
    assert np.array_equal(got.float().numpy(), want)
