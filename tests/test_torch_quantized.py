"""The port's int8 forward (unet_tpu_torch.models.quantized, with the plain
version of the qconv kernel on the CPU) against the JAX package's
(unet_tpu/models/quantized.py). The JAX side runs jitted, as its pipeline
runs it: XLA turns a division by a compile-time constant into a
multiplication by its float32 reciprocal, and the port computes that form.

Bit for bit: the int32 accumulator of `_qconv` (single and pair forms),
`_requant` (bf16 and float32), `_up_int8`, `_maxpool2_int8`, and, with the
JAX package's own QParams carried across (`qparams_from_jax`), all 19 int8
tensors of the forward. Within tolerances: the weight preparation, the
calibration, the logits, and the two_stage step with calibrated scales."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import synthetic_frames
from tests.test_torch_fast_forward import _spread_classes, randomised_variables
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.models import quantized as jq
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models import quantized as tq
from unet_tpu_torch import _build
from unet_tpu_torch.models.convert import qparams_from_jax, state_dict_from_flax
from unet_tpu_torch.ops import qconv_kernels
from unet_tpu_torch.ops.image import recip32
from unet_tpu_torch.pipeline import presets, stages

_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.fixture(scope="module")
def shared():
    """(flax variables, port state dict, (2, 64, 64, 3) input, JAX scales)."""
    variables = randomised_variables()
    tm = NestedUNet(num_classes=3, deep_supervision=False)
    tm.load_state_dict(state_dict_from_flax(variables))
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    scales = jq.calibrate(variables, [x[:1], x[1:]])
    return variables, tm.state_dict(), x, scales


def _arrays(qp):
    return {n: tuple((l.wq, l.s_w, l.b) for l in pair) for n, pair in qp.blocks.items()}


def _jax_taps(qp, x):
    """The JAX package's int8 forward (unpacked), jitted with the scales as
    constants, recording every int8 tensor; and its logits."""
    sc = qp.scales

    def fwd(arrays, x):
        q = qp._replace(blocks={n: tuple(jq.QLayer(*a, packed=False) for a in pair)
                                for n, pair in arrays.items()})
        taps = {"input": jnp.clip(jnp.round(x.astype(jnp.float32) / sc["input"]),
                                  -127, 127).astype(jnp.int8)}

        def block(name, t, keep_packed=False):
            l1, l2 = q.blocks[name]
            y = jq._requant(jq._qconv(t, l1), l1, sc[f"{name}.relu1"], q.dtype)
            taps[f"{name}.relu1"] = y
            y = jq._requant(jq._qconv(y, l2), l2, sc[f"{name}.relu2"], q.dtype)
            taps[f"{name}.relu2"] = y
            return y

        jq._run_topology(q, taps["input"], block)
        return taps, jq.nested_unet_forward_int8(q, x)

    taps, logits = jax.jit(fwd)(_arrays(qp), jnp.asarray(x))
    return {k: np.asarray(v) for k, v in taps.items()}, np.asarray(logits.astype(jnp.float32))


@pytest.mark.parametrize("packed_shape", [False, True])
def test_qconv_acc_bit_exact_single_and_pair(packed_shape):
    """Mirror of tests/test_quantized.py::test_pair_conv_bit_exact: the
    port's int32 accumulator equals JAX's `_qconv` (an unpacked layer) in
    the single and the pair form, and the pair form equals the concat."""
    rng = np.random.default_rng(0)
    hw = (16, 16) if not packed_shape else (9, 13)
    a = rng.integers(-127, 128, (2,) + hw + (8,)).astype(np.int8)
    b = rng.integers(0, 128, (2,) + hw + (24,)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, 32, 16)).astype(np.int8)
    l = jq.QLayer(wq=jnp.asarray(wq), s_w=jnp.ones((16,)), b=jnp.zeros((16,)), packed=False)
    want_pair = np.asarray(jq._qconv((jnp.asarray(a), jnp.asarray(b)), l))
    want_cat = np.asarray(jq._qconv(jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], -1), l))
    w_ohwi = torch.from_numpy(wq.transpose(3, 0, 1, 2).copy())
    pair = (torch.from_numpy(a), torch.from_numpy(b))
    got_pair = qconv_kernels.conv_acc_plain(pair, w_ohwi)
    got_cat = qconv_kernels.conv_acc_plain(torch.cat(pair, -1), w_ohwi)
    assert got_pair.dtype == torch.int32
    np.testing.assert_array_equal(got_pair.numpy(), want_pair)
    np.testing.assert_array_equal(got_cat.numpy(), want_cat)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_requant_bit_identical(dtype):
    """262,144 int32 accumulators up to 2**28 (|acc| past 2**24, where the
    int32 -> bf16 cast rounds), through JAX's jitted `_requant` and the
    port's epilogue: the same int8 codes."""
    rng = np.random.default_rng(1)
    n = 64
    acc = rng.integers(-2 ** 28, 2 ** 28, (4096, n)).astype(np.int32)
    acc[:2048] //= 1024                            # and small ones
    s_w = (rng.uniform(0.5, 2.0, n) * 2e-5).astype(np.float32)
    b = rng.normal(0, 0.5, n).astype(np.float32)
    out_scale = 0.0173
    fn = jax.jit(lambda a, sw, bb: jq._requant(a, jq.QLayer(None, sw, bb, False), out_scale,
                                               _JDT[dtype]))
    want = np.asarray(fn(jnp.asarray(acc), jnp.asarray(s_w), jnp.asarray(b)))
    mult, bias = tq._epilogue(torch.from_numpy(s_w), torch.from_numpy(b), out_scale, dtype)
    got = qconv_kernels.requant_plain(torch.from_numpy(acc), mult, bias)
    assert 0.05 < (want == 0).mean() < 0.95 and (want == 127).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale", [0.0123456789, 1 / 127.0, 0.0031])
def test_division_by_a_constant_is_a_reciprocal_product(scale):
    """Inside jit, XLA computes x / c for a constant c as x * (1 / c), the
    reciprocal in float32; the port's `quantize_input` does the same, and
    true division would differ in the last bit on part of the inputs (the
    share is printed)."""
    x = np.random.default_rng(3).random(200_000).astype(np.float32)
    jitted = np.asarray(jax.jit(lambda t: t / scale)(jnp.asarray(x)))
    np.testing.assert_array_equal(x * np.float32(recip32(scale)), jitted)
    codes = np.asarray(jax.jit(lambda t: jnp.clip(jnp.round(t / scale), -127, 127)
                               .astype(jnp.int8))(jnp.asarray(x[:, None])))
    np.testing.assert_array_equal(tq.quantize_input(torch.from_numpy(x[:, None]), scale).numpy(),
                                  codes)
    share = (x / np.float32(scale) != jitted).mean()
    print(f"x / {scale}: true division differs from XLA's on {share:.4f} of the inputs")
    assert share > 0 or scale == 1 / 127.0


@pytest.mark.parametrize("n", [1, 2, 8, 32])
def test_up_int8_bit_identical(n):
    codes = np.random.default_rng(n).integers(0, 128, (2, n, n + 1, 16)).astype(np.int8)
    want = np.asarray(jq._up_int8(jnp.asarray(codes), 0.0, jnp.bfloat16))
    got = tq._up_int8(torch.from_numpy(codes), torch.bfloat16)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(8, 8), (9, 7)])
def test_maxpool2_int8_bit_identical(hw):
    codes = np.random.default_rng(2).integers(-128, 128, (2,) + hw + (5,)).astype(np.int8)
    want = np.asarray(jq._maxpool2_int8(jnp.asarray(codes)))
    got = tq._maxpool2_int8(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


def test_calibrate_matches_jax(shared):
    variables, sd, x, scales = shared
    got = tq.calibrate(sd, [torch.from_numpy(x[:1]), torch.from_numpy(x[1:])])
    assert [k for k, _ in got] == [k for k, _ in scales] == sorted(tq.TAP_NAMES)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in scales], rtol=1e-5)


def test_prepare_int8_params_matches_jax(shared):
    """Against JAX's jitted `prepare_int8_params(pack_max_cout=0)`: s_w and
    b within rtol 1e-6 (atol 1e-7 for b near 0), the int8 weights equal but
    for codes that sit on a rounding tie. XLA's rsqrt (the BN fold) and
    PyTorch's differ in the last bit on about 30 % of inputs, which flips a
    weight whose scaled value lies within an ulp of .5: 3 of the 7.8 M
    weights here, each by one code."""
    variables, sd, x, scales = shared
    jp = jax.jit(lambda v: _arrays(jq.prepare_int8_params(v, scales, pack_max_cout=0)))(variables)
    tp = tq.prepare_int8_params(sd, scales)
    flips, total = 0, 0
    for name in tq.BLOCK_NAMES:
        for (wq, s_w, b), l in zip(jp[name], tp.blocks[name]):
            want_wq = np.asarray(wq).transpose(3, 0, 1, 2)
            flips += int((l.wq.numpy() != want_wq).sum())
            total += want_wq.size
            assert np.abs(l.wq.numpy().astype(int) - want_wq).max() <= 1
            np.testing.assert_allclose(l.s_w.numpy(), np.asarray(s_w), rtol=1e-6)
            np.testing.assert_allclose(l.b.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    print(f"int8 weights: {flips} of {total} codes differ from the JAX package's")
    assert flips <= 10
    # the one-call forms, each preparing its own weights (JAX's packed)
    want = np.asarray(jax.jit(lambda v, t: jq.int8_apply(v, t, scales))(variables, x))
    with torch.inference_mode():
        got = tq.int8_apply(sd, torch.from_numpy(x), scales)
    assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() > 0.999


def test_int8_forward_taps_bit_identical_with_carried_qparams(shared):
    """The JAX package's QParams carried across: every one of the 19 int8
    tensors equals the JAX forward's, and the bf16 logits agree within two
    bf16 ulps of their range (the 1x1 head sums 32 bf16 products in another
    order: oneDNN against XLA)."""
    variables, sd, x, scales = shared
    qp = jq.prepare_int8_params(variables, scales, pack_max_cout=0)
    want_taps, want = _jax_taps(qp, x)
    tqp = qparams_from_jax(jax.tree.map(np.asarray, qp))
    taps = {}
    with torch.inference_mode():
        got = tq.nested_unet_forward_int8(tqp, torch.from_numpy(x), taps)
    assert sorted(taps) == sorted(want_taps) == sorted(tq.TAP_NAMES)
    for name in tq.TAP_NAMES:
        np.testing.assert_array_equal(taps[name].numpy(), want_taps[name], err_msg=name)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64, 64, 3)
    diff = np.abs(got.float().numpy() - want).max()
    print(f"int8 logits vs JAX: max abs diff {diff:.3e} (range {np.abs(want).max():.3f})")
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * 2 ** -8 * np.abs(want).max())
    assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() > 0.999


def test_qparams_from_jax_refuses_packed_layers(shared):
    variables, _, _, scales = shared
    qp = jax.tree.map(np.asarray, jq.prepare_int8_params(variables, scales))
    with pytest.raises(ValueError, match="pack_max_cout=0"):
        qparams_from_jax(qp)


def test_two_stage_int8_step_matches_jax():
    """calibrate_int8 and the int8 two_stage step, the port's against JAX's
    (jitted, phase-packed, which gives the same accumulators) with the same
    bf16 model at model size 64^2: the scales within rtol 1e-5, the class
    maps on > 0.999 of the pixels and the px counts within 0.5 % of the
    frame (the port prepares its own weights: a few codes flip at rounding
    ties, and the head sums in another order)."""
    frames = synthetic_frames(2, 224, 400, seed=5, patch=14)
    jcfg = jpresets.two_stage().replace_in("preprocess", model_size=(64, 64))
    jm = JNestedUNet(num_classes=3, deep_supervision=True, dtype=jnp.bfloat16)
    variables = _spread_classes(randomised_variables(), frames, jcfg, jm)
    jqcfg = jstages.calibrate_int8(jm, variables, jcfg, [frames])
    want = jstages.build_step(jm, jqcfg)(variables, jnp.asarray(frames))

    tm = NestedUNet(num_classes=3, deep_supervision=False, dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_flax(variables))
    cfg = presets.two_stage().replace_in("preprocess", model_size=(64, 64))
    qcfg = stages.calibrate_int8(tm, cfg, [frames], device="cpu")
    np.testing.assert_allclose([v for _, v in qcfg.segment.int8_scales],
                               [v for _, v in jqcfg.segment.int8_scales], rtol=1e-5)
    got = stages.build_step(tm, qcfg, device="cpu")(frames)
    agree = (got.class_map.numpy() == np.asarray(want.class_map)).mean()
    print(f"two_stage int8 step vs JAX: class maps {agree:.6f}, cable_px "
          f"{got.cable_px.tolist()} vs {np.asarray(want.cable_px).tolist()}, burr_px "
          f"{got.burr_px.tolist()} vs {np.asarray(want.burr_px).tolist()}")
    assert np.asarray(want.cable_px).min() > 0
    assert agree > 0.999
    for name in ("cable_px", "tape_px", "burr_px"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=0.005 * 224 * 400)
    assert stages.validate_int8(tm, cfg, qcfg, frames, device="cpu") > 0.995


# The int8 forward's 18 convs: (Ca, Cb, N) of each (Cb > 0 for a decoder
# pair) and the route `qconv_kernels.route` gives it on the card at the
# 512^2 model input (level i of the UNet is 512 >> i wide).
MAIN_PATH_CONVS = {
    "conv0_0.conv1": ((3, 0, 32), ("c3", 32)),
    "conv0_0.conv2": ((32, 0, 32), ("wgmma", 32)),
    "conv1_0.conv1": ((32, 0, 64), ("wgmma", 64)),
    "conv1_0.conv2": ((64, 0, 64), ("wgmma", 64)),
    "conv2_0.conv1": ((64, 0, 128), ("wgmma", 128)),
    "conv2_0.conv2": ((128, 0, 128), ("wgmma", 128)),
    "conv3_0.conv1": ((128, 0, 256), ("wgmma", 128)),
    "conv3_0.conv2": ((256, 0, 256), ("wgmma", 128)),
    "conv4_0.conv1": ((256, 0, 512), ("wgmma", 128)),
    "conv4_0.conv2": ((512, 0, 512), ("wgmma", 128)),
    "conv3_1.conv1": ((256, 512, 256), ("wgmma", 128)),
    "conv3_1.conv2": ((256, 0, 256), ("wgmma", 128)),
    "conv2_2.conv1": ((128, 256, 128), ("wgmma", 128)),
    "conv2_2.conv2": ((128, 0, 128), ("wgmma", 128)),
    "conv1_3.conv1": ((64, 128, 64), ("wgmma", 64)),
    "conv1_3.conv2": ((64, 0, 64), ("wgmma", 64)),
    "conv0_4.conv1": ((32, 64, 32), ("wgmma", 32)),
    "conv0_4.conv2": ((32, 0, 32), ("wgmma", 32)),
}


@pytest.mark.parametrize("site", sorted(MAIN_PATH_CONVS))
def test_qconv_route_of_each_main_path_conv(site):
    """17 convs take the wgmma kernel at BN = min(N, 128), conv0_0.conv1
    (Cin 3) the c3 kernel; a misaligned buffer sends any of them to the
    sync kernel, never to a plain version."""
    (ca, cb, n), want = MAIN_PATH_CONVS[site]
    width = 512 >> int(site[4])
    assert qconv_kernels.route(ca, cb, n, aligned=True, width=width) == want
    assert qconv_kernels.route(ca, cb, n, aligned=False, width=width) == ("sync", want[1])
    if want[0] == "wgmma":
        assert want[1] == min(n, 128)


@pytest.mark.parametrize("ca,cb,n,width,want", [
    (3, 0, 32, 512, ("c3", 32)), (5, 0, 10, 512, ("sync", 32)), (12, 25, 33, 512, ("sync", 32)),
    (48, 0, 64, 512, ("sync", 64)), (32, 16, 128, 512, ("sync", 128)),
    (16, 32, 32, 512, ("sync", 32)), (32, 0, 48, 512, ("sync", 32)),
    (64, 0, 40, 512, ("sync", 32)), (64, 0, 8, 512, ("sync", 32)),
    (32, 0, 96, 512, ("wgmma", 32)), (96, 0, 192, 512, ("wgmma", 64)),
    (768, 0, 384, 512, ("wgmma", 128)), (32, 64, 1024, 512, ("wgmma", 128)),
    # Cin 3: rows that end inside a 16-byte chunk, a pair, N not a multiple
    # of 32 take the sync kernel; N = 64 takes the c3 kernel in two blocks
    (3, 0, 32, 15, ("sync", 32)), (3, 0, 32, 20, ("sync", 32)), (3, 5, 32, 512, ("sync", 32)),
    (3, 0, 40, 512, ("sync", 32)), (3, 0, 64, 512, ("c3", 32)), (3, 0, 64, 16, ("c3", 32)),
    (3, 0, 96, 48, ("c3", 32))])
def test_qconv_route_of_ragged_and_misaligned_shapes(ca, cb, n, width, want):
    """A channel count or an N that is not a multiple of 32 takes the sync
    kernel (with its tile rule: 128, 64, else 32), as does a Cin-3 plane
    whose rows are not whole 16-byte chunks; a misaligned buffer takes the
    sync kernel at any shape; every route is a kernel."""
    assert qconv_kernels.route(ca, cb, n, aligned=True, width=width) == want
    assert qconv_kernels.route(ca, cb, n, aligned=False, width=width)[0] == "sync"


def _c3_constants():
    """(kRows, kCols, kBN) of the c3 kernel, read from csrc/qconv.cu, so
    that the model below follows the kernel's tiling as it stands."""
    src = (_build.CSRC / "qconv.cu").read_text()
    body = src[src.index("namespace c3 {"):]
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", body).group(1))
                 for k in ("kRows", "kCols", "kBN"))


def _c3_kernel_model(x: np.ndarray, wq: np.ndarray, mult: torch.Tensor, bias: torch.Tensor):
    """numpy model of `qconv_c3_kernel`'s addressing, block by block: the
    halo tile staged in 16-byte chunks of the flat NHWC buffer (a chunk
    outside the image's rows or its row's bytes zero-filled), each pixel's
    K row read from the halo at byte 13 + 3 x + (k // 9) * pitch + k % 9,
    the block's weights from one run of 27 * kBN bytes, the int32 product,
    the plain requant, and the store of the tile's pixels inside the plane.
    Returns the output and how many times each output byte was written."""
    rows, cols, bn = _c3_constants()
    B, H, W, _ = x.shape
    N = wq.shape[0]
    chunks = 3 * cols // 16 + 2
    pitch = 16 * chunks
    flat, wflat = x.reshape(-1), wq.reshape(-1)
    out = np.zeros(B * H * W * N, np.int8)
    writes = np.zeros(B * H * W * N, np.int64)
    tiles_x, tiles_y = -(-W // cols), -(-H // rows)
    p = np.arange(rows * cols)
    k = np.arange(27)
    for blk in range(B * tiles_y * tiles_x):
        tx, rest = blk % tiles_x, blk // tiles_x
        ty, b = rest % tiles_y, rest // tiles_y
        x0, y0 = tx * cols, ty * rows
        halo = np.zeros((rows + 2) * pitch, np.int8)
        for hr in range(rows + 2):
            for j in range(chunks):
                y, bx = y0 - 1 + hr, 3 * x0 - 16 + 16 * j
                if 0 <= y < H and 0 <= bx < 3 * W:
                    at = (b * H + y) * 3 * W + bx
                    assert at % 16 == 0 and bx + 16 <= 3 * W
                    halo[hr * pitch + 16 * j:hr * pitch + 16 * j + 16] = flat[at:at + 16]
        src = (p[:, None] // cols) * pitch + 13 + 3 * (p[:, None] % cols)
        a = np.zeros((rows * cols, 32), np.int64)
        a[:, :27] = halo[src + (k // 9) * pitch + k % 9]
        py, px = y0 + p // cols, x0 + p % cols
        inside = (py < H) & (px < W)
        for n0 in range(0, N, bn):
            wb = np.zeros((bn, 32), np.int64)
            wb[:, :27] = wflat[n0 * 27:(n0 + bn) * 27].reshape(bn, 27)
            acc = torch.from_numpy((a @ wb.T).astype(np.int32))
            q = qconv_kernels.requant_plain(acc, mult[n0:n0 + bn], bias[n0:n0 + bn]).numpy()
            at = ((b * H + py[inside]) * W + px[inside]) * N + n0
            idx = at[:, None] + np.arange(bn)
            out[idx] = q[inside]
            writes[idx] += 1
    return out.reshape(B, H, W, N), writes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,n", [
    ((3, 6, 64), 32),     # three images: the halo at every image border
    ((1, 33, 48), 32),    # a ragged last row tile, a partial column tile
    ((2, 5, 80), 64),     # two column tiles, the second partial; two N blocks
    ((1, 4, 16), 96),     # a plane narrower than a tile, three N blocks
])
def test_qconv_c3_kernel_model_matches_plain(shape, n, dtype):
    """The c3 kernel's tiling and addressing, modelled in numpy, gives
    `qconv_plain`'s output bit for bit and writes every output byte once,
    on shapes that the route sends to it (signed codes)."""
    assert qconv_kernels.route(3, 0, n, aligned=True, width=shape[2]) == ("c3", 32)
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 128, shape + (3,)).astype(np.int8)
    wq = rng.integers(-127, 128, (n, 3, 3, 3)).astype(np.int8)
    spread = np.sqrt(27) * 5340 / 40
    mult = torch.from_numpy((rng.uniform(0.5, 2.0, n) / spread).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.uniform(-20, 80, n).astype(np.float32)).to(dtype)
    got, writes = _c3_kernel_model(x, wq, mult, bias)
    want = qconv_kernels.qconv_plain(torch.from_numpy(x), torch.from_numpy(wq), mult, bias)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy())
    assert 0 < want.float().mean() and int(want.max()) == 127


def test_main_path_conv_shapes_are_the_routed_table(shared, monkeypatch):
    """The int8 forward's 18 qconv calls, in order, have the (Ca, Cb, N) of
    MAIN_PATH_CONVS: the table the route test holds is the model's."""
    _, sd, x, _ = shared
    xt = torch.from_numpy(x[:1, :32, :32])
    seen = []
    real = qconv_kernels.qconv

    def spy(t, wq, mult, bias):
        srcs = t if isinstance(t, tuple) else (t,)
        seen.append((srcs[0].shape[-1], srcs[1].shape[-1] if len(srcs) == 2 else 0, wq.shape[0]))
        return real(t, wq, mult, bias)

    qp = tq.prepare_int8_params(sd, tq.calibrate(sd, [xt]))
    monkeypatch.setattr(qconv_kernels, "qconv", spy)
    with torch.inference_mode():
        tq.nested_unet_forward_int8(qp, xt)
    names = [f"{b}.conv{i}" for b in tq.BLOCK_NAMES for i in (1, 2)]
    assert dict(zip(names, seen)) == {k: v[0] for k, v in MAIN_PATH_CONVS.items()}
    assert len(seen) == 18
