"""The model zoo on the spatial axis of the port's mesh (its inspection
side) on gloo ranks on the CPU: each world (2 and 4 ranks) is spawned once
(`tests/torch_dist.spatial_ranks`) and runs every case:
  * each of the 8 zoo archs' striped eval forward (the JAX package's
    weights, carried by `state_dict_from_flax`) over 1 x 2 on three stripe
    units of model-input rows (the last stripe shorter; mobilenet_v3_small
    also 80 columns wide, where its decoder takes the general resize), and one arch of
    each unit (8, 16, 32, 64 rows) over 1 x 4 on five, in fp32 and bf16,
    bit for bit against the unsharded port forward; the fp32 logits within
    tests/torch_zoo.py's ATOL of the JAX package's forward
  * `two_stage` through `shard_pipeline_step(spatial=True)` for every arch
    over 1 x 2 and for one arch of each unit over 1 x 4 (model input 64^2,
    or one stripe unit a rank where that is more; b=2, so two of 4 ranks
    hold no frame), in fp32 and bf16, every output field bit for bit with the
    port's `build_step`; for lightweight:mobilenet_v3_small, the inspection
    recipe's default, the class maps and px counts also against the JAX
    package's `build_step` (flips only on tie pixels of the JAX logits,
    counted)
The train and eval steps of the two zoo models whose logits keep the
input's size are tests/test_torch_spatial_zoo_train.py; the six others
raise there as their one-process steps do
(tests/test_torch_spatial.py::test_spatial_refusals).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from chip_smoke import synthetic_frames
from tests import torch_dist as td
from tests import torch_zoo as zoo
from tests.test_torch_spatial import _assert_outputs
from tests.test_torch_zoo_steps import _spread
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.pipeline import presets, stages

# one arch of each stripe unit: 8, 16, 32 and 64 rows
UNIT_ARCHS = ("simple_unet", "lightweight:custom", "lightweight:mobilenet_v3_small",
              "lightweight:shufflenet_v2_x1_0")
STEP_SIZE, STEP_HW = 64, (96, 128)
SPREAD = "lightweight:mobilenet_v3_small"
@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """(JAX variables, the port's state dict) of `arch`, numpy-seeded; the
    inspection recipe's default model's head spread over the classes on the
    step's frames (tests/test_torch_zoo_steps.py::_spread)."""
    v = zoo.jax_variables(arch, 3, size=64, seed=len(arch))
    if arch == SPREAD:
        v = _spread(arch, v, _frames(), _jcfg())
    return v, state_dict_from_flax(v, arch)


def _frames():
    return synthetic_frames(2, *STEP_HW, seed=8)


def _jcfg():
    return jpresets.two_stage().replace_in("preprocess", model_size=(STEP_SIZE, STEP_SIZE))


def _cfg(size=STEP_SIZE):
    return presets.two_stage().replace_in("preprocess", model_size=(size, size))


def _unit(arch: str) -> int:
    """The model's stripe unit (built on the meta device: no weights)."""
    from unet_tpu_torch.cli.main import _build_model

    with torch.device("meta"):
        return _build_model(3, arch, "float32").stripe_unit


def _step_runs(archs, size_of):
    return [(dict(arch=a, state=_weights(a)[1], dtype=dt), _cfg(size_of(a)), _frames(), None)
            for a in archs for dt in ("float32", "bfloat16")]


def _step_size(world: int):
    """The model input of a world's step runs: 64^2, or one stripe unit a
    rank where that is more."""
    return lambda a: max(STEP_SIZE, world * _unit(a))


def _spawn(tmp, world, cases):
    torch.save(dict({"transport": [], "forward": [], "eval": [], "refuse": []}, **cases),
               tmp / "cases.pt")
    return td.run_ranks(tmp, world, "spatial_ranks", str(tmp / "cases.pt"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    # the last case's width, 80, leaves mobilenet_v3_small's deepest stage 3
    # columns wide under a skip of 5: the decoder's general resize
    forward = [(a, _weights(a)[1], 3, i, 64) for i, a in enumerate(zoo.ARCHS)] + [
        (SPREAD, _weights(SPREAD)[1], 3, 20, 80)]
    ranks = _spawn(tmp_path_factory.mktemp("spatial_zoo2"), 2, {
        "zoo_forward": [(2, forward)], "steps": [(1, 2, _step_runs(zoo.ARCHS, _step_size(2)))]})
    return dict(ranks=ranks, forward=forward)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    forward = [(a, _weights(a)[1], 5, 10 + i, 64) for i, a in enumerate(UNIT_ARCHS)]
    ranks = _spawn(tmp_path_factory.mktemp("spatial_zoo4"), 4, {
        "zoo_forward": [(4, forward)], "steps": [(1, 4, _step_runs(UNIT_ARCHS, _step_size(4)))]})
    return dict(ranks=ranks, forward=forward)


def _worlds(world, world2, world4):
    return world2 if world == 2 else world4


@pytest.mark.parametrize("world", (2, 4))
def test_striped_zoo_forwards_bit_for_bit_and_match_jax(world, world2, world4):
    """Every rank's stripe of every arch's eval logits equals the rows of the
    unsharded port forward, fp32 and bf16; the fp32 stripes put together lie
    within the zoo's gate of the JAX package's logits."""
    w = _worlds(world, world2, world4)
    for j, (arch, state, units, seed, width) in enumerate(w["forward"]):
        stripes = []
        for r, res in enumerate(w["ranks"]):
            got = res["zoo_forward"][0][j]
            for dtype, (equal, _, bounds) in got.items():
                assert equal, (world, r, arch, dtype, bounds)
            stripes.append(got["float32"][1])
        logits = torch.cat(stripes, 2).numpy().transpose(0, 2, 3, 1)
        x = td.zoo_input(_unit(arch), units, seed, width).numpy().transpose(0, 2, 3, 1)
        want = zoo.jax_logits(arch, _weights(arch)[0], x)
        assert logits.shape == want.shape, (arch, logits.shape, want.shape)
        np.testing.assert_allclose(logits, want, atol=zoo.ATOL.get(arch, 1e-3), rtol=1e-3,
                                   err_msg=arch)
        print(f"{arch} over 1 x {world} ({units} units of {_unit(arch)} rows, {width} wide): logits "
              f"{logits.shape[1:3]}, fp32 {np.abs(logits - want).max():.2e} from JAX")


@pytest.mark.parametrize("world", (2, 4))
def test_zoo_two_stage_on_stripes_matches_build_step(world, world2, world4):
    """shard_pipeline_step(spatial=True) against build_step for every run:
    the ranks agree, and every output field equals build_step's."""
    w = _worlds(world, world2, world4)
    archs = zoo.ARCHS if world == 2 else UNIT_ARCHS
    runs = _step_runs(archs, _step_size(world))
    for i, (kw, cfg, frames, prev) in enumerate(runs):
        what = f"{kw['arch']} {kw['dtype']} over 1 x {world}"
        got = [res["steps"][0][i] for res in w["ranks"]]
        for g in got[1:]:
            _assert_outputs(g, got[0], f"{what}: rank vs rank 0")
        want = td.leaves_numpy(stages.build_step(td.zoo_net(**kw), cfg, device="cpu")(frames))
        _assert_outputs(got[0], want, f"{what} vs build_step")


def test_inspection_default_on_stripes_matches_jax_build_step(world2):
    """lightweight:mobilenet_v3_small, the inspection recipe's default, over
    1 x 2 against the JAX package's jitted build_step with the same
    variables: class maps and px counts equal but on tie pixels of the JAX
    logits."""
    i = zoo.ARCHS.index(SPREAD) * 2      # its fp32 run
    got = world2["ranks"][0]["steps"][0][i]
    v = _weights(SPREAD)[0]
    jm, jcfg, frames = zoo.jax_model(SPREAD), _jcfg(), _frames()
    want = jstages.build_step(jm, jcfg)(v, jnp.asarray(frames))
    jlogits = jax.jit(lambda v, f: jm.apply(v, jstages.model_input(
        jstages.geometric_preprocess(f, jcfg), jcfg), train=False))(v, jnp.asarray(frames))
    tap = cs.LogitsTap(zoo.port_model(SPREAD, v))
    stages.build_step(tap, _cfg(), device="cpu")(frames)
    from types import SimpleNamespace

    counts = cs.compare_with_ties(SimpleNamespace(**{k: torch.from_numpy(got[k]) for k in (
        "class_map", "cable_px", "tape_px", "burr_px")}), want, tap.logits,
        torch.from_numpy(np.array(jlogits)).permute(0, 3, 1, 2), SPREAD)
    assert int(want.cable_px.min()) > 0
    print(f"{SPREAD} over 1 x 2 vs the JAX package's build_step: {counts}")


def test_cpu_conv_sums_a_slab_in_another_order_at_batch_1():
    """ROADMAP C8: the CPU's 3x3 conv (F.conv2d, oneDNN here) of a (1, 128,
    16, 16) plane, the lightweight decoder's conv2_2.conv2 at a 256^2 input
    (shufflenet), may sum a halo slab's rows in another order than the
    whole plane's, by a few float32 ulps of its outputs: the algorithm it
    picks depends on the batch and the plane's size. At batch 2 the slab's
    rows equal the whole plane's bit for bit (every striped forward of the
    tests above stripes two frames); at batch 1 they are held within 1e-5
    of the largest output, and the difference measured is printed."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    w = torch.randn(128, 128, 3, 3, generator=g) * 0.1
    for b in (2, 1):
        x = torch.randn(b, 128, 16, 16, generator=g)
        whole = F.conv2d(x, w, padding=1)
        slab = F.conv2d(x[:, :, :5].contiguous(), w, padding=1)[:, :, :4]
        diff = float((slab - whole[:, :, :4]).abs().max())
        if b == 2:
            assert torch.equal(slab, whole[:, :, :4])
        else:
            assert diff <= 1e-5 * float(whole.abs().max()), diff
        print(f"(b, 128, 16, 16) 3x3 conv, rows 0-3 from a 5-row slab: batch {b} "
              f"{diff:.3e} from the whole plane's")

