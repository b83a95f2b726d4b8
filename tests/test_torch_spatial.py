"""The spatial axis of the port's mesh (unet_tpu_torch.parallel.spatial,
ROADMAP A15c) on gloo ranks on the CPU: each world (2 and 4 ranks) is
spawned once (`tests/torch_dist.spatial_ranks`) and runs every case:
  * the transport (halo, exchange, fetch_rows, both re-splits,
    gather_frames) against slicing the whole tensor, at 2 and 4 stripes,
    also where the last stripe is shorter and where a rank holds no frame
  * the striped fp32, bf16 and int8 NestedUNet forwards (narrow filters:
    32^2 over 2 stripes, 64^2 over 4) bit for bit against the unsharded
    port forwards, every int8 tensor too; the fp32 logits within
    tests/test_models_parity.py's gate of the JAX NestedUNet with the same
    weights
  * the counterpart of tests/test_parallel.py's
    test_spatial_sharded_pipeline_matches_single_device: the reduced
    high_res_roi on (4, 256, 192, 3) frames over 2 data x 2 spatial, class
    maps and px counts equal to the port's build_step and the JAX
    package's, diameters within 1e-5
  * every preset of presets.PRESETS in fp32 (model 32^2, narrow filters)
    over 1 x 2, and two_stage in bf16 and int8, against the unsharded port
    step: integer fields bit for bit, float fields within 1e-4
  * the eval step's confusion matrix over 1 x 2 and 2 x 2 against one
    device
  * the refusals: a model input that leaves a rank under 16 rows, the
    spatial train step (A15d) and the model zoo (A15e)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_frames
from tests import torch_dist as td
from tests import torch_zoo as zoo
from tests.test_torch_presets import _small_post
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu.models import unetpp as junetpp
from unet_tpu.pipeline import get_preset as jget_preset
from unet_tpu.pipeline import stages as jstages
from unet_tpu.pipeline.config import ROI as JROI
from unet_tpu.pipeline.config import PreprocessCfg as JPreprocessCfg
from unet_tpu_torch import parallel
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models import unetpp
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.parallel import spatial as sp
from unet_tpu_torch.pipeline import presets, stages
from unet_tpu_torch.pipeline.config import ROI, PreprocessCfg
from unet_tpu_torch.train.loop import TrainRunCfg, train_model

PRESET_HW = (96, 128)
INT_KINDS = "iub"


def _narrow_variables(monkeypatch, size: int, seed: int):
    """The JAX NestedUNet's variables at td.NARROW widths (both packages'
    filter constant patched while the model is traced), numpy-seeded."""
    monkeypatch.setattr(junetpp, "NB_FILTER", td.NARROW)
    return zoo.jax_variables("nested_unet", 3, size=size, seed=seed)


def _jax_logits(variables, x: np.ndarray) -> np.ndarray:
    """The JAX NestedUNet's eval logits of NHWC `x`, as NCHW."""
    out = zoo.jax_model("nested_unet", 3).apply(variables, jnp.asarray(x), train=False)
    return np.asarray(out).transpose(0, 3, 1, 2)


def _high_res_cfgs():
    """tests/test_parallel.py's reduced high_res_roi in both packages."""
    jcfg = jget_preset("high_res_roi").replace(
        preprocess=JPreprocessCfg(rotate90_ccw=True, normalize_wh=(96, 64), model_size=(32, 32)),
        roi=JROI(30, 0, 66, 64, space=(96, 64)))
    cfg = presets.high_res_roi().replace(
        preprocess=PreprocessCfg(rotate90_ccw=True, normalize_wh=(96, 64), model_size=(32, 32)),
        roi=ROI(30, 0, 66, 64, space=(96, 64)))
    return jcfg, cfg


def _preset_cfg(name: str):
    cfg = presets.get_preset(name).replace_in("preprocess", model_size=(32, 32))
    if cfg.postprocess.enabled and cfg.postprocess.mode in ("spatial", "refine"):
        cfg = cfg.replace(postprocess=_small_post(presets, cfg.postprocess.mode))
    return cfg


def _balanced(num_classes: int, cfg, frames, dtype=torch.float32) -> dict:
    """(kwargs of td.nested_unet) a seeded narrow NestedUNet whose head's
    bias is moved by the median of each class's logits on `frames` and
    scaled, so that more than one class wins: a seeded net's logits barely
    vary over the frame."""
    m = td.nested_unet(num_classes, seed=1)
    x = stages.model_input(stages.preprocess_frames(torch.from_numpy(frames), cfg), cfg)
    with torch.no_grad():
        logits = m(x.permute(0, 3, 1, 2).contiguous())
        m.final.bias.sub_(logits.transpose(0, 1).reshape(num_classes, -1).median(dim=1).values)
        m.final.weight.mul_(8.0)
        m.final.bias.mul_(8.0)
    return dict(num_classes=num_classes, state=m.state_dict(), dtype=dtype)


def _preset_runs():
    """(model kwargs, cfg, frames, prev) of every preset in fp32 (3 frames:
    2 on spatial rank 0, 1 on rank 1; enhanced's non-local means on 2),
    two_stage on one frame (rank 1 holds none), and two_stage in bf16 and
    int8."""
    frames = synthetic_frames(3, *PRESET_HW, seed=5, patch=10)
    prev = synthetic_frames(1, *PRESET_HW, seed=6, patch=10)
    runs = {}
    for name in presets.PRESETS:
        cfg = _preset_cfg(name)
        f, p = frames, prev
        if name == "enhanced":   # its 800x448 working resolution cut to 128x96
            cfg = cfg.replace_in("preprocess", normalize_wh=(PRESET_HW[1], PRESET_HW[0]))
            f, p = frames[:2], prev
        runs[name] = (_balanced(cfg.segment.num_classes, cfg, f), cfg, f, p)
    two = _preset_cfg("two_stage")
    kw = runs["two_stage"][0]
    runs["two_stage b=1"] = (kw, two, frames[:1], None)
    kw16 = dict(kw, dtype=torch.bfloat16)
    runs["two_stage bf16"] = (kw16, two.replace_in("segment", fast_forward=True), frames, None)
    qcfg = stages.calibrate_int8(td.nested_unet(**kw16), two, [frames], device="cpu")
    runs["two_stage int8"] = (kw16, qcfg, frames, None)
    return runs


def _eval_batch(b: int, seed: int):
    r = np.random.default_rng(seed)
    return (r.random((b, 32, 32, 3), dtype=np.float32),
            r.integers(0, 4, (b, 32, 32)).astype(np.int64))  # label 3: dropped as padding


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every 2-rank case: transport at 2 stripes, the forwards at 32^2, every
    preset and two_stage bf16 / int8 over 1 x 2, the eval step."""
    mp = pytest.MonkeyPatch()
    try:
        variables = _narrow_variables(mp, 32, seed=2)
        state = state_dict_from_flax(variables, "nested_unet")
        x = np.random.default_rng(32).random((2, 32, 32, 3), dtype=np.float32)
        jax_logits = _jax_logits(variables, x)
    finally:
        mp.undo()
    runs = _preset_runs()
    images, labels = _eval_batch(2, seed=8)
    tmp = tmp_path_factory.mktemp("spatial2")
    torch.save({"transport": [2], "forward": [(2, state, 32)],
                "steps": [(1, 2, list(runs.values()))],
                "eval": [(1, 2, dict(seed=3), images, labels)], "refuse": [(2, 16)]},
               tmp / "cases.pt")
    ranks = td.run_ranks(tmp, 2, "spatial_ranks", str(tmp / "cases.pt"))
    return dict(ranks=ranks, state=state, x=x, jax_logits=jax_logits, runs=runs,
                eval=(images, labels))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every 4-rank case: transport at 4 stripes, the forwards at 64^2,
    the reduced high_res_roi over 2 x 2, the eval step over 2 x 2."""
    mp = pytest.MonkeyPatch()
    try:
        variables = _narrow_variables(mp, 64, seed=4)
        state = state_dict_from_flax(variables, "nested_unet")
        x = np.random.default_rng(64).random((2, 64, 64, 3), dtype=np.float32)
        jax_logits = _jax_logits(variables, x)
    finally:
        mp.undo()
    full = zoo.jax_variables("nested_unet", 3, size=32, seed=0)
    frames = (np.random.default_rng(0).random((4, 256, 192, 3)) * 255).astype(np.uint8)
    hr_kw = dict(filters=unetpp.NB_FILTER, state=state_dict_from_flax(full, "nested_unet"))
    images, labels = _eval_batch(4, seed=9)
    tmp = tmp_path_factory.mktemp("spatial4")
    torch.save({"transport": [4], "forward": [(4, state, 64)],
                "steps": [(2, 2, [(hr_kw, _high_res_cfgs()[1], frames, None)])],
                "eval": [(2, 2, dict(seed=3), images, labels)], "refuse": [(4, 32)]},
               tmp / "cases.pt")
    ranks = td.run_ranks(tmp, 4, "spatial_ranks", str(tmp / "cases.pt"))
    return dict(ranks=ranks, state=state, x=x, jax_logits=jax_logits, full=full,
                hr_kw=hr_kw, frames=frames, eval=(images, labels))


def _assert_outputs(got: dict, want: dict, what: str) -> float:
    """Integer fields bit for bit, float fields within 1e-4; returns the
    largest float difference."""
    assert sorted(got) == sorted(want), what
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if w.dtype.kind in INT_KINDS:
            assert np.array_equal(g, w), (what, k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{what} {k}")
            worst = max(worst, float(np.abs(g.astype(np.float64) - w).max(initial=0.0)))
    return worst


def test_stripe_bounds_and_frame_split():
    assert sp.stripe_bounds(64, 2) == ((0, 32), (32, 64))
    assert sp.stripe_bounds(80, 4) == ((0, 32), (32, 48), (48, 64), (64, 80))
    assert sp.stripe_bounds(512, 3) == ((0, 176), (176, 352), (352, 512))
    for h, n in ((48, 4), (40, 2), (0, 1)):
        with pytest.raises(ValueError, match="multiples of 16 model-input rows"):
            sp.stripe_bounds(h, n)
    assert sp.frame_split(5, 2) == ((0, 3), (3, 2))
    assert sp.frame_split(2, 4) == ((0, 1), (1, 1), (2, 0), (2, 0))
    st = sp.Stripes(sp.stripe_bounds(80, 4), 1)
    assert st.down(4).bounds == ((0, 2), (2, 3), (3, 4), (4, 5))
    assert st.at(4) == st.down(2) and st.at(16) == st
    assert sp.up_source_rows(16, 8, 16, margin=0) == (3, 9)   # taps 3.87 .. 7.26


@pytest.mark.parametrize("world", (2, 4))
def test_transport_matches_slicing(world, world2, world4):
    ranks = (world2 if world == 2 else world4)["ranks"]
    for r, res in enumerate(ranks):
        checks = res["transport"][0]
        assert len(checks) >= 60
        bad = sorted(k for k, ok in checks.items() if not ok)
        assert not bad, (world, r, bad)


@pytest.mark.parametrize("world", (2, 4))
def test_striped_forwards_bit_for_bit(world, world2, world4):
    w = world2 if world == 2 else world4
    stripes = []
    for r, res in enumerate(w["ranks"]):
        checks = dict(res["forward"][0])
        stripes.append(checks.pop("fp32_stripe"))
        assert all(checks.values()), (world, r, checks)
    got = torch.cat(stripes, 2).numpy()
    with torch.inference_mode():
        want = td.nested_unet(state=w["state"])(
            torch.from_numpy(w["x"]).permute(0, 3, 1, 2).contiguous())
    assert np.array_equal(got, want.numpy())
    # the gate of tests/test_models_parity.py against the JAX NestedUNet
    np.testing.assert_allclose(got, w["jax_logits"], atol=1e-3, rtol=1e-3)
    print(f"{world} stripes: fp32 logits {np.abs(got - w['jax_logits']).max():.2e} from JAX")


def test_spatial_high_res_roi_matches_build_step_and_jax(world4):
    jcfg, cfg = _high_res_cfgs()
    frames = world4["frames"]
    two = world4["ranks"][0]["steps"][0][0]
    for res in world4["ranks"][1:]:
        _assert_outputs(res["steps"][0][0], two, "rank vs rank 0")
    one = td.leaves_numpy(stages.build_step(td.nested_unet(**world4["hr_kw"]), cfg,
                                            device="cpu")(frames))
    _assert_outputs(two, one, "2 x 2 vs build_step")
    want = jstages.build_step(zoo.jax_model("nested_unet", 3), jcfg)(world4["full"],
                                                                      jnp.asarray(frames))
    for k in ("class_map", "cable_px", "tape_px", "burr_px"):
        assert np.array_equal(two[k], np.asarray(getattr(want, k))), k
    if want.diameters is not None:
        for k, v in want.diameters._asdict().items():
            np.testing.assert_allclose(two[f"diameters.{k}"], np.asarray(v), rtol=1e-5, atol=1e-5)
    assert two["cable_px"].sum() > 0


@pytest.mark.parametrize("name", list(presets.PRESETS) + ["two_stage b=1", "two_stage bf16",
                                                          "two_stage int8"])
def test_presets_on_stripes_match_build_step(name, world2):
    names = list(world2["runs"])
    kw, cfg, frames, prev = world2["runs"][name]
    got = [res["steps"][0][names.index(name)] for res in world2["ranks"]]
    _assert_outputs(got[1], got[0], f"{name}: rank 1 vs rank 0")
    want = td.leaves_numpy(stages.build_step(td.nested_unet(**kw), cfg, device="cpu")(frames,
                                                                                      prev))
    worst = _assert_outputs(got[0], want, f"{name}: 1 x 2 vs build_step")
    print(f"{name}: {len(want)} fields, float fields within {worst:.1e}; class_map "
          f"{np.bincount(want['class_map'].ravel(), minlength=4)[:4].tolist()}")


def test_spatial_eval_step_sums_the_confusion_matrix(world2, world4):
    from unet_tpu_torch.train.trainer import make_eval_step

    for w in (world2, world4):
        images, labels = w["eval"]
        want = make_eval_step(3)(td.nested_unet(seed=3),
                                 torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
                                 torch.from_numpy(labels))
        assert int(want.sum()) == int((labels < 3).sum())
        for res in w["ranks"]:
            assert torch.equal(res["eval"][0], want)


def test_spatial_refusals(world2, world4):
    for w, n in ((world2, 2), (world4, 4)):
        for res in w["ranks"]:
            assert "every rank needs at least 16 rows" in res["refuse"][0], (n, res["refuse"])
    mesh = parallel.make_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="A15d"):
        parallel.shard_train_step(None, mesh, spatial=True)
    with pytest.raises(SystemExit, match="A15d"):
        train_model(NestedUNet(3), None, None, TrainRunCfg(n_spatial=2), device="cpu")
    cfg = presets.two_stage().replace_in("preprocess", model_size=(32, 32))
    for model in (NestedUNet(3, pretrained_encoder=True), zoo.port_model(
            "simple_unet", zoo.jax_variables("simple_unet", 3, size=32))):
        with pytest.raises(NotImplementedError, match="A15e"):
            parallel.shard_pipeline_step(stages.build_step(model, cfg, device="cpu"), mesh,
                                         spatial=True)
    with pytest.raises(TypeError, match="build_step"):
        parallel.shard_pipeline_step(lambda f, p=None: None, mesh, spatial=True)


@pytest.mark.slow
def test_spatial_full_shape_bit_exact(tmp_path):
    """The counterpart of tests/test_parallel.py's
    test_spatial_sharded_full_shape_bit_exact: high_res_roi at its 800x448
    working resolution, a 128^2 full-width NestedUNet, burr off, two
    448x800 frames over 4 spatial ranks (two of them without a frame)."""
    cfg = presets.high_res_roi().replace(
        preprocess=PreprocessCfg(rotate90_ccw=True, normalize_wh=(800, 448),
                                 model_size=(128, 128))).replace_in("burr", method="none")
    frames = (np.random.default_rng(1).random((2, 448, 800, 3)) * 255).astype(np.uint8)
    kw = dict(filters=unetpp.NB_FILTER, seed=7)
    torch.save({"transport": [], "forward": [], "steps": [(1, 4, [(kw, cfg, frames, None)])],
                "eval": [], "refuse": []}, tmp_path / "cases.pt")
    ranks = td.run_ranks(tmp_path, 4, "spatial_ranks", str(tmp_path / "cases.pt"))
    want = td.leaves_numpy(stages.build_step(td.nested_unet(**kw), cfg, device="cpu")(frames))
    for res in ranks:
        _assert_outputs(res["steps"][0][0], want, "1 x 4 vs build_step")


@pytest.mark.slow
def test_chip_smoke_spatial_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.phase_spatial end to end on the CPU at a small size (model
    64^2, 96x160 frames, 128x160 frames for high_res_roi): every run over
    2 and 4 ranks against build_step, bit for bit here (no kernel
    launches: the plain versions)."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rec = chip_smoke.phase_spatial(device="cpu", H=96, W=160, b=4, model_size=64, reps=1,
                                   native=synthetic_frames(2, 128, 160, seed=3))
    assert sorted(rec["runs"]) == sorted(
        ["high_res_roi 1x2", "high_res_roi 1x4", "two_stage 2x2", "two_stage_bf16 2x2",
         "two_stage_int8 2x2", "production 1x2", "enhanced 1x2"])
    for key, r in rec["runs"].items():
        assert r["flips"] == 0 and r["logits_max_abs_diff"] == 0 and r["class_map_diff"] == 0, key
    assert rec["runs"]["two_stage_int8 2x2"]["int8_tensors"] == 19
    assert [row["frames"] for row in rec["runs"]["high_res_roi 1x4"]["per_rank"]] == [1, 1, 0, 0]
