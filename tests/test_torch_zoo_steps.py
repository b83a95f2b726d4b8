"""The zoo's models through the port's `two_stage` step and CLI. The step of
three models -- the ResNet50 NestedUNet and lightweight
mobilenet_v3_small, whose logits are a quarter of the model input's side,
and SimpleUNet -- against the jitted JAX step with the same variables
(carried by `state_dict_from_flax`): full-frame class maps and px counts
equal but on tie pixels of the JAX logits (chip_smoke.compare_with_ties),
which are counted. `cli infer` builds and runs every `--arch` and loads
.pth files of the new families; `--int8` and `--fast on` refuse the other
models. chip_smoke.phase_models rehearsed on the CPU."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests import torch_zoo as zoo
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.cli.main import _build_model, load_model, main
from unet_tpu_torch.pipeline import presets, stages
from tests.torch_threads import one_intra_op_thread  # noqa: F401

H, W, SIZE = 96, 160, 64


def _spread(arch, variables, frames, jcfg):
    """Shift the head's bias so that the random model marks cable and tape
    (as tests/test_torch_fast_forward.py::_spread_classes does)."""
    jm = zoo.jax_model(arch)
    x = jstages.model_input(jstages.geometric_preprocess(jnp.asarray(frames), jcfg), jcfg)
    logits = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    bias = variables["params"]["final"]["bias"]
    variables["params"]["final"]["bias"] = (bias - logits.mean(axis=(0, 1, 2))
                                            + np.array([0.0, 0.1, 0.0], np.float32)
                                            ).astype(np.float32)
    return variables


@pytest.mark.parametrize("arch", ["nested_unet_resnet50", "simple_unet",
                                  "lightweight:mobilenet_v3_small"])
def test_two_stage_step_matches_jitted_jax(arch):
    frames = cs.synthetic_frames(2, H, W, seed=3)
    jcfg = jpresets.two_stage().replace_in("preprocess", model_size=(SIZE, SIZE))
    cfg = presets.two_stage().replace_in("preprocess", model_size=(SIZE, SIZE))
    jm = zoo.jax_model(arch)
    v = _spread(arch, zoo.jax_variables(arch, 3, SIZE, seed=2), frames, jcfg)
    want = jstages.build_step(jm, jcfg)(v, jnp.asarray(frames))
    jlogits = jax.jit(lambda v, f: jm.apply(v, jstages.model_input(
        jstages.geometric_preprocess(f, jcfg), jcfg), train=False))(v, jnp.asarray(frames))
    tap = cs.LogitsTap(zoo.port_model(arch, v))
    got = stages.build_step(tap, cfg, device="cpu")(frames)
    assert got.class_map.shape == (2, H, W)
    assert tuple(tap.logits.shape[-2:]) == (SIZE // 4, SIZE // 4) if arch != "simple_unet" \
        else (SIZE, SIZE)
    counts = cs.compare_with_ties(got, want, tap.logits,
                                  torch.from_numpy(np.array(jlogits)).permute(0, 3, 1, 2), arch)
    print(f"{arch}: {counts}; cable_px {got.cable_px.tolist()}, tape_px {got.tape_px.tolist()}, "
          f"burr_px {got.burr_px.tolist()}")
    assert int(want.cable_px.min()) > 0
    assert counts["flips"] == 0 and counts["class_map_diff"] == 0


def test_chip_smoke_model_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.phase_models on the CPU at 64^2 (plain versions, so zero
    launch counts; the card's timer stubbed) for a quarter-, a full- and a
    half-resolution model: the fp32 step against itself through
    compare_with_ties, the bf16 step against the fp32 one, the records it
    returns."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_time_ms", lambda fn, reps, warmup=1: float(fn() is None) + 1.0)
    zero = dict.fromkeys(("cc_propagate", "cc_propagate_cluster", "cc_propagate_global",
                          "cc_propagate_cluster8", "cc_propagate_cluster16", "nlm", "qconv",
                          "qconv_wgmma", "qconv_sync", "qconv_c3"), 0)
    archs = ("nested_unet_resnet50", "simple_unet", "lightweight:mobilenet_v3_large")
    rec, counts, checks, timings = cs.phase_models(zero, H, W, archs=archs, device="cpu", b=2,
                                                   b_cpu=2, reps=1, model_size=SIZE)
    assert set(checks) == set(timings) == set(archs)
    assert set(counts) == set(archs) | {f"{a}_bf16" for a in archs}
    assert {s.split("/")[1] for s in rec} == {"hysteresis", "cc_filter"} and len(rec) == 6
    side = {"nested_unet_resnet50": 16, "simple_unet": 64, "lightweight:custom": 64,
            "lightweight:mobilenet_v3_large": 32}
    for arch, c in checks.items():
        assert c["logits_max_abs_err"] == 0.0 and c["flips"] == 0 and c["class_map_diff"] == 0
        assert c["logits_hw"] == [side.get(arch, 16)] * 2
        assert c["bf16_agreement"] >= cs.BF16_AGREE
        assert timings[arch]["gflop_per_frame"] > 0


def test_compare_with_ties_bounds_what_may_differ():
    """A flip off the ties fails; a frame without flips must be equal; a
    frame with a flip may differ in its tie footprint and on burr only."""
    logits = torch.zeros(2, 3, 4, 4)
    logits[:, 1] = 1.0
    logits[0, 2, 0, 0] = 1.0005            # a tie at (0, 0) of frame 0
    flipped = logits.clone()
    flipped[0, 2, 0, 0] = 0.9995
    px = dict(cable_px=torch.tensor([64, 64]), tape_px=torch.tensor([0, 0]),
              burr_px=torch.tensor([0, 0]))
    ref = SimpleNamespace(class_map=torch.ones(2, 8, 8, dtype=torch.uint8), **px)
    got = SimpleNamespace(class_map=ref.class_map.clone(), **px)
    got.class_map[0, :2, :2] = 2            # the tie's footprint at 2x
    assert cs.compare_with_ties(got, ref, flipped, logits, "t") == dict(
        tie_pixels=1, flips=1, class_map_diff=4)
    got.class_map[0, 5, 5] = 2
    with pytest.raises(AssertionError, match="off its tie pixels"):
        cs.compare_with_ties(got, ref, flipped, logits, "t")
    got.class_map[0, 5, 5] = 1
    got.class_map[1, 0, 0] = 2
    with pytest.raises(AssertionError, match="frame 1 differs with no argmax flip"):
        cs.compare_with_ties(got, ref, flipped, logits, "t")
    flipped[1, 0, 3, 3] = 5.0
    with pytest.raises(AssertionError, match="off the tie pixels"):
        cs.compare_with_ties(got, ref, flipped, logits, "t")


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    return cs.write_bmp_dir(tmp_path_factory.mktemp("zoo") / "f",
                            cs.synthetic_frames(4, H, W, seed=1))


@pytest.mark.parametrize("arch", cs.MODEL_ARCHS)
def test_cli_infer_runs_every_arch(arch, frames_dir, tmp_path, monkeypatch):
    """`cli infer --arch` in smoke mode for every model the JAX CLI accepts,
    in bf16 (the default; float32 parameters): the engine's events.csv rows
    equal the step's with the engine's own model (chip_smoke.engine_run)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    m = _build_model(3, arch, "bfloat16")
    assert m.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in m.parameters())
    _, rec = cs.engine_run("two_stage_bf16", frames_dir, None,
                           ["--arch", arch, "--preset", "two_stage", "--model-size", "64"],
                           tmp_path / "out", device="cpu", batch=2)
    assert rec["processed"] == 4 and rec["batches"] == 2


def test_cli_loads_the_new_pth_families_and_refuses_fast_routes(frames_dir, tmp_path):
    """A SimpleUNet or ResNet50-NestedUNet .pth sets its own family whatever
    --arch says, loads strictly, keeps its deep-supervision heads; --int8
    and --fast on refuse every model but the custom-encoder NestedUNet, as
    the JAX CLI does."""
    for arch, k in (("simple_unet", 7), ("nested_unet_resnet50", 3)):
        sd = cs.seeded_model(arch, num_classes=k).state_dict()
        torch.save({"model": sd, "epoch": 1}, tmp_path / f"{arch}.pth")
        model, nk, got_arch = load_model(str(tmp_path / f"{arch}.pth"), "nested_unet",
                                         "float32", 3)
        assert (got_arch, nk) == (arch, k)
        assert all(torch.equal(model.state_dict()[n], t) for n, t in sd.items())
    heads = _build_model(3, "nested_unet_resnet50", "float32", deep_supervision=True)
    torch.save(heads.state_dict(), tmp_path / "heads.pth")
    assert load_model(str(tmp_path / "heads.pth"), "x", "float32", 3)[0].deep_supervision
    base = ["infer", "--video", frames_dir, "--output", str(tmp_path / "o"), "--device", "cpu",
            "--model-size", "64"]
    for flags in (["--arch", "simple_unet", "--int8"],
                  ["--arch", "lightweight:resnet18", "--fast", "on"],
                  ["--model", str(tmp_path / "nested_unet_resnet50.pth"), "--int8"]):
        with pytest.raises(SystemExit, match="requires the custom-encoder NestedUNet"):
            main(base + flags)
    with pytest.raises(SystemExit, match="unsupported encoder"):
        main(base + ["--arch", "lightweight:vgg16"])
    with pytest.raises(SystemExit, match="unknown arch"):
        main(base + ["--arch", "unet3d"])
