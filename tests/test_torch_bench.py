"""The port's throughput bench (unet_tpu_torch.bench) and the chunked step
it measures (stages.build_chunked_step), on the CPU at small sizes: the
chunked step against K calls of build_step and against the JAX package's
build_chunked_step; the bench's headline against the root bench.py's; its
runners and JSON lines with a 64^2 model (`bench.MODEL_SIZE`), small
operating points (`bench.FIXED_POINTS`, `bench.CONFIG_NAMES`) and short
timings (`bench.N_FRAMES`, `bench.REPEATS`)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
import chip_smoke as cs
from tests import torch_zoo
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch import bench
from unet_tpu_torch.pipeline import presets, stages

H, W = 112, 200
SMALL = (64, 64)
# every key of the root bench.py's JSON line for configs 2-5 and 6
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "median_fps"}
E2E_KEYS = {"metric", "value", "unit", "vs_baseline", "legs_ms_per_frame",
            "pipelined_fps_bound", "batch_latency_ms"}


def _assert_stacked(chunked, per_batch, what):
    """Every tensor of `chunked` (stacked to (K, ...)) equals the K
    `per_batch` outputs' bit for bit, nested tuples field by field; a None
    field is None on both sides (`chip_smoke._leaves` names the tensors)."""
    got = cs._leaves(chunked)
    for k, p in enumerate(per_batch):
        want = cs._leaves(p)
        assert set(want) == set(got), what
        for name, w in want.items():
            assert got[name].shape == (len(per_batch),) + w.shape, f"{what}: {name}"
            assert got[name][k].dtype == w.dtype and torch.equal(got[name][k], w), \
                f"{what}: {name}[{k}]"


def _cfg(dtype, model, frames):
    """fp32: production with the quality statistics and the tracker (every
    nested output); bf16 and int8: two_stage's fast and int8 forwards."""
    if dtype == "fp32":
        return presets.production().replace_in("preprocess", model_size=SMALL).replace_in(
            "inspect", quality_stats=True, track_defects=True)
    cfg = presets.two_stage().replace_in("preprocess", model_size=SMALL).replace_in(
        "segment", fast_forward=True)
    if dtype == "int8":
        cfg = stages.calibrate_int8(model, cfg, [frames[0]], device="cpu")
    return cfg


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_chunked_step_equals_k_steps(dtype):
    """K=3 batches of 2 through one call equal 3 calls of build_step bit for
    bit; the launches of a cuda step would be 3x (the same run_pipeline
    calls). A cuda chunked step without a card raises."""
    model = cs.seeded_nested_unet(dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    frames = cs.synthetic_frames(6, H, W, seed=2, patch=8).reshape(3, 2, H, W, 3)
    cfg = _cfg(dtype, model, frames)
    got = stages.build_chunked_step(model, cfg, device="cpu")(frames)
    step = stages.build_step(model, cfg, device="cpu")
    want = [step(fb) for fb in frames]
    assert got.class_map.shape == (3, 2, H, W)
    _assert_stacked(got, want, dtype)
    if dtype == "fp32":
        assert got.diameters is not None and got.quality is not None
        assert got.defects is not None and got.defect_components is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            stages.build_chunked_step(model, cfg)


def test_chunked_step_matches_jax_two_stage():
    """fp32 two_stage, K=3, b=2, 64^2 NestedUNet: class maps and px counts
    equal the JAX package's build_chunked_step on the same frames, with the
    JAX variables carried across (`models/convert.state_dict_from_flax`).
    The final bias is centred on the port's logits so that all three
    classes occur."""
    frames = cs.synthetic_frames(6, H, W, seed=5, patch=8).reshape(3, 2, H, W, 3)
    variables = torch_zoo.jax_variables("nested_unet", size=64, seed=3)
    cfg = presets.two_stage().replace_in("preprocess", model_size=SMALL)
    x = stages.model_input(stages.geometric_preprocess(
        torch.from_numpy(frames.reshape(6, H, W, 3)), cfg), cfg).permute(0, 3, 1, 2)
    with torch.inference_mode():
        logits = torch_zoo.port_model("nested_unet", variables)(x.contiguous()).numpy()
    variables["params"]["final"]["bias"] = (variables["params"]["final"]["bias"]
                                            - logits.mean(axis=(0, 2, 3))).astype(np.float32)
    jcfg = jpresets.two_stage().replace_in("preprocess", model_size=SMALL)
    want = jstages.build_chunked_step(torch_zoo.jax_model("nested_unet"), jcfg)(
        variables, jnp.asarray(frames))
    got = stages.build_chunked_step(torch_zoo.port_model("nested_unet", variables), cfg,
                                    device="cpu")(frames)
    for name in ("class_map", "cable_px", "tape_px", "burr_px"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.cable_px.min() > 0 and got.tape_px.min() > 0 and got.burr_px.sum() > 0


def test_headline_matches_the_root_bench():
    results = [
        {"mode": "chunked", "batch": 96, "dtype": "int8", "fps": 501.25, "median": 490.0},
        {"mode": "chunked", "batch": 128, "dtype": "bf16", "fps": 512.5, "median": 500.0},
        {"mode": "per_batch", "batch": 32, "dtype": "int8", "fps": 431.0, "median": 420.0},
    ]
    for rs in (results, results[:1], results[1:], results[2:]):
        assert bench._headline(rs) == root_bench._headline(rs)
    assert bench.FIXED_POINTS == root_bench.FIXED_POINTS
    assert {k: v[:3] for k, v in bench.CONFIG_NAMES.items()} == {
        k: v[:3] for k, v in root_bench.CONFIG_NAMES.items()}
    rng = np.random.default_rng(7)
    assert np.array_equal(bench._synthetic_frames(rng, 2, 32, 48),
                          root_bench._synthetic_frames(np.random.default_rng(7), 2, 32, 48))


@pytest.fixture
def small(monkeypatch):
    """A 64^2 model and 112x200 frames in every config, small points, each
    timed once over 4 calls."""
    monkeypatch.setattr(bench, "MODEL_SIZE", SMALL)
    monkeypatch.setattr(bench, "N_FRAMES", 1)
    monkeypatch.setattr(bench, "REPEATS", 1)
    monkeypatch.setattr(bench, "CONFIG_NAMES", {
        k: v[:3] + ((H, W),) for k, v in bench.CONFIG_NAMES.items()})
    monkeypatch.setattr(bench, "FIXED_POINTS", {
        2: [("chunked", 1, "int8"), ("per_batch", 1, "bf16")],
        5: [("chunked", 1, "bf16")]})


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_fixed_points_and_multistream_lines(small, capsys):
    """Configs 2 and 5 through main on the CPU: one JSON line each with the
    root bench's keys, the per-dtype extras and the server's frames/s."""
    assert bench.main(["--config", "2", "--device", "cpu"]) == 0
    line = _line(capsys)
    assert LINE_KEYS | {"bf16_fps", "int8_fps", "realtime_per_batch_fps"} <= set(line)
    assert line["unit"] == "frames/sec" and line["value"] > 0 and line["device"] == "cpu"
    assert line["metric"].startswith("two_stage_800x448")
    assert [(p["mode"], p["batch"], p["dtype"]) for p in line["points"]] == \
        bench.FIXED_POINTS[2]
    assert bench.main(["--config", "5", "--device", "cpu"]) == 0
    line = _line(capsys)
    assert LINE_KEYS | {"bf16_fps", "multistream_server_fps(streams=8)"} <= set(line)
    assert line["multistream_server_fps(streams=8)"] > 0


def test_sweep_and_config1_on_the_cpu(small):
    fps, batch, med = bench._pipeline_bench("two_stage", {}, batches=(1, 2),
                                            chunked_only_from=2, frame_hw=(H, W),
                                            int8=True, device="cpu")
    assert fps > 0 and med > 0 and batch in (1, 2)
    line = bench.config1(size=64)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line) and line["value"] > 0


def test_config6_engine_over_an_mp4(small):
    """The end-to-end engine line over a 16-frame mp4 (decode, step,
    overlay, mp4 write) on the CPU."""
    line = bench.config6(device="cpu", n_frames=16, warm_frames=8, batch=4)
    assert E2E_KEYS <= set(line)
    assert line["processed"] == 16 and line["value"] > 0
    assert line["batch_latency_ms"]["batch"] == 4


def test_only_out_of_memory_skips_a_point(small, monkeypatch, capsys):
    """A point that raises torch.OutOfMemoryError is skipped and named on
    stderr and in the line's `skipped`; any other error ends the run."""
    real = bench._throughput

    def tight(step, frames, batch):
        if batch == 4:    # the chunked b=1 point: K=4 frames a call
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(step, frames, batch)

    monkeypatch.setattr(bench, "_throughput", tight)
    assert bench.main(["--config", "2", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["skipped"] == ["point chunked/b1/int8"]
    assert "point chunked/b1/int8 skipped: out of device memory" in captured.err
    assert [p["mode"] for p in line["points"]] == ["per_batch"]

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(bench, "_throughput", broken)
    with pytest.raises(RuntimeError, match="launch"):
        bench.main(["--config", "2", "--device", "cpu"])
