"""The port's InferenceEngine (unet_tpu_torch.pipeline.engine) against the
JAX package's, on the same directory of 12 frames of 128x130 (.bmp, rows
padded to 4 bytes) at model 64x64 on the CPU: events.csv,
wrap_uniformity.csv, detector_events.csv and gated_events.csv byte for byte,
the window events (inspection_events.jsonl, window_info.json) field by
field without timestamps and image paths, and the summary's counts. Also
the numpy .bmp decoder against OpenCV's, and the engine's failure paths."""
import csv
import json
import threading

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from chip_smoke import ColourClassModel, synthetic_frames, wrap_scenes
import unet_tpu.pipeline as jpipeline
import unet_tpu_torch.pipeline as pipeline
from unet_tpu.inspect import EventConfig as JEventConfig
from unet_tpu.io.video import ImageDirReader as JImageDirReader
from unet_tpu.pipeline import EngineConfig as JEngineConfig
from unet_tpu.pipeline import InferenceEngine as JInferenceEngine
from unet_tpu.pipeline import presets as jpresets
from unet_tpu_torch.inspect import EventConfig
from unet_tpu_torch.io.video import ImageDirReader, read_bmp
from unet_tpu_torch.pipeline import EngineConfig, InferenceEngine, presets
from tests.torch_threads import one_intra_op_thread  # noqa: F401

H, W = 128, 130      # 130 * 3 = 390 bytes a row: padded to 392 in the .bmp


class _JColourClassModel:
    """JAX twin of chip_smoke.ColourClassModel (NHWC)."""

    def apply(self, variables, x, train=False):
        cable = (x[..., 0] > 0.6) & (x[..., 2] > 0.6)
        tape = (x[..., 0] > 0.6) & (x[..., 2] < 0.4) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        return jax.nn.one_hot(cls, 3) * 10.0


def holey_tape_mask(s=64):
    """Cable strip + tape band with hole stripes (tests/test_engine_inspect.py)."""
    m = np.zeros((s, s), np.int32)
    m[:, 8:16] = 1
    m[:, 28:60] = 2
    for y in range(0, s, 8):
        m[y + 2:y + 4, 30:58] = 0
    return m


class _Stub(torch.nn.Module):
    """Fixed one-hot logits of `mask`, for every frame (NCHW)."""

    def __init__(self, mask, num_classes):
        super().__init__()
        onehot = torch.nn.functional.one_hot(torch.from_numpy(mask).long(), num_classes)
        self.register_buffer("logits", onehot.permute(2, 0, 1).float() * 10.0)

    def forward(self, x):
        return self.logits.expand(x.shape[0], -1, -1, -1)


class _JStub:
    def __init__(self, mask, num_classes):
        self.logits = jax.nn.one_hot(jnp.asarray(mask), num_classes) * 10.0

    def apply(self, variables, x, train=False):
        return jnp.broadcast_to(self.logits, (x.shape[0],) + self.logits.shape)


def _dir(tmp_path_factory, name, frames):
    d = tmp_path_factory.mktemp(name)
    for i, f in enumerate(frames):
        assert cv2.imwrite(str(d / f"f_{i:03d}.bmp"), f)
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"burr": _dir(tmp_path_factory, "burr", synthetic_frames(12, H, W, seed=0, patch=10)),
            "wrap": _dir(tmp_path_factory, "wrap", wrap_scenes(12, H, W, seed=0))}


def _stub_cfg(mod):
    """Window-mode config of tests/test_engine_inspect.py: no burr stage,
    geometry with defect analysis; `mod` is either package's pipeline."""
    return mod.PipelineCfg(name="stub", preprocess=mod.PreprocessCfg(model_size=(64, 64)),
                           segment=mod.SegmentCfg(num_classes=3),
                           burr=mod.BurrCfg(method="none"),
                           geometry=mod.GeometryCfg(enabled=True, analyze_defects=True))


# name -> (frames, port model, JAX model, port cfg, JAX cfg, engine options)
CASES = {
    # two_stage: the burr stage and B1's plain version on the ROI crop
    "two_stage": ("burr", ColourClassModel, _JColourClassModel,
                  lambda: presets.two_stage().replace_in("preprocess", model_size=(64, 64)),
                  lambda: jpresets.two_stage().replace_in("preprocess", model_size=(64, 64)),
                  {}),
    # the wrap monitor, the event detector and the event gate on diameters
    "wrap_events": ("wrap", ColourClassModel, _JColourClassModel,
                    lambda: presets.wrap_uniformity().replace_in("preprocess",
                                                                 model_size=(64, 64)),
                    lambda: jpresets.wrap_uniformity().replace_in("preprocess",
                                                                  model_size=(64, 64)),
                    dict(wrap_monitor_enabled=True, wrap_window=5, event_detector_enabled=True,
                         event_gate_enabled=True, gate_hold_frames=3, gate_cooldown_sec=0.2)),
    # window mode with NG evidence on a holey tape (tests/test_engine_inspect.py)
    "windows": ("burr", lambda: _Stub(holey_tape_mask(), 3),
                lambda: _JStub(holey_tape_mask(), 3),
                lambda: _stub_cfg(pipeline), lambda: _stub_cfg(jpipeline),
                dict(window_enabled=True, window_min_frames=3, window_max_frames=4,
                     evidence_dirs=True)),
}
COUNTS = ("processed", "burr_frames", "total_windows", "ng_windows", "detector_events",
          "gated_events", "wrap_events")


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_the_jax_engine(dirs, tmp_path, case):
    src, model, jmodel, cfg, jcfg, opts = CASES[case]
    common = dict(batch=4, write_video=False, print_interval=1000, **opts)
    jopts = dict(common)
    if "event_detector_enabled" in opts:
        common["event_cfg"] = EventConfig(thick_wrap_frames=2, cooldown_frames=4)
        jopts["event_cfg"] = JEventConfig(thick_wrap_frames=2, cooldown_frames=4)
    got = InferenceEngine(model(), cfg(), EngineConfig(output_dir=str(tmp_path / "port"),
                                                       **common), device="cpu"
                          ).process_video(dirs[src])
    want = JInferenceEngine(jmodel(), {}, jcfg(), JEngineConfig(
        output_dir=str(tmp_path / "jax"), **jopts)).process_video(dirs[src])
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["processed"] == 12

    port, jax_ = tmp_path / "port", tmp_path / "jax"
    names = {p.name for p in jax_.iterdir() if p.suffix == ".csv"}
    assert names == {p.name for p in port.iterdir() if p.suffix == ".csv"}
    assert "events.csv" in names
    for name in names:   # events, wrap_uniformity, detector_events, gated_events
        assert (port / name).read_bytes() == (jax_ / name).read_bytes(), name
    if case == "two_stage":
        rows = list(csv.DictReader(open(port / "events.csv")))
        assert sum(int(r["burr_px"]) > 0 for r in rows) == got["burr_frames"] > 0
    if case == "wrap_events":
        assert got["detector_events"] > 0 and got["gated_events"] > 0 and got["wrap_events"] > 0
        assert names == {"events.csv", "wrap_uniformity.csv", "detector_events.csv",
                         "gated_events.csv"}
    if case == "windows":
        assert got["total_windows"] == got["ng_windows"] == 3
        strip = lambda r: {k: (sorted(v) if k == "images" else v) for k, v in r.items()
                           if k != "timestamp"}   # image paths hold the wall-clock time
        jl = lambda d: [strip(json.loads(l))
                        for l in open(d / "events" / "inspection_events.jsonl")]
        assert jl(port) == jl(jax_) and len(jl(port)) == 3
        wins = sorted(p.name for p in (jax_ / "windows").iterdir())
        assert sorted(p.name for p in (port / "windows").iterdir()) == wins
        for w in wins:
            info = lambda d: json.loads((d / "windows" / w / "window_info.json").read_text())
            assert info(port) == info(jax_)
            assert (sorted(p.name for p in (port / "windows" / w).iterdir())
                    == sorted(p.name for p in (jax_ / "windows" / w).iterdir()))


@pytest.mark.parametrize("hw", [(5, 1), (7, 3), (9, 127), (16, 130), (4, 4)])
def test_bmp_decoder_matches_opencv(tmp_path, hw):
    """read_bmp of what cv2.imwrite writes equals cv2.imdecode, with rows
    padded to 4 bytes; chip_smoke.write_bmp writes cv2's bytes."""
    img = np.random.default_rng(hw[1]).integers(0, 256, hw + (3,), dtype=np.uint8)
    p = tmp_path / "f.bmp"
    assert cv2.imwrite(str(p), img)
    want = cv2.imdecode(np.fromfile(str(p), np.uint8), cv2.IMREAD_COLOR)
    got = read_bmp(p)
    assert got.dtype == np.uint8 and np.array_equal(got, want) and np.array_equal(got, img)
    q = tmp_path / "g.bmp"
    chip_smoke.write_bmp(q, img)
    assert q.read_bytes() == p.read_bytes()


def test_bmp_decoder_refuses_other_kinds(tmp_path):
    gray = tmp_path / "gray.bmp"
    assert cv2.imwrite(str(gray), np.zeros((4, 6), np.uint8))     # 8-bit with a palette
    with pytest.raises(ValueError, match="24-bit"):
        read_bmp(gray)
    (tmp_path / "short.bmp").write_bytes((tmp_path / "gray.bmp").read_bytes()[:30])
    assert read_bmp(tmp_path / "short.bmp") is None
    top_down = tmp_path / "td.bmp"
    img = np.random.default_rng(1).integers(0, 256, (3, 5, 3), dtype=np.uint8)
    chip_smoke.write_bmp(top_down, img[::-1])       # stored rows: img's, top row first
    data = bytearray(top_down.read_bytes())
    data[22:26] = (-3).to_bytes(4, "little", signed=True)     # negative height: top-down rows
    top_down.write_bytes(bytes(data))
    assert np.array_equal(read_bmp(top_down), img)
    assert np.array_equal(cv2.imdecode(np.fromfile(str(top_down), np.uint8), cv2.IMREAD_COLOR),
                          img)


def test_image_dir_reader_matches_the_jax_reader(tmp_path):
    """Mixed sizes and extensions: the port's reader yields the JAX
    reader's frames (the .bmp ones decoded by numpy)."""
    rng = np.random.default_rng(3)
    sizes = [(24, 30), (24, 30), (20, 26), (24, 30)]
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"f{i}.{'bmp' if i % 2 == 0 else 'png'}"), img)
    (tmp_path / "notes.txt").write_text("not a frame")
    got, want = list(ImageDirReader(str(tmp_path)).batches(3)), \
        list(JImageDirReader(str(tmp_path)).batches(3))
    assert len(got) == len(want) == 2
    for (gi, gf, gn), (wi, wf, wn) in zip(got, want):
        assert gi == wi and gn == wn and np.array_equal(gf, wf)


def _run_in_thread(fn):
    result = {}

    def run():
        try:
            fn()
            result["outcome"] = "returned"
        except RuntimeError as e:
            result["outcome"] = f"raised:{e}"
        except BaseException as e:  # pragma: no cover - diagnostic
            result["outcome"] = f"other:{type(e).__name__}"

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive(), "process_video deadlocked"
    return result["outcome"]


@pytest.mark.parametrize("stage", ["_upload", "_consume"])
def test_a_failing_stage_raises_instead_of_hanging(dirs, tmp_path, monkeypatch, stage):
    """The uploader or the sink dies on the second batch: process_video
    raises its error promptly and leaves no stage waiting on a queue."""
    real = getattr(InferenceEngine, stage)
    calls = {"n": 0}

    def failing(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError(f"synthetic {stage} failure")
        return real(self, *a, **kw)

    monkeypatch.setattr(InferenceEngine, stage, failing)
    eng = InferenceEngine(_Stub(holey_tape_mask(), 3), _stub_cfg(pipeline), EngineConfig(
        batch=2, output_dir=str(tmp_path), write_video=False, print_interval=100),
        device="cpu")
    before = set(threading.enumerate())
    assert _run_in_thread(lambda: eng.process_video(dirs["burr"])) == \
        f"raised:synthetic {stage} failure"
    assert calls["n"] >= 2
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10.0)
        assert not t.is_alive(), f"{t.name} still running"


def test_engine_refuses_cuda_without_a_card_and_unported_consumers(tmp_path):
    """The quality gate and the tracker are ported; like the JAX engine's,
    each refuses a step that does not compute its statistics."""
    cfg = _stub_cfg(pipeline)
    with pytest.raises(ValueError, match="quality_stats"):
        InferenceEngine(_Stub(holey_tape_mask(), 3), cfg, EngineConfig(quality_enabled=True),
                        device="cpu")
    with pytest.raises(ValueError, match="track_defects"):
        InferenceEngine(_Stub(holey_tape_mask(), 3), cfg, EngineConfig(tracker_enabled=True),
                        device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(_Stub(holey_tape_mask(), 3), cfg)
