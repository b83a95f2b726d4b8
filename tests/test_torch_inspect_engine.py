"""The port's InferenceEngine with the frame quality gate and the defect
tracker against the JAX package's engine, on the same directory of .bmp
frames (flat, blurred and frozen frames among scenes whose defect patches
persist) at model 64x64 on the CPU: skipped.csv's frame ids and reasons
equal and its numbers within 1e-4 relative or their last printed digit
(the quality statistics sum float32 in another order,
tests/test_torch_host.py; the file prints two decimals), confirmed_defects.csv
and events.csv byte for byte, and the summaries' counts. Also the CLI's
`infer` for every preset of presets.PRESETS."""
import csv

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from chip_smoke import ColourDefectModel, gate_scenes
from unet_tpu.pipeline import EngineConfig as JEngineConfig
from unet_tpu.pipeline import InferenceEngine as JInferenceEngine
from unet_tpu.pipeline import presets as jpresets
from unet_tpu_torch.cli.main import main
from unet_tpu_torch.pipeline import EngineConfig, InferenceEngine, presets
from tests.torch_threads import one_intra_op_thread  # noqa: F401

H, W = 96, 128


class _JColourDefectModel:
    """JAX twin of chip_smoke.ColourDefectModel (NHWC)."""

    def __init__(self, num_classes=7):
        self.num_classes = num_classes

    def apply(self, variables, x, train=False):
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        hi, lo = (lambda c: c > 0.6), (lambda c: c < 0.4)
        cable = hi(r) & hi(b)
        tape = hi(r) & lo(b) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        colours = (hi(g) & lo(r) & lo(b), hi(b) & lo(r) & lo(g),
                   hi(r) & hi(g) & lo(b), hi(r) & hi(b) & lo(g))
        for k in range(3, self.num_classes):
            cls = jnp.where(colours[k - 3], k, cls)
        return jax.nn.one_hot(cls, self.num_classes) * 10.0


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    return cs.write_bmp_dir(tmp_path_factory.mktemp("gate") / "frames",
                            gate_scenes(23, H, W, seed=2))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


COUNTS = ("processed", "skipped_frames", "confirmed_defects", "burr_frames", "total_windows",
          "ng_windows", "detector_events")


@pytest.mark.parametrize("name", ["optimized", "video_full"])
def test_gate_and_tracker_match_the_jax_engine(frames_dir, tmp_path, name):
    """Batches of 4 over 23 frames: the quality statistics' first frame of
    each batch diffs against the previous batch's last frame (the first
    batch's against itself), the last batch holds 3 valid frames."""
    opts = dict(presets.engine_hints(name), batch=4, write_video=False, print_interval=1000,
                window_min_frames=3, window_max_frames=4)
    cfgs = [mod.get_preset(name).replace_in("preprocess", model_size=(64, 64))
            for mod in (presets, jpresets)]
    got = InferenceEngine(ColourDefectModel(7), cfgs[0], EngineConfig(
        output_dir=str(tmp_path / "port"), **opts), device="cpu").process_video(frames_dir)
    want = JInferenceEngine(_JColourDefectModel(7), {}, cfgs[1], JEngineConfig(
        output_dir=str(tmp_path / "jax"), **opts)).process_video(frames_dir)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["processed"] == 23 and got["skipped_frames"] >= 6

    port, jax_ = tmp_path / "port", tmp_path / "jax"
    names = {p.name for p in jax_.iterdir() if p.suffix == ".csv"}
    assert names == {p.name for p in port.iterdir() if p.suffix == ".csv"}
    assert "skipped.csv" in names
    g, w = _rows(port / "skipped.csv"), _rows(jax_ / "skipped.csv")
    assert [r[:2] for r in g] == [r[:2] for r in w]
    reasons = {r[1] for r in g[1:]}
    assert {"revealed_glitch_frame(std<glitch_flat_th)", "motion_blur(lap<th & mad>th)"} <= reasons
    np.testing.assert_allclose(np.asarray([r[2:] for r in g[1:]], float),
                               np.asarray([r[2:] for r in w[1:]], float), rtol=1e-4, atol=0.01)
    for f in names - {"skipped.csv"}:     # events, detector_events, confirmed_defects
        assert (port / f).read_bytes() == (jax_ / f).read_bytes(), f
    if name == "optimized":
        rows = _rows(port / "confirmed_defects.csv")[1:]
        assert got["confirmed_defects"] == len(rows) >= 4
        assert {r[1] for r in rows} == {"bulge_defect", "loose_defect", "damage_defect",
                                        "thin_defect"}


def test_gate_and_tracker_need_their_statistics():
    cfg = presets.two_stage()
    for opts, what in ((dict(quality_enabled=True), "quality_stats"),
                       (dict(tracker_enabled=True), "track_defects")):
        with pytest.raises(ValueError, match=what):
            InferenceEngine(ColourDefectModel(3), cfg, EngineConfig(**opts), device="cpu")


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_presets")
    pth = {}
    for k in (3, 4, 6, 7):
        pth[k] = str(root / f"m{k}.pth")
        torch.save(cs.seeded_nested_unet(num_classes=k).state_dict(), pth[k])
    return {"pth": pth, "frames": cs.write_bmp_dir(root / "frames", gate_scenes(6, 64, 96))}


# enhanced's non-local means at its forced 800x448 takes about a minute on
# the CPU: a slow case
@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow) if n == "enhanced"
                                  else n for n in sorted(presets.PRESETS)])
def test_cli_infer_runs_every_preset(cli_data, tmp_path, name):
    """`infer --preset <name>` to its end on the CPU with a seeded
    NestedUNet of the preset's class count (model input 32x32): every frame
    is in events.csv but those the quality gate skipped."""
    cfg = presets.get_preset(name)
    out = tmp_path / "out"
    assert main(["infer", "--video", cli_data["frames"], "--output", str(out), "--preset", name,
                 "--model", cli_data["pth"][cfg.segment.num_classes], "--no-video",
                 "--batch", "4", "--model-size", "32", "--device", "cpu"]) == 0
    hints = presets.engine_hints(name)
    skipped = len(_rows(out / "skipped.csv")) - 1 if hints.get("quality_enabled") else 0
    assert len(_rows(out / "events.csv")) == 1 + 6 - skipped
    assert (out / "skipped.csv").exists() == bool(hints.get("quality_enabled"))
    assert (out / "confirmed_defects.csv").exists() == bool(hints.get("tracker_enabled"))


def test_chip_smoke_preset_phases_run_on_the_cpu(monkeypatch):
    """chip_smoke.py's preset and gate/tracker phases end to end on the CPU
    at a small size (plain versions, so zero launch counts; the card's
    synchronize stubbed): the colour runs held against the CPU step, B1's
    sites named by caller, and the engine's skipped.csv, events.csv and
    confirmed_defects.csv held against the step."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    zero = {k: 0 for k in ("cc_propagate", "cc_propagate_cluster", "cc_propagate_global",
                           "cc_propagate_cluster8", "cc_propagate_cluster16", "nlm", "qconv",
                           "qconv_wgmma", "qconv_sync", "qconv_c3")}
    small = dict(spatial_min_area=30, spatial_cable_w=(3, 40), spatial_tape_w=(2, 40),
                 refine_min_area=20, refine_wide_w=30, refine_edge_area=150)
    cfgs = {}
    for p in cs.PRESET_PATHS:
        c = presets.get_preset(p).replace_in("preprocess", model_size=(64, 64))
        cfgs[p] = c.replace_in("postprocess", **small) if c.postprocess.mode != "shape" else c
    rec, counts, checks, timings = cs.phase_presets(cfgs, {p: zero for p in cfgs}, 96, 128,
                                                    device="cpu", b=2, models=False)
    assert set(counts) == set(cfgs) and all(v <= 1e-4 for v in checks.values())
    sites = {k for k in rec}
    assert {"spatial/label 1 (spatial_strip_filter)", "roi_first/hysteresis (detect_vertical_roi)",
            "roi_first/label 1 (refine_mask_by_geometry)", "robust/label 1 (filter_cable_by_shape)",
            "robust/label 2 (largest_component)", "optimized/label 6 (defect_components)"} <= sites
    assert {p: sum(1 for k in rec if k.startswith(p + "/")) for p in cfgs} == {
        p: sum(cs.PRESET_B1[p]) for p in cfgs}
    counts, record = cs.phase_inspect_engine(96, 128, n_frames=23, batch=4, device="cpu")
    assert record["optimized"]["confirmed"] >= 4 and record["video_full"]["skipped"] >= 6
