"""The port's host modules against the JAX package's on the same inputs:
the event detector, event gate, defect tracker and frame quality gate
(inspect/detectors.py), the event emitters (events/emitters.py), the
overlays (pipeline/visualize.py, byte for byte) and the quality statistics
on tensors (`quality_stats`, within 1e-4 relative of the jitted JAX
function: float32 sums in another order)."""
import csv
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import synthetic_frames
from unet_tpu.events import emitters as jemitters
from unet_tpu.inspect import detectors as jdetectors
from unet_tpu.inspect import window as jwindow
from unet_tpu.pipeline import visualize as jvisualize
from unet_tpu_torch.events import emitters
from unet_tpu_torch.inspect import detectors, window
from unet_tpu_torch.pipeline import visualize


def _metrics(mod, n=60, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dc = float(rng.uniform(20, 40))
        dt = dc * float(rng.choice([0.9, 1.2, 1.8])) if rng.random() > 0.1 else 0.0
        out.append(mod.FrameMetrics(
            frame_id=i + 1, dc_px=dc, dt_px=dt, delta_d_px=dt - dc,
            ratio=None if rng.random() < 0.1 else dt / dc, has_burr=bool(rng.random() < 0.4),
            cable_coverage=float(rng.random()), tape_coverage=float(rng.random())))
    return out


@pytest.mark.parametrize("cooldown", [0, 5, 30])
def test_event_detector_matches(cooldown):
    kw = dict(thin_wrap_frames=2, thick_wrap_frames=2, burr_frames=2, cooldown_frames=cooldown,
              uniformity_window=10)
    got = detectors.EventDetector(detectors.EventConfig(**kw))
    want = jdetectors.EventDetector(jdetectors.EventConfig(**kw))
    fired = [(got.add_frame(a), want.add_frame(b))
             for a, b in zip(_metrics(detectors), _metrics(jdetectors))]
    assert all(g == w for g, w in fired) and any(g for g, _ in fired)
    assert got.compute_uniformity() == want.compute_uniformity()
    assert got.get_average_ratio() == want.get_average_ratio()
    assert got.last_event_frame == want.last_event_frame


def test_event_gate_matches():
    t = {"now": 0.0}
    got = detectors.EventGate(4, 1.0, clock=lambda: t["now"])
    want = jdetectors.EventGate(4, 1.0, clock=lambda: t["now"])
    rng = np.random.default_rng(1)
    fires = []
    for i in range(200):
        t["now"] = i * 0.1
        a = bool(rng.random() < 0.8)
        got.update(a)
        want.update(a)
        fires.append((got.should_fire(), want.should_fire()))
    assert all(g == w for g, w in fires) and sum(g for g, _ in fires) > 3


def test_defect_tracker_and_iou_match():
    rng = np.random.default_rng(2)
    got = detectors.DefectTracker(3, 0.3, 4, {3: "bulge_defect"})
    want = jdetectors.DefectTracker(3, 0.3, 4, {3: "bulge_defect"})
    for f in range(40):
        dets = []
        for k in range(int(rng.integers(0, 4))):
            x, y = float(rng.integers(0, 20)) + 40 * k, float(rng.integers(0, 5))
            dets.append({"class_id": int(rng.choice([3, 4])), "bbox": (x, y, x + 30, y + 30),
                         "area": int(rng.integers(10, 900))})
        assert got.update(dets, f) == want.update(dets, f)
    boxes = rng.uniform(0, 50, (30, 4))
    boxes[:, 2:] += boxes[:, :2]
    for a in boxes:
        for b in boxes[:5]:
            assert detectors.bbox_iou(tuple(a), tuple(b)) == jdetectors.bbox_iou(tuple(a), tuple(b))


def test_frame_quality_gate_matches():
    rng = np.random.default_rng(3)
    for enable in (True, False):
        g, w = detectors.FrameQualityGate(enable), jdetectors.FrameQualityGate(enable)
        for lap, std, mad in rng.uniform([0, 0, 0], [200, 20, 30], (200, 3)):
            assert g.check(lap, std, mad).__dict__ == w.check(lap, std, mad).__dict__


@pytest.mark.parametrize("with_prev", [False, True])
def test_quality_stats_against_jitted_jax(with_prev):
    gray = synthetic_frames(3, 48, 64, seed=4)[..., 1].astype(np.float32)
    prev = synthetic_frames(1, 48, 64, seed=9)[0, ..., 1].astype(np.float32)
    p = prev if with_prev else None
    want = jax.jit(lambda g, q: jdetectors.quality_stats(g, q))(
        jnp.asarray(gray), None if p is None else jnp.asarray(p))
    got = detectors.quality_stats(torch.from_numpy(gray),
                                  None if p is None else torch.from_numpy(p))
    for g, w in zip(got, want):
        assert g.shape == (3,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=0)
    assert float(got[2][0]) > 0 if with_prev else float(got[2][0]) == 0.0


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

def _window(mod, defects):
    agg = mod.WindowAggregator(3.0, 2, 4)
    for i in range(4):
        agg.add_frame(mod.FrameResult(
            timestamp_ns=i * 40_000_000, frame_id=i + 1, delta_d_mm=10.0 + i,
            dc_mm=20.0, dt_mm=30.0 + i, cable_coverage=0.3, tape_coverage=0.1 + 0.1 * i,
            tape_hole_ratio=0.2, tape_num_components=7, total_defect_area=defects,
            defect_areas={3: defects}))
    stats = agg.get_statistics()
    return mod.make_decision(stats), stats


@pytest.mark.parametrize("defects", [0, 900])
def test_inspection_event_logger_matches(tmp_path, defects):
    frame = synthetic_frames(1, 40, 56, seed=5)[0]
    recs = {}
    for name, em, win in (("port", emitters, window), ("jax", jemitters, jwindow)):
        log = em.InspectionEventLogger(em.EventOutputConfig(output_dir=str(tmp_path / name)))
        decision, stats = _window(win, defects)
        log.log_event(decision, stats, frame_bgr=frame, overlay_bgr=frame[::-1].copy(),
                      camera_id="cam7")
        log.log_event(decision, stats, camera_id="cam7")
        recs[name] = [json.loads(l) for l in open(log.jsonl_path)]
        recs[name + "_summary"] = log.get_summary()
        recs[name + "_images"] = sorted(p.relative_to(tmp_path / name).parent.as_posix()
                                        for p in (tmp_path / name).rglob("*.jpg"))
    strip = lambda rs: [{k: (sorted(v) if k == "images" else v) for k, v in r.items()
                         if k != "timestamp"} for r in rs]
    assert strip(recs["port"]) == strip(recs["jax"]) and recs["port"][0]["result"] == "NG"
    assert recs["port_summary"] == recs["jax_summary"]
    assert recs["port_images"] == recs["jax_images"] and len(recs["port_images"]) == 2
    assert emitters.format_reasons_readable(recs["port"][0]["reasons"]) == \
        jemitters.format_reasons_readable(recs["jax"][0]["reasons"])
    assert emitters.format_reasons_readable([]) == "Normal"
    assert emitters.CLASS_NAMES == jemitters.CLASS_NAMES


def test_csv_and_json_loggers_match(tmp_path):
    out = {}
    for name, em in (("port", emitters), ("jax", jemitters)):
        d = tmp_path / name
        a = em.AnomalyLogger(str(d / "events.log"))
        a.log_event("2026-01-01 00:00:00", "burr", (1, 2, 3, 4), 17)
        a.log_event("2026-01-01 00:00:01", "bulge", (5, 6, 7, 8))
        s = em.StatisticsLogger(str(d / "stats.csv"))
        s.log_statistics(120, 7, 3.25)
        j = json.loads(open(em.JSONLogger(str(d / "json")).save_event(
            "cam0", 123, [{"type": "burr"}], {"m": 1}, {"raw": "x.jpg"})).read())
        mgr = em.EventManager(str(d / "mgr"), {"enabled": False})
        payload = mgr.emit("cam0", None, None, [{"type": "burr"}], {"m": 2}, 456)
        out[name] = dict(
            log=(d / "events.log").read_text(), read=a.read_log(),
            stats=[r[1:] for r in csv.reader(open(d / "stats.csv"))],
            json={k: v for k, v in j.items() if k != "timestamp"},
            payload={k: v for k, v in payload.items() if k not in ("image", "overlay")})
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# overlays
# ---------------------------------------------------------------------------

def _class_map(h, w, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    m[:, w // 3:w // 2] = 1
    m[h // 4:h // 2, w // 3 - 4:w // 2 + 4] = 2
    m[rng.random((h, w)) < 0.01] = 3
    return m


@pytest.mark.parametrize("roi,box", [(None, True), ((20, 0, 70, 60), True),
                                     ((20, 0, 70, 60), False)])
def test_two_stage_overlay_and_hud_bytes_equal(roi, box):
    frame = synthetic_frames(1, 60, 96, seed=6)[0]
    cmap = _class_map(60, 96, 6)
    got = visualize.two_stage_overlay(frame, cmap, roi, draw_roi_box=box)
    want = jvisualize.two_stage_overlay(frame, cmap, roi, draw_roi_box=box)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    lines = ["Frame: 7 | FPS: 12.5", "[BURR!] Cable:3.1% Tape:1.0% Burr:0.2%"]
    assert np.array_equal(visualize.draw_hud(got.copy(), lines),
                          jvisualize.draw_hud(want.copy(), lines))


def test_palettes_overlay_bboxes_comparison_equal():
    frame = synthetic_frames(1, 40, 64, seed=7)[0]
    mask = np.random.default_rng(7).integers(0, 7, (40, 64)).astype(np.uint8)
    assert np.array_equal(visualize.colorize_mask(mask), jvisualize.colorize_mask(mask))
    assert np.array_equal(visualize.overlay(frame, mask, 0.3),
                          jvisualize.overlay(frame, mask, 0.3))
    boxes = [{"bbox": (2, 3, 20, 30), "class_id": 3, "confidence": 0.8},
             {"bbox": (30, 5, 60, 35), "class_id": 9, "type": "thin"}]
    assert np.array_equal(visualize.draw_bboxes(frame, boxes),
                          jvisualize.draw_bboxes(frame, boxes))
    assert np.array_equal(visualize.comparison_image(frame, mask, mask[::-1]),
                          jvisualize.comparison_image(frame, mask, mask[::-1]))
    assert visualize.PALETTE_7 == jvisualize.PALETTE_7
    assert visualize.TWO_STAGE_COLORS == jvisualize.TWO_STAGE_COLORS
