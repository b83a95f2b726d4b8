"""The port's CLI (unet_tpu_torch.cli.main) against the port's own step:
`infer` and `serve` on a saved seeded NestedUNet .pth over .bmp directories
give the step's numbers in the JAX package's file layout; `--int8` keeps
its held-out split; what is not ported names its ROADMAP item. On the card
(`-m cuda`), `infer` through the engine with chip_smoke.phase_engine's
checks, high_res_roi and debug (ROADMAP A8) included.

This file imports neither jax nor the JAX package, so its card test runs on
a machine that has only PyTorch for CUDA:

    python -m pytest tests/test_torch_cli.py -q -m cuda
"""
import csv
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from unet_tpu_torch.cli.main import load_model, main
from unet_tpu_torch.io.video import ImageDirReader
from unet_tpu_torch.pipeline import presets, stages

H, W = 96, 160


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op CPU thread while this module runs: the engine's step
    runs beside its host threads, and on a loaded CPU a step of many small
    ops spends its time at the thread pool's barriers. A copy of
    tests/torch_threads.py's fixture: this file's card tests run on a
    machine where `tests.` does not resolve to this directory."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    pth = {}
    for k in (3, 4, 7):
        pth[k] = str(root / f"m{k}.pth")
        torch.save(cs.seeded_nested_unet(num_classes=k).state_dict(), pth[k])
    return {"pth": pth,
            "burr": cs.write_bmp_dir(root / "burr", cs.synthetic_frames(10, H, W, seed=0)),
            "wrap": cs.write_bmp_dir(root / "wrap", cs.wrap_scenes(10, H, W, seed=0))}


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("preset,src,k,files", [
    ("two_stage", "burr", 3, {"events.csv"}),
    ("wrap_uniformity", "wrap", 4, {"events.csv", "wrap_uniformity.csv"})])
def test_infer_writes_the_steps_numbers(data, tmp_path, preset, src, k, files):
    out = tmp_path / "out"
    assert main(["infer", "--video", data[src], "--output", str(out), "--preset", preset,
                 "--model", data["pth"][k], "--model-size", "64", "--no-video",
                 "--batch", "4", "--device", "cpu"]) == 0
    assert {p.name for p in out.iterdir()} == files
    rows = _rows(out / "events.csv")
    assert rows[0] == ["frame_id", "cable_pct", "tape_pct", "burr_pct", "burr_px", "status"]
    # the CLI's model (bf16, BN-folded forward) through the step, batches of 4
    model, _, _ = load_model(data["pth"][k], "nested_unet", "bfloat16", k)
    cfg = presets.get_preset(preset).replace_in("preprocess", model_size=(64, 64)) \
        .replace_in("segment", fast_forward=True)
    step = stages.build_step(model, cfg, device="cpu")
    want, diam = [], []
    for ids, frames, n in ImageDirReader(data[src]).batches(4):
        o = step(frames)
        want += cs._events_rows(o, ids, n, cfg)
        if o.diameters is not None:
            diam += [(f"{float(o.diameters.dc_px[i]):.2f}", f"{float(o.diameters.dt_px[i]):.2f}")
                     for i in range(n)]
    assert rows[1:] == want and [r[0] for r in rows[1:]] == [str(i) for i in range(1, 11)]
    if preset == "wrap_uniformity":
        wu = _rows(out / "wrap_uniformity.csv")
        assert wu[0][:3] == ["frame_id", "cable_d_px", "tape_d_px"]
        assert [tuple(r[1:3]) for r in wu[1:]] == diam


def test_serve_writes_the_steps_numbers(data, tmp_path, capsys):
    out = tmp_path / "out"
    assert main(["serve", "--videos", data["burr"], data["wrap"], "--output", str(out),
                 "--preset", "wrap_7class", "--model", data["pth"][7], "--model-size", "64",
                 "--device", "cpu"]) == 0
    summary = json.loads((out / "serve_summary.json").read_text())
    assert summary["frames"] == 20 and json.loads(capsys.readouterr().out.split(
        "\n", 1)[1]) == summary
    streams = [out / "stream_00_burr", out / "stream_01_wrap"]
    model, _, _ = load_model(data["pth"][7], "nested_unet", "bfloat16", 7)
    cfg = presets.wrap_7class().replace_in("preprocess", model_size=(64, 64)) \
        .replace_in("segment", fast_forward=True)
    step = stages.build_step(model, cfg, device="cpu")
    pairs = zip(*(ImageDirReader(data[s]).frames() for s in ("burr", "wrap")))
    outs = [(fid, step(np.stack([a, b]))) for (fid, a), (_, b) in pairs]
    for s, d in enumerate(streams):
        assert {p.name for p in d.iterdir()} == {"results.csv", "events.jsonl", "summary.json",
                                                 "wrap_uniformity.csv"}
        rows = _rows(d / "results.csv")
        assert rows[0] == ["frame_id", "cable_px", "tape_px", "burr_px", "dc_px", "dt_px"]
        assert rows[1:] == [[str(fid)] + [str(int(getattr(o, f)[s])) for f in
                                          ("cable_px", "tape_px", "burr_px")]
                            + [f"{float(o.diameters.dc_px[s]):.2f}",
                               f"{float(o.diameters.dt_px[s]):.2f}"] for fid, o in outs]


def test_int8_short_directory_holds_out_agreement_frames(tmp_path, capsys):
    """16 frames: 8 calibrate (even), 8 held out (odd) for the agreement gate
    (tests/test_config_serve.py::test_cli_int8_short_video_holds_out_agreement_frames)."""
    d = cs.write_bmp_dir(tmp_path / "frames", cs.synthetic_frames(16, 64, 64, seed=7))
    out = tmp_path / "out"
    assert main(["infer", "--video", d, "--output", str(out), "--preset", "two_stage",
                 "--model-size", "32", "--int8", "--batch", "4", "--no-video",
                 "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "smoke mode" in text
    assert "calibrated on 8 frames" in text and "8 held out for the agreement gate" in text
    assert "agreement" in text
    assert len(_rows(out / "events.csv")) == 1 + 16


def test_what_is_not_ported_names_its_item(data, tmp_path, monkeypatch, capsys):
    """What is not ported names its ROADMAP item (an orbax directory names
    convert_orbax.py, which reads it); what A12, A13, A14, A15's export and
    A5 ported now runs: a pipeline YAML (`--config`), `--arch
    simple_unet` and a ResNet50-NestedUNet .pth, each writing a row a frame;
    `train` and `evaluate` over a labelled split; `tools` (audit,
    summarize-checkpoints) and `export` of the trained model; `bench` on
    the CPU with a 64^2 model and one small point, one JSON line."""
    base = ["infer", "--video", data["burr"], "--output", str(tmp_path / "o"), "--device", "cpu"]
    split = cs.write_split(tmp_path / "split", 4, 2, 40, 56)
    assert main(["train", "--recipe", "3class_advanced", "--data-root", split, "--output",
                 str(tmp_path / "t"), "--epochs", "1", "--batch", "2", "--image-size", "32",
                 "--device", "cpu"]) == 0
    assert main(["evaluate", "--data-root", split, "--model", str(tmp_path / "t" / "last.pth"),
                 "--image-size", "32", "--output", str(tmp_path / "e"), "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "e" / "metrics.json").read_text())["miou"] >= 0
    with pytest.raises(SystemExit, match="convert_orbax.py"):
        main(base + ["--model", str(tmp_path)])
    from unet_tpu_torch import bench

    monkeypatch.setattr(bench, "MODEL_SIZE", (64, 64))
    monkeypatch.setattr(bench, "N_FRAMES", 1)
    monkeypatch.setattr(bench, "REPEATS", 1)
    monkeypatch.setattr(bench, "CONFIG_NAMES", {2: ("two_stage", {}, "two_stage_800x448",
                                                    (112, 200))})
    monkeypatch.setattr(bench, "FIXED_POINTS", {2: [("chunked", 1, "bf16")]})
    capsys.readouterr()
    assert main(["bench", "--config", "2", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "median_fps", "bf16_fps"} <= set(line)
    assert line["metric"] == "two_stage_800x448_fps_per_chip(batch=1)" and line["value"] > 0
    labelme = tmp_path / "labelme"
    labelme.mkdir()
    (labelme / "a.json").write_text(json.dumps({
        "imageHeight": 40, "imageWidth": 56,
        "shapes": [{"label": "cable", "points": [[2, 2], [30, 2], [30, 30], [2, 30]]}]}))
    assert main(["tools", "audit", "--labelme-dir", str(labelme),
                 "--out", str(tmp_path / "audit.json")]) == 0
    assert json.loads((tmp_path / "audit.json").read_text())["total"] == 1
    assert main(["tools", "summarize-checkpoints", "--ckpt-dir", str(tmp_path / "t")]) == 0
    assert main(["export", "--model", str(tmp_path / "t" / "last.pth"), "--output",
                 str(tmp_path / "m.pt2"), "--input-size", "32", "--device", "cpu"]) == 0
    assert (tmp_path / "m.pt2").stat().st_size > 0
    from unet_tpu_torch.core.config import save_pipeline_yaml

    save_pipeline_yaml(presets.two_stage(), str(tmp_path / "p.yaml"))
    torch.save({"model": cs.seeded_model("nested_unet_resnet50").state_dict(), "epoch": 3},
               tmp_path / "r50.pth")
    for i, flags in enumerate((["--config", str(tmp_path / "p.yaml"), "--model", data["pth"][3]],
                               ["--arch", "simple_unet"],
                               ["--model", str(tmp_path / "r50.pth")])):
        out = tmp_path / f"run{i}"
        argv = base[:4] + [str(out), "--device", "cpu", "--model-size", "32", "--no-video"]
        assert main(argv + flags) == 0
        assert len(_rows(out / "events.csv")) == 1 + 10
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(base[:-2] + ["--model-size", "32"])


def test_pth_containers_load_strictly(data, tmp_path):
    """The reference's containers unwrap; the class count and the deep
    supervision heads come from the keys."""
    sd = torch.load(data["pth"][4])
    m4 = cs.seeded_nested_unet(num_classes=4)
    for wrap in ("model", "model_state_dict", "state_dict", None):
        obj = sd if wrap is None else {wrap: sd, "epoch": 1, "best_mIoU": 0.5}
        torch.save(obj, tmp_path / "c.pth")
        model, k, arch = load_model(str(tmp_path / "c.pth"), "nested_unet", "float32", 3)
        assert (k, arch, model.deep_supervision) == (4, "nested_unet", False)
        assert all(torch.equal(model.state_dict()[n], v) for n, v in m4.state_dict().items())
    bad = dict(sd)
    bad.pop("conv0_0.bn1.running_var")
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="running_var"):
        load_model(str(tmp_path / "bad.pth"), "nested_unet", "float32", 3)


def test_chip_smoke_engine_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.phase_engine end to end on the CPU at a small size (plain
    versions, so zero launch counts; the card's synchronize stubbed): every
    CLI run held against the step, the serve run, and the timing records."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    counts, rec = cs.phase_engine(H=64, W=96, n_frames=12, timing_frames=8, timing_distinct=4,
                                  batches=(4,), timed_calls=2, model_size=32, device="cpu")
    paths = ("two_stage_bf16", "two_stage_int8", "wrap_uniformity", "production", "optimized",
             "serve_wrap_7class")
    assert set(counts) == {f"engine_{p}" for p in paths}
    assert all(v == 0 for c in counts.values() for v in c.values())
    assert set(rec["runs"]) == set(paths)
    assert rec["runs"]["production"]["total_windows"] == 1
    assert rec["runs"]["serve_wrap_7class"]["frames"] == 24
    assert set(rec["timing"]) == {"two_stage_bf16_b4", "two_stage_int8_b4"}
    assert set(rec["decode_ms_per_frame"]) == {"read_bmp", "cv2.imread"}
    for t in rec["timing"].values():
        assert len(t["engine_fps_calls"]) == 2 and t["bare_step_fps"] > 0
        assert t["batches"] == 2 and t["batch_latency_ms"]["p99"] is None
        assert set(t["legs_ms_per_frame"]) == {"decode", "upload", "dispatch", "download",
                                               "host"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's entry points run there)")
    return "cuda"


@pytest.mark.cuda
def test_infer_on_the_card(card, tmp_path):
    """`cli infer` on the card through the engine (pinned buffers, the upload
    and dispatch streams, the download's event), with phase_engine's checks:
    launches per batch and events.csv equal to the step's; two_stage in bf16
    and int8, and the A8 presets high_res_roi (two 2048x2448 frames and
    their burr crop) and debug (7 classes, no B1 site)."""
    pth = {}
    for k in (3, 7):
        pth[k] = str(tmp_path / f"m{k}.pth")
        torch.save(cs.seeded_nested_unet(num_classes=k).state_dict(), pth[k])
    two = cs.write_bmp_dir(tmp_path / "two", cs.synthetic_frames(20, 448, 800, seed=0))
    high = cs.write_bmp_dir(tmp_path / "high", cs.high_res_scenes(2, seed=1, patch=20))
    for path, src, k, flags in (
            ("two_stage_bf16", two, 3, ["--preset", "two_stage"]),
            ("two_stage_int8", two, 3, ["--preset", "two_stage", "--int8"]),
            ("high_res_roi", high, 3, ["--preset", "high_res_roi"]),
            ("debug", two, 7, ["--preset", "debug"])):
        got, rec = cs.engine_run(path, src, pth[k], flags, tmp_path / f"out_{path}", card)
        assert rec["processed"] == (2 if path == "high_res_roi" else 20)


def test_inspect_runs_the_yaml_configured_window_mode(data, tmp_path, capsys):
    """`cli inspect`: the YAML's model, preset, window and ROI settings reach
    the engine, which closes a window every window_max_frames frames."""
    cfg = tmp_path / "inspect.yaml"
    cfg.write_text(
        f"model_path: {data['pth'][3]}\ninput_size: 64\npreset: production\nbatch: 4\n"
        "window_min_frames: 3\nwindow_max_frames: 5\ncamera_id: line3\n"
        "roi: {x1: 140, y1: 0, x2: 270, y2: 512}\nthresholds: {target_delta_d: 2.0}\n")
    out = tmp_path / "out"
    assert main(["inspect", "--config", str(cfg), "--video", data["burr"], "--output", str(out),
                 "--device", "cpu"]) == 0
    assert "inspection complete" in capsys.readouterr().out
    recs = [json.loads(l) for l in open(out / "events" / "inspection_events.jsonl")]
    assert len(recs) == 2 and {r["camera_id"] for r in recs} == {"line3"}
    assert [r["window_info"]["num_frames"] for r in recs] == [5, 5]
    assert len(_rows(out / "events.csv")) == 1 + 10
