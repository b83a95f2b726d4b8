"""The harness on the CPU: every name resolves to its file, the metrics'
arithmetic on synthetic records, a cell added by new files alone, no JAX
in the process, and no result without a card."""
import dataclasses
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import cell, spec, trace, traffic
from benchmark.counts import nested_unet, peaks
from benchmark.tests.conftest import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves_to_its_file():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = spec.all_cells(REPO)
    assert sorted(cells) == sorted(w["name"] for w in bench["workloads"])
    for name, sp in cells.items():
        assert NAME.match(name)
        assert sp.config["name"] == sp.cell["config"]
        assert sp.config["reduced"] == [] and sp.config["assumed"] == []
        assert set(sp.workload["limits"]) == set(__import__("benchmark.check").check.NUMBERS)
        assert any(m["name"] == "setup_s" for m in sp.end_to_end)
        assert len(sp.end_to_end) >= 2 and sp.per_layer
        for m in sp.end_to_end + sp.per_layer:
            assert callable(spec.reader(REPO, m["name"]))
    for m in bench["per_layer"]:
        e2e = {e["name"] for e in bench["end_to_end"]}
        assert m["moves"] in e2e and NAME.match(m["name"])
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in cells[w].end_to_end}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert (REPO / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("config", ["nested_unet3-two_stage", "nested_unet3-enhanced"])
def test_config_file_holds_the_ports_preset(config):
    """The reference reads the configuration file's constants; the port
    reads its preset: they must be the same, and the preset must take only
    the branches the reference has."""
    from unet_tpu_torch.pipeline import get_preset

    cf = json.loads((REPO / f"benchmark/configs/{config}.json").read_text())
    d = json.loads(json.dumps(dataclasses.asdict(get_preset(cf["preset"], **cf["preset_kwargs"]))))
    pc = cf["pipeline"]
    assert {k: d["preprocess"][k] for k in pc["preprocess"]} == pc["preprocess"]
    assert d["burr"] == pc["burr"] and d["roi"] == pc["roi"]
    pp = d["preprocess"]
    assert not (pp["letterbox"] or pp["dynamic_roi"]) and pp["normalization"] == "unit"
    assert d["segment"]["threshold_mode"] == "argmax" and d["segment"]["num_classes"] == 3
    assert cf["model"]["num_classes"] == 3
    assert not (d["postprocess"]["enabled"] or d["postprocess"]["close_ksize"])
    assert not (d["geometry"]["enabled"] or d["geometry"]["analyze_defects"])
    assert not (d["inspect"]["quality_stats"] or d["inspect"]["track_defects"])


def _run(sp, calls, frames=4, start=0.0, step_s=0.5):
    window = traffic.Window(
        [traffic.Call(i, start + i * step_s, start + i * step_s + 0.01 * (i + 1),
                      start + (i + 1) * step_s, frames) for i in range(calls)],
        start, start + calls * step_s)
    return window


def _trace(n_qconv, qconv_us, n_other, other_us):
    ev, t = [], 0.0
    for i in range(n_qconv):
        ev.append(trace.Event("qconv_wgmma_kernel<64>", t, t + qconv_us, True))
        t += qconv_us + 1.0
    for i in range(n_other):
        ev.append(trace.Event("cc_propagate_cluster_kernel", t, t + other_us, True))
        t += other_us
    ev.append(trace.Event("aten::copy_", t, t + 50.0, False))
    ev.append(trace.Event("aten::empty", t + 10.0, t + 20.0, False))
    return trace.Trace(ev, 0.0, t + 100.0)


def test_metric_arithmetic_on_synthetic_records():
    sp = spec.load(REPO, "two_stage-int8-chunk96")
    window = _run(sp, calls=10, frames=384, step_s=1.25)
    tr = _trace(36, 100.0, 6, 900.0)
    card = cell.Card("gpu", "NVIDIA H100 80GB HBM3", 1, "700.00 W", 132, 1980e6)
    r = cell.Run(sp, card, 12.5, window, 5 * 2 ** 30, tr)
    read = lambda name: spec.reader(REPO, name)(r)
    assert read("frames_per_s") == pytest.approx(3840 / 12.5)
    assert read("peak_mem_gib") == pytest.approx(5.0)
    assert read("setup_s") == 12.5
    convs, head = nested_unet.frame_ops(sp.config["model"], (512, 512))
    least = convs / peaks.TENSOR_OPS_PER_S["int8"] + head / peaks.TENSOR_OPS_PER_S["bf16"]
    assert read("step_mfu.offline") == pytest.approx(100 * least * 3840 / 12.5)
    busy = (36 * 100.0 + 6 * 900.0) / 1e6
    assert trace.busy_s(tr) == pytest.approx(busy)
    assert read("idle_share.offline") == pytest.approx(100 * (1 - busy / tr.window_s))
    from benchmark.counts import bounds
    cs = [c for c in nested_unet.convs(sp.config["model"], (512, 512)) if c.k == 3]
    qb = sum(bounds.qconv_bound_ms(c, 96)[0] for c in cs)
    assert read("qconv_roofline") == pytest.approx(100 * 2 * qb / 1e3 / (36 * 100e-6))
    # a launch count that is not whole batches is no reading, and no trace none
    assert spec.reader(REPO, "qconv_roofline")(r._replace(trace=_trace(35, 100.0, 0, 1))) is None
    assert spec.reader(REPO, "qconv_roofline")(r._replace(trace=None)) is None


def test_live_metrics_on_synthetic_records():
    sp = spec.load(REPO, "two_stage-int8-live8")
    calls = [traffic.Call(i, i * 0.02, i * 0.02 + 0.015, i * 0.02 + (0.018 if i % 20 else 0.03), 8)
             for i in range(100)]
    window = traffic.Window(calls, 0.0, calls[-1].done)
    r = cell.Run(sp, None, 1.0, window, 1, None)
    lat = sorted((c.done - c.issued) * 1e3 for c in calls)
    assert spec.reader(REPO, "batch_latency_p95_ms")(r) == pytest.approx(
        float(__import__("numpy").percentile(lat, 95)))
    assert spec.reader(REPO, "host_enqueue_ms.live")(r) == pytest.approx(15.0)
    assert spec.reader(REPO, "frames_per_s")(r) == pytest.approx(800 / calls[-1].done)
    assert spec.reader(REPO, "idle_share.live")(r) is None


def test_idle_gaps_are_named_by_the_host_operation_open_across_them():
    ev = [trace.Event("k1", 0.0, 10.0, True), trace.Event("k2", 30.0, 40.0, True),
          trace.Event("k3", 45.0, 50.0, True),
          trace.Event("outer", 5.0, 44.0, False), trace.Event("inner", 12.0, 29.0, False)]
    gaps = trace.idle_gaps(trace.Trace(ev, 0.0, 60.0))
    assert gaps == {"inner": pytest.approx(20e-6), "outer": pytest.approx(5e-6),
                    "(no host operation)": pytest.approx(10e-6)}
    assert trace.top(gaps, 2) == [["inner", gaps["inner"]], ["(no host operation)", 10e-6]]


def test_a_cell_config_and_metric_are_added_by_new_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and BENCHMARK.json entries; the harness
    runs the cell and reports the metric, no file of it edited."""
    root = tiny_root(tmp_path / "root", {"regret_max": 1e9, "regret_mean": 1e9, "flip_share": 1.0,
                                         "burr_diff": 1e9, "count_diff": 0.0,
                                         "roi_px": 0.0, "missing": 0.0})
    b = root / "benchmark"
    cf = json.loads((b / "configs/nested_unet3-two_stage.json").read_text())
    cf["name"] = "nested_unet3-two_stage_wide"
    cf["frame_hw"] = [64, 128]
    (b / "configs/nested_unet3-two_stage_wide.json").write_text(json.dumps(cf))
    tr = json.loads((b / "traffic/int8-live8.json").read_text())
    tr["name"] = "int8-live2x"
    (b / "traffic/int8-live2x.json").write_text(json.dumps(tr))
    (b / "workloads/wide-int8-live2x.json").write_text(json.dumps(
        {"name": "wide-int8-live2x", "config": cf["name"], "traffic": tr["name"],
         "limits": json.loads((b / "workloads/two_stage-int8-live8.json").read_text())["limits"]}))
    (b / "metrics/calls_per_s.live.py").write_text(
        "def read(run):\n    return len(run.window.calls) / run.window.seconds\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cf["name"], "source": cf["source"],
                             "file": f"benchmark/configs/{cf['name']}.json", "reduced": [],
                             "why": "a throwaway configuration"})
    bench["workloads"].append({"name": "wide-int8-live2x", "config": cf["name"],
                               "traffic": tr["name"], "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "calls_per_s.live", "unit": "calls/s", "better": "higher",
                               "source": "host_clock", "layer": "step",
                               "moves": "batch_latency_p95_ms",
                               "workloads": ["wide-int8-live2x"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("wide-int8-live2x")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    sp = spec.load(root, "wide-int8-live2x")
    out = cell.run(sp, 2 ** 31 + 7, 0.5, True, "cpu")
    assert out["correct"] is True
    assert "calls_per_s.live" in out["metrics"] and out["metrics"]["calls_per_s.live"]["value"] > 0
    assert list(out)[-3:] == ["checks", "check_lines", "card_line"]


_NO_JAX = r"""
import sys, torch
torch.set_num_threads(2)
from pathlib import Path
from benchmark import cell, spec, run
sp = spec.load(Path(sys.argv[1]), "two_stage-int8-live8")
cell.run(sp, 5, 0.2, False, "cpu")
print("TOPS " + ",".join(sorted({m.split(".")[0] for m in sys.modules})))
print("BAD " + ",".join(run.forbidden_loaded()))
"""


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (the port, the reference, the check) in a fresh process:
    no module of JAX, flax or the JAX package (top-level names compared
    whole, so `unet_tpu_torch` passes)."""
    root = tiny_root(tmp_path / "root")
    out = subprocess.run([sys.executable, "-c", _NO_JAX, str(root)], cwd=REPO,
                         capture_output=True, text=True, timeout=600, check=True).stdout
    lines = {ln.split(" ")[0]: ln[len(ln.split(" ")[0]) + 1:] for ln in out.splitlines()
             if ln.startswith(("TOPS ", "BAD "))}
    tops, bad = set(lines["TOPS"].split(",")), lines["BAD"]
    assert "unet_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "unet_tpu", "bench"}
    assert bad == ""


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "two_stage-int8-live8", "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr and "no CPU fallback" in p.stderr
