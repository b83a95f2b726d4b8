"""The port's core layer against the JAX package's: pipeline configs through
YAML (`core.config`, unet_tpu/core/config.py) for every preset and for the
two legacy layouts, `cli infer --config` through the engine, and
`core.profiling` (StageTimer, device_trace). The `--config` runs are
chip_smoke.phase_config_runs at a small size on the CPU."""
import dataclasses

import pytest
import torch
import yaml

import chip_smoke as cs
from unet_tpu.core import config as jconfig
from unet_tpu.pipeline import presets as jpresets
from unet_tpu_torch.core import config
from unet_tpu_torch.core.profiling import StageTimer, device_trace
from unet_tpu_torch.pipeline import presets
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_preset_yaml_round_trip_equals_jax(name, tmp_path):
    """pipeline_cfg_to_dict equal in both packages; a file saved by either
    package loads in both to the preset it was saved from."""
    cfg, jcfg = presets.get_preset(name), jpresets.get_preset(name)
    assert config.pipeline_cfg_to_dict(cfg) == jconfig.pipeline_cfg_to_dict(jcfg)
    for save, path in ((config.save_pipeline_yaml, tmp_path / "port.yaml"),
                       (jconfig.save_pipeline_yaml, tmp_path / "jax.yaml")):
        save(cfg if save is config.save_pipeline_yaml else jcfg, str(path))
        got, want = config.load_pipeline_yaml(str(path)), jconfig.load_pipeline_yaml(str(path))
        assert config.pipeline_cfg_to_dict(got) == jconfig.pipeline_cfg_to_dict(want)
        # `inspect` is written but not read back, in both packages
        assert got == cfg.replace(inspect=type(cfg.inspect)())


@pytest.mark.parametrize("layout", ["app_cfg", "refactor_cfg"])
def test_legacy_layouts_migrate_as_in_jax(layout, tmp_path):
    """The AppCfg and RefactorConfig files of chip_smoke.config_files, at two
    frame sizes, and each with its optional sections left out: the same
    PipelineCfg as unet_tpu.core.config.load_pipeline_yaml."""
    for H, W in ((448, 800), (96, 160)):
        path = cs.config_files(tmp_path, H, W)[layout]
        data = config.read_yaml(str(path))
        trimmed = dict(data)
        if layout == "app_cfg":
            trimmed["camera"] = {k: v for k, v in data["camera"].items() if k != "roi"}
            trimmed.pop("scale")
        else:
            trimmed.pop("postprocess")
            trimmed["roi"] = {"x": 10, "y": 5}
        for d in (data, trimmed):
            path.write_text(yaml.safe_dump(d))
            got, want = config.load_pipeline_yaml(str(path)), jconfig.load_pipeline_yaml(str(path))
            assert got.name == layout
            assert config.pipeline_cfg_to_dict(got) == jconfig.pipeline_cfg_to_dict(want)


def test_cli_infer_config_runs_every_layout(monkeypatch):
    """chip_smoke.phase_config_runs on the CPU at 64^2: production's YAML
    with a NestedUNet .pth (window mode from the preset's name), the AppCfg
    layout with --arch lightweight:mobilenet_v3_small, the RefactorConfig
    layout with a SimpleUNet .pth and its event section (the detector on);
    every events.csv row equal to the step's (engine_run). B1 is called as
    often as ENGINE_PER_BATCH says a batch: the card's counts there."""
    from unet_tpu_torch.ops import cc_kernels

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls, real = [], cc_kernels.propagate
    monkeypatch.setattr(cc_kernels, "propagate", lambda *a, **k: calls.append(1) or real(*a, **k))
    seen, real_run = {}, cs.engine_run

    def run(path, *a, **k):
        calls.clear()
        out = real_run(path, *a, **k)
        seen[path] = (len(calls), out[1]["batches"])
        return out
    monkeypatch.setattr(cs, "engine_run", run)
    counts, rec = cs.phase_config_runs(H=96, W=160, n_frames=12, model_size=64, device="cpu")
    assert set(rec) == {"config_production", "config_app_cfg", "config_refactor_cfg"}
    assert all(v == 0 for c in counts.values() for v in c.values())
    for path, (n, batches) in seen.items():
        # the engine's batches and engine_run's own step over the same frames
        assert n == 2 * batches * cs.ENGINE_PER_BATCH[path]["cc_propagate"], path
    assert rec["config_production"]["total_windows"] == 1
    assert {p: r["event_detector"] for p, r in rec.items()} == {
        "config_production": False, "config_app_cfg": False, "config_refactor_cfg": True}


def test_config_hints_follow_the_file(tmp_path):
    """engine_hints of the saved preset's name; a RefactorConfig file's event
    section becomes the detector's EventConfig, unknown keys dropped, as
    unet_tpu/cli/main.py:156-175 does."""
    from unet_tpu_torch.cli.main import config_hints
    from unet_tpu_torch.inspect import EventConfig
    from unet_tpu_torch.pipeline import engine_hints

    files = cs.config_files(tmp_path, 448, 800)
    for name in ("production", "app_cfg"):
        cfg = config.load_pipeline_yaml(str(files[name]))
        assert config_hints(str(files[name]), cfg) == engine_hints(cfg.name)
    assert config_hints(str(files["production"]),
                        config.load_pipeline_yaml(str(files["production"])))["window_enabled"]
    data = config.read_yaml(str(files["refactor_cfg"]))
    data["event"]["not_a_field"] = 1
    files["refactor_cfg"].write_text(yaml.safe_dump(data))
    hints = config_hints(str(files["refactor_cfg"]),
                         config.load_pipeline_yaml(str(files["refactor_cfg"])))
    assert hints == dict(event_detector_enabled=True, event_cfg=EventConfig(
        ratio_min=1.02, ratio_max=1.8, burr_frames=2, cooldown_frames=10))
    assert dataclasses.asdict(hints["event_cfg"])["thin_wrap_frames"] == 3


def test_stage_timer_and_device_trace(tmp_path):
    """StageTimer as the JAX package's; device_trace writes one trace file
    that names the ops run inside it (on the card, its kernels:
    chip_smoke.phase_trace)."""
    timer = StageTimer()
    for _ in range(3):
        with timer("decode"):
            pass
    with timer("step"):
        torch.ones(4).sum()
    assert timer.counts == {"decode": 3, "step": 1}
    assert set(timer.as_dict()) == {"decode", "step"}
    assert timer.report().splitlines()[0].split()[0] in ("decode", "step")
    with device_trace(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "aten::mm" in files[0].read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
