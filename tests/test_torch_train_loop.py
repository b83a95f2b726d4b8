"""The port's epoch loop, checkpoints and CLI (unet_tpu_torch.train.loop,
core.checkpoint, `cli train` / `cli evaluate`) on the CPU: a resumed run
equals an unbroken one bit for bit; `cli train` writes the JAX package's
files and `cli evaluate` on its checkpoint writes the metrics.json that
the JAX package's `cli evaluate` writes for the same weights; the
checkpoint loads in `cli infer`; what stays unported refuses; and
chip_smoke.phase_train and the C6 model rehearsed on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from unet_tpu_torch.cli.main import load_model, main
from unet_tpu_torch.data.dataset import AdvancedDataset, SegmentationDataset
from unet_tpu_torch.data.loader import Loader
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.train.loop import TrainRunCfg, train_model
from unet_tpu_torch.train.trainer import LossCfg, OptimCfg
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A labelled split of chip_smoke.train_scenes: 6 train, 3 val at 40x56."""
    return cs.write_split(tmp_path_factory.mktemp("split"), 6, 3, 40, 56, seed=7)


def _loaders(root, seed=0):
    r = Path(root)
    train = AdvancedDataset(str(r / "train/images"), str(r / "train/masks"),
                            target_size=(32, 32), rng=np.random.default_rng(seed))
    val = SegmentationDataset(str(r / "val/images"), str(r / "val/masks"), target_size=(32, 32))
    return (Loader(train, 2, shuffle=True, drop_last=True, seed=seed, with_indices=True),
            Loader(val, 2, prefetch=1))


def _run(root, out, epochs, resume=None):
    cfg = TrainRunCfg(epochs=epochs, num_classes=3, image_size=32, target_miou=None,
                      ckpt_dir=str(out), seed=5, track_worst_samples=3,
                      loss=LossCfg(kind="advanced", class_weights=(0.02, 1.0, 1.0)),
                      optim=OptimCfg(lr=1e-3, schedule="onecycle", total_steps=6,
                                     accum_steps=2))
    train, val = _loaders(root)
    model = NestedUNet(3, deep_supervision=True)
    return train_model(model, train, val, cfg, resume=resume, device="cpu")


def test_resume_equals_an_unbroken_run(root, tmp_path):
    """One epoch, then a resume for the second, against two epochs straight:
    the model (parameters and BN statistics), AdamW's state, the schedule's
    count and the accumulator bit for bit. Strong augmentation and shuffling
    draw from the host generators the checkpoint carries."""
    straight = _run(root, tmp_path / "a", 2)
    first = _run(root, tmp_path / "b", 1)
    assert first["epochs_run"] == 1
    resumed = _run(root, tmp_path / "b", 2, resume=str(tmp_path / "b"))
    assert resumed["epochs_run"] == 1 and straight["epochs_run"] == 2
    a, b = straight["state"].state_dict(), resumed["state"].state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for s, t in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        for k in s:
            assert torch.equal(s[k], t[k]), k
    assert a["scheduler"]["last_epoch"] == b["scheduler"]["last_epoch"] == 3
    assert a["step"] == b["step"] == 6
    assert a["accum"]["mini_step"] == b["accum"]["mini_step"] == 0
    meta = json.loads((tmp_path / "b" / "last.meta.json").read_text())
    assert meta["epoch"] == 1 and meta["config"]["arch"] == "nested_unet"
    for f in ("last.pth", "last.meta.json", "training_history.json"):
        assert (tmp_path / "b" / f).is_file()
    worst = json.loads((tmp_path / "b" / "worst_samples.json").read_text())
    assert worst["epoch"] == 1 and len(worst["worst"]) == 3
    assert worst == json.loads((tmp_path / "a" / "worst_samples.json").read_text())


def test_cli_train_and_evaluate_match_the_jax_evaluate(root, tmp_path, monkeypatch):
    """`cli train --recipe 3class_advanced --image-size 32` (bf16 by default)
    writes last.pth, its sidecar and the history; `cli evaluate` of that
    checkpoint writes the metrics.json and confusion_matrix.csv of the JAX
    package's `cli evaluate` on the same weights (float32, both); the
    checkpoint runs in `cli infer`."""
    from unet_tpu.cli.main import main as jmain

    out = tmp_path / "run"
    assert main(["train", "--recipe", "3class_advanced", "--data-root", root, "--output",
                 str(out), "--epochs", "1", "--batch", "2", "--image-size", "32",
                 "--device", "cpu"]) == 0
    files = {p.name for p in out.iterdir()}
    assert {"last.pth", "last.meta.json", "training_history.json"} <= files
    hist = json.loads((out / "training_history.json").read_text())["history"]
    assert len(hist["miou"]) == 1 and np.isfinite(hist["loss"][0])
    meta = json.loads((out / "last.meta.json").read_text())
    assert meta["config"] == dict(arch="nested_unet", num_classes=3, image_size=32,
                                  dtype="bfloat16")

    flags = ["--model", str(out / "last.pth"), "--data-root", root, "--split", "val",
             "--image-size", "32", "--batch", "2"]
    assert main(["evaluate", *flags, "--output", str(tmp_path / "ours"), "--device", "cpu"]) == 0
    assert jmain(["evaluate", *flags, "--output", str(tmp_path / "theirs")]) == 0
    for f in ("metrics.json", "confusion_matrix.csv"):
        assert (tmp_path / "ours" / f).read_text() == (tmp_path / "theirs" / f).read_text(), f
    # the loop's own eval of that epoch, in its dtype
    model, n, arch = load_model(str(out / "last.pth"), "nested_unet", "bfloat16", 3)
    assert (n, arch, model.deep_supervision) == (3, "nested_unet", True)
    assert main(["evaluate", *flags[:-2], "--batch", "3", "--dtype", "bfloat16",
                 "--output", str(tmp_path / "bf16"), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "bf16" / "metrics.json").read_text())["miou"]
    assert abs(got - hist["miou"][0]) <= 1e-3

    frames = cs.write_bmp_dir(tmp_path / "frames", cs.synthetic_frames(2, 48, 64))
    assert main(["infer", "--video", frames, "--output", str(tmp_path / "infer"), "--model",
                 str(out / "last.pth"), "--model-size", "32", "--no-video", "--device",
                 "cpu"]) == 0
    assert len((tmp_path / "infer" / "events.csv").read_text().splitlines()) == 3


def test_every_recipe_builds_and_refusals_name_their_items(root, tmp_path, monkeypatch):
    """All ten recipes run through `cli train` (the loop and overfit_test
    stubbed to record what they were given); a --n-devices other than the
    world size refuses, and the spatial train step names A15d."""
    from unet_tpu_torch.train import loop, recipes

    seen = {}

    def fake_train(model, train_loader, val_loader, cfg, resume=None, device="cuda"):
        seen[cfg.ckpt_dir] = (type(model).__name__, cfg, model.dtype, device)
        return {"best_miou": 0.0}

    monkeypatch.setattr(recipes, "train_model", fake_train)
    monkeypatch.setattr(loop, "overfit_test", lambda *a, **kw: 0.99)
    assert len(recipes.RECIPES) == 10
    for name in recipes.RECIPES:
        rc = main(["train", "--recipe", name, "--data-root", root, "--output",
                   str(tmp_path / name), "--epochs", "1", "--image-size", "32", "--batch", "2",
                   "--device", "cpu"])
        assert rc == 0, name
    assert len(seen) == 9
    arch, cfg, dtype, device = seen[str(tmp_path / "3class_advanced")]
    assert (arch, dtype, device, cfg.optim.accum_steps, cfg.loss.weight_tversky) == (
        "NestedUNet", torch.bfloat16, "cpu", 2, 0.45)
    assert seen[str(tmp_path / "inspection")][0] == "LightweightNestedUNet"
    # a --n-devices that is not the world size refuses; the spatial train
    # step names A15d
    with pytest.raises(SystemExit, match="world size is 1"):
        main(["train", "--data-root", root, "--n-devices", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="A15d"):
        loop.train_model(NestedUNet(3), None, None, TrainRunCfg(n_spatial=2), device="cpu")


def test_chip_smoke_train_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.phase_train end to end on the CPU at 32^2 (the card's
    synchronize stubbed; no kernel launches): the card-vs-CPU check against
    itself, the three timed steps, cli train / evaluate / infer on a split
    of 6 + 3 scenes."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rec = cs.phase_train(device="cpu", size=32, b=2, b_check=2, micro_steps=1, repeats=2,
                         split=(6, 3, 40, 56), image_size=32, cli_batch=2, overfit=False)
    assert rec["check"]["fp32_stats_max_abs_err"] == 0.0
    assert set(rec["check"]["bf16"]) == {"logits", "grads", "stats", "loss", "focal", "tversky",
                                         "dice", "grad_norm"}
    assert set(rec["times"]) == {"fp32", "bf16", "bf16_remat", "gflop_per_frame_forward"}
    assert rec["times"]["bf16"]["loss"] == rec["times"]["bf16_remat"]["loss"]
    assert len(rec["times"]["fp32"]["ms_windows"]) == 2 and rec["times"]["fp32"]["host_queue_ms"] > 0
    assert abs(rec["cli"]["evaluate"]["miou"] - rec["cli"]["logged_miou"]) <= 1e-3
    assert rec["cli"]["infer_launches_per_batch"]["cc_propagate"] == 0


def test_calibrated_model_holds_its_logits_near_order_one():
    """C6: the seeded resnet50 NestedUNet's logits reach 1e3; with BN
    statistics from one train-mode pass over the frames (momentum None) the
    eval-mode logits stay near order 1, and the statistics are the batch's
    mean and biased variance."""
    from unet_tpu_torch.pipeline import presets, stages

    cfg = presets.two_stage().replace_in("preprocess", model_size=(64, 64))
    frames = torch.from_numpy(cs.synthetic_frames(2, 96, 160, seed=20))
    seeded = cs.seeded_model("nested_unet_resnet50")
    model = cs.calibrated_model("nested_unet_resnet50", frames, cfg, "cpu")
    x = stages.model_input(stages.preprocess_frames(frames, cfg), cfg).permute(0, 3, 1, 2)
    with torch.no_grad():
        big, small = seeded(x.contiguous()), model(x.contiguous())
    assert float(big.abs().max()) > 100 > 20 > float(small.abs().max())
    stem = model.conv0_0[1]
    with torch.no_grad():
        h = model.conv0_0[0](x.contiguous())
    var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(stem.running_mean, mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(stem.running_var, var, rtol=1e-5, atol=1e-6)
    rec = cs._calibrated_check("nested_unet_resnet50", frames, cfg, 2, "cpu")
    assert rec["logits_max_abs_err"] == 0.0
