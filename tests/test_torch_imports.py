"""The port stands alone: no module of unet_tpu_torch, and not chip_smoke.py,
imports jax, flax or the JAX package, nor convert_orbax.py (which does);
importing builds nothing; and
chip_smoke.py fails, printing no result, without a card or without the
rest of the repository."""
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import unet_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _modules():
    """Every module of the package but `cli.__main__`, which runs the CLI."""
    return sorted(m.name for m in pkgutil.walk_packages(
        unet_tpu_torch.__path__, prefix="unet_tpu_torch.") if not m.name.endswith(".__main__"))


def test_every_module_imports_without_jax():
    mods = ["unet_tpu_torch"] + _modules() + ["chip_smoke"]
    for m in ("ops.cc_kernels", "ops.nlm_kernels", "ops.qconv_kernels", "ops.clahe",
              "ops.frames", "models.fast_forward", "models.quantized", "ops.geometry",
              "inspect.window", "inspect.decision", "inspect.uniformity",
              "serve.multistream", "io.video", "io.camera", "events.emitters",
              "inspect.detectors", "pipeline.visualize", "pipeline.engine", "serve.service",
              "serve.inspect_tool", "cli.main", "core.config", "core.profiling",
              "models.simple_unet", "models.resnet", "models.mobilenet", "models.shufflenet",
              "models.unetpp_lightweight", "models.losses", "ops.seg_metrics", "data.augment",
              "data.dataset", "data.loader", "train.monitor", "train.trainer",
              "core.checkpoint", "train.loop", "train.recipes", "tools.evaluate",
              "data.labelme", "tools.frames_extract", "tools.dataset_audit", "tools.calibrate",
              "tools.annotate", "tools.hard_negatives", "tools.visualize_dataset",
              "tools.interactive", "export", "export.aot", "parallel", "parallel.mesh",
              "parallel.multihost", "bench"):
        assert f"unet_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'unet_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'convert_orbax' not in sys.modules, 'the port imports convert_orbax'\n"
        "lazy = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'yaml', 'paho', 'harvesters'))\n"
        "assert not lazy, lazy\n"
        "from unet_tpu_torch import _build\n"
        "assert not _build._libs, 'importing built a kernel'\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

    # alone in a directory, without the package
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
